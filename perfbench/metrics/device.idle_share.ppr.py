"""Percent of the traced window in which the device ran nothing."""

from perfbench import reduce


def read(run):
    return reduce.idle_share(run)
