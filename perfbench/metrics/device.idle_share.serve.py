"""Percent of the traced window (arrivals and drain) in which the device
ran nothing."""

from perfbench import reduce


def read(run):
    return reduce.idle_share(run)
