"""Milliseconds an engine step leaves the device idle: traced window less
device busy time, over the steps."""

from perfbench import reduce


def read(run):
    return reduce.host_ms_per_step(run)
