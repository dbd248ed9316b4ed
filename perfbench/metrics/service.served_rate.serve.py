"""Requests completed within the window, per second of it: below the
offered rate when a backlog grows."""

from perfbench import reduce


def read(run):
    return reduce.served_rate(run)
