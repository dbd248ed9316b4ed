"""PPR queries completed over the whole window, per second."""

from perfbench import reduce


def read(run):
    return reduce.queries_per_s(run)
