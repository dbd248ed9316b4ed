"""Engine steps a batch of PPR queries takes (``BatchResult.steps``): its
slowest column's iterations."""

from perfbench import reduce


def read(run):
    return reduce.mean_steps(run)
