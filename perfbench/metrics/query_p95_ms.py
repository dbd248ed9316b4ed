"""95th percentile of the latency of every request due in the window, from
when it was due to when its result was seen."""

from perfbench import reduce


def read(run):
    return reduce.latency_p95_ms(run)
