"""How late the benchmark submitted requests (95th percentile), while a
chunk held the host."""

from perfbench import reduce


def read(run):
    return reduce.submit_lag_p95_ms(run)
