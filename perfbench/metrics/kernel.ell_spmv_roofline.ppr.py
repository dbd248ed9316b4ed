"""Share of the HBM roofline the full-scan pull kernel reaches, by its
minimal bytes over its traced time."""

from perfbench import reduce


def read(run):
    return reduce.ell_spmv_roofline(run)
