"""Share of the HBM roofline the full-scan pull reaches at the
Kronecker cell's full batch width (256 columns, through the CSR row
offsets), by its minimal bytes over its traced time."""

from perfbench import rowlayout


def read(run):
    return rowlayout.wide_pull_roofline(run)
