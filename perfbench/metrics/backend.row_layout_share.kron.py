"""Share of the window's kernel pulls that read the graph's rows through
its CSR row offsets, in %."""

from perfbench import rowlayout


def read(run):
    return rowlayout.row_layout_share(run)
