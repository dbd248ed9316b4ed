"""Share of the window's in-edge slot reads made in hub pieces of the
full-scan pull, in %."""

from perfbench import rowlayout


def read(run):
    return rowlayout.hub_slot_share(run)
