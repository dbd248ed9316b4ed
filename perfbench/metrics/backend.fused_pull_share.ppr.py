"""Share of the window's full-scan kernel pulls that ran with batched
PPR's update in the same launch, in %."""

from perfbench import fusion


def read(run):
    return fusion.fused_pull_share(run)
