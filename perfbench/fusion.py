"""The reader of the backend's fused-step counter, shared by the
``backend.fused_pull_share.*`` metrics. It takes a
:class:`perfbench.harness.Run`, as ``reduce.py``'s readers do, and
returns None where the run holds nothing to read."""

from __future__ import annotations


def fused_pull_share(run):
    """Percent of the window's full-scan kernel pulls that ran with their
    program's update in the same launch (``CudaBackend.stats``:
    ``fused_pull_update`` over ``kernel_pull``); None for a program
    without the counter or a window with no kernel pull."""
    fused = run.backend_stats.get("fused_pull_update")
    pulls = run.backend_stats.get("kernel_pull")
    if fused is None or not pulls:
        return None
    return 100.0 * fused / pulls
