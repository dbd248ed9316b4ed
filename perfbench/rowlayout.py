"""The readers of the Kronecker cell's per-layer metrics: the backend's
row-layout counters (``backend.row_layout_share.*``,
``backend.hub_slot_share.*``) and the roofline share of the pull that
runs at the batch's full width (``kernel.ell_spmv_roofline.kron``).
They take a :class:`perfbench.harness.Run`, as ``reduce.py``'s readers
do, and return None where the run holds nothing to read."""

from __future__ import annotations

from . import yardstick

# the trace's names of the full-scan pull whose update runs apart: the
# kernel with the epilogue that stores the pulled rows (a fused step's
# epilogue is ``PprStep``)
WIDE_PULL = ("ell_spmv_kernel", "StoreRows")


def row_layout_share(run):
    """Percent of the window's kernel pulls (full scan and frontier)
    that read the graph's rows through its CSR row offsets
    (``CudaBackend.stats``: ``row_layout_pulls`` over ``kernel_pull`` +
    ``kernel_pull_frontier``); None for a program without the counter or
    a window with no kernel pull."""
    stats = run.backend_stats
    rows = stats.get("row_layout_pulls")
    pulls = stats.get("kernel_pull", 0) + stats.get("kernel_pull_frontier", 0)
    if rows is None or not pulls:
        return None
    return 100.0 * rows / pulls


def hub_slot_share(run):
    """Percent of the in-edge slots the window's kernel pulls read that
    the full-scan pulls read in hub pieces (``hub_slots`` over
    ``pull_edges``); None for a program without the counter or a window
    with no slot read."""
    stats = run.backend_stats
    hub = stats.get("hub_slots")
    edges = stats.get("pull_edges")
    if hub is None or not edges:
        return None
    return 100.0 * hub / edges


def wide_pull_roofline(run):
    """Share of the HBM roofline the full-scan pull reaches where it
    runs at the batch's full width: the minimal bytes of a pull at the
    traffic's width (:func:`yardstick.ell_spmv_min_bytes`, a copy
    message) for each launch of the pull that stores its rows, over
    those launches' time in the trace. A batch wider than the fused step
    pulls so until at most 64 of its columns are active; the fused
    steps that follow run at their active columns' width, which the
    trace does not give, and are left out. None without a trace or
    such a launch."""
    if run.trace is None:
        return None
    seconds = launches = 0
    for name, (sec, count) in run.trace.kernels.items():
        if all(part in name for part in WIDE_PULL):
            seconds += sec
            launches += count
    if not launches or seconds <= 0:
        return None
    nbytes = yardstick.ell_spmv_min_bytes(run.n, run.m,
                                          int(run.traffic["width"]))
    return yardstick.bytes_share(launches * nbytes, seconds)
