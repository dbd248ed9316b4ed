"""The arithmetic the metrics' readers share: each takes a
:class:`perfbench.harness.Run` and returns a number, or None where the
run holds nothing to read (no trace, no step, no request)."""

from __future__ import annotations

import math

from . import yardstick


def percentile(values: list, q: float) -> float:
    """Nearest-rank percentile ``q`` (0-100) of ``values``."""
    vals = sorted(values)
    return vals[max(0, math.ceil(q / 100.0 * len(vals)) - 1)]


def steps(run) -> int:
    return sum(b["steps"] for b in run.batches)


def queries_per_s(run):
    """Completed queries per second of the window."""
    if run.window_s <= 0:
        return None
    return run.completed / run.window_s


def latency_p95_ms(run):
    """95th percentile of every request's latency; a failed request
    counts as missing every limit."""
    if not run.latencies_ms:
        return None
    value = percentile(run.latencies_ms + [math.inf] * run.failed, 95)
    return value if math.isfinite(value) else None


def mean_steps(run):
    return steps(run) / len(run.batches) if run.batches else None


def host_ms_per_step(run):
    """Milliseconds a step in which the device ran nothing: the traced
    window less its busy time, over the engine steps."""
    if run.trace is None or not run.trace.busy_s or not steps(run):
        return None
    return (run.trace.window_s - run.trace.busy_s) / steps(run) * 1e3


def idle_share(run):
    if run.trace is None or not run.trace.busy_s:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def ell_spmv_roofline(run):
    """Share of the HBM roofline the ``ell_spmv`` launches reach: their
    minimal bytes (:func:`yardstick.ell_spmv_min_bytes` at the batch
    width, a copy message) over their kernel time in the trace."""
    if run.trace is None:
        return None
    seconds, launches = run.trace.kernel("ell_spmv_kernel")
    if not launches or seconds <= 0:
        return None
    nbytes = yardstick.ell_spmv_min_bytes(run.n, run.m,
                                          int(run.traffic["width"]))
    return yardstick.bytes_share(launches * nbytes, seconds)


def batch_width(run):
    widths = run.service.get("batch_widths")
    return sum(widths) / len(widths) if widths else None


def refills_per_chunk(run):
    """Queries admitted into a running batch's freed slots, per chunk."""
    stats = run.service.get("stats")
    widths = run.service.get("batch_widths")
    if not stats or widths is None or not stats["chunks_run"]:
        return None
    batched = (stats["submitted"] - stats["cache"]["hits"]
               - stats["coalesced"])
    return (batched - sum(widths)) / stats["chunks_run"]


def served_rate(run):
    if run.seconds <= 0 or not run.attempted:
        return None
    return run.completed_in_window / run.seconds


def submit_lag_p95_ms(run):
    return (percentile(run.submit_lag_ms, 95) if run.submit_lag_ms
            else None)
