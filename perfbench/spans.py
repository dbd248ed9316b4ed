"""The benchmark's spans and its reduction of a ``torch.profiler`` trace.

Spans are the benchmark's own, around its calls into each layer of the
program (``span("solve_batch")`` ...): ``record_function`` ranges named
``perfbench.<name>`` when a run is traced, nothing otherwise. After the
window, :func:`summarize` reduces the trace to what the per-layer
metrics read: the window's length, the seconds in which a kernel, copy
or memset ran on the device (the union of their intervals), each
kernel's time and launches by name, and the device's idle gaps named by
what the host was doing: the innermost benchmark span and the innermost
operator of the program on the host thread at the gap's middle
(``python`` where no operator was running).
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections import defaultdict

PREFIX = "perfbench."
WINDOW = PREFIX + "window"
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_ACTIVITIES = ("cpu_op", "user_annotation", "cuda_runtime",
                   "cuda_driver")
NAME_CHARS = 96


class Spans:
    """``span(name)`` context managers that mark ranges in the trace when
    ``on``, and cost nothing when not."""

    def __init__(self, on: bool):
        self.on = on

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(PREFIX + name)


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: dict          # short name -> [seconds, launches]
    device_ops: list       # [[name, seconds], ...] the ten longest
    idle_gaps: list        # [[what the host did, seconds], ...]

    def kernel(self, fragment: str) -> tuple[float, int]:
        """Seconds and launches of the kernels whose name holds
        ``fragment``."""
        sec = cnt = 0
        for name, (s, c) in self.kernels.items():
            if fragment in name:
                sec += s
                cnt += c
        return sec, cnt


def short_name(name: str) -> str:
    """A kernel's name without its return type and its argument list,
    cut to ``NAME_CHARS`` characters."""
    if name.startswith("void "):
        name = name[5:]
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i] if i > 0 else name
                break
    return name.rstrip()[:NAME_CHARS]


def _activity(ev) -> str:
    """The event's kind, ``kernel``, ``gpu_memcpy``, ``gpu_memset`` or
    ``gpu_user_annotation`` on the device, ``user_annotation`` or a host
    operation's kind on the host: from ``activity_type`` where the
    profiler has it, else from the device and the name."""
    kind = getattr(ev, "activity_type", None)
    if kind is not None:
        return str(kind()).split(".")[-1].lower()
    name = ev.name()
    annotation = name.startswith(PREFIX)
    if "cuda" not in str(ev.device_type()).lower():
        return "user_annotation" if annotation else "cpu_op"
    if annotation:
        return "gpu_user_annotation"
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def _union(intervals: list) -> list:
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def summarize(prof) -> TraceSummary | None:
    """Reduce a finished ``torch.profiler.profile`` to a
    :class:`TraceSummary`, or None when it holds no window span."""
    events = prof.profiler.kineto_results.events()
    window = None
    host, device = [], []
    for ev in events:
        kind = _activity(ev)
        if kind in DEVICE_ACTIVITIES:
            device.append((ev.start_ns(), ev.start_ns() + ev.duration_ns(),
                           ev.name()))
        elif kind in HOST_ACTIVITIES:
            tid = getattr(ev, "start_thread_id", lambda: 0)()
            host.append((ev.start_ns(), ev.start_ns() + ev.duration_ns(),
                         ev.name(), tid))
            if ev.name() == WINDOW:
                window = host[-1]
    if window is None:
        return None
    w0, w1, _, tid = window
    kernels: dict = defaultdict(lambda: [0.0, 0])
    inside = []
    for s, e, name in device:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        inside.append((s, e))
        k = kernels[short_name(name)]
        k[0] += (e - s) * 1e-9
        k[1] += 1
    busy = _union(inside)
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < w1:
        gaps.append((t, w1))
    idle = _name_gaps(gaps, [h for h in host if h[3] == tid])
    device_ops = sorted(([n, v[0]] for n, v in kernels.items()),
                        key=lambda x: -x[1])[:10]
    return TraceSummary(
        window_s=(w1 - w0) * 1e-9,
        busy_s=sum(e - s for s, e in busy) * 1e-9,
        kernels=dict(kernels), device_ops=device_ops,
        idle_gaps=sorted(([n, v] for n, v in idle.items()),
                         key=lambda x: -x[1])[:10])


def _name_gaps(gaps: list, host: list) -> dict:
    """Idle seconds by what the host thread was doing at each gap's
    middle. Ranges on one thread nest, so a stack of the ranges open at
    the middle, walked once in time order, finds them."""
    host = sorted(host, key=lambda h: (h[0], -h[1]))
    out: dict = defaultdict(float)
    stack: list = []
    i = 0
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        while i < len(host) and host[i][0] <= mid:
            while stack and stack[-1][1] <= host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] <= mid:
            stack.pop()
        span = next((h[2] for h in reversed(stack)
                     if h[2].startswith(PREFIX) and h[2] != WINDOW),
                    WINDOW)
        op = next((h[2] for h in reversed(stack)
                   if not h[2].startswith(PREFIX)), "python")
        out[f"{span[len(PREFIX):]}/{op}"[:NAME_CHARS]] += (g1 - g0) * 1e-9
    return out
