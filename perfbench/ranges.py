"""What the program records of itself: its counters in a run's record,
and its ``repro.*`` ranges in a traced run's profile.

    python3 perfbench/ranges.py --workload <cell> --seed <n> \\
        [--seconds 10] [--out FILE]

The counter readers (:func:`pull_edges_per_query`, :func:`wait_ms`) take
a :class:`perfbench.harness.Run`, as ``reduce.py``'s do, and return None
where the run holds nothing to read (a program without the counter, no
query completed).

The program opens a range named ``repro.<layer>.*`` at each of its
layer boundaries while a profiler records
(``repro_torch.obs.trace.region``), a host operation in the trace.
:func:`program_ranges` reduces a finished profile by them: each range's
count and seconds in the window, and the device's idle seconds by the
innermost benchmark span and the innermost ``repro.*`` range open on
the window's thread at each gap's middle (``""`` where none is open). The idle seconds add up to the
window less the device's busy time, as ``spans.summarize`` computes
both. :func:`layer_idle` reads what those give each layer.

As a command, one traced run of the cell, as ``run.py --trace 1`` makes
it, with the same profile also reduced by the program's ranges: the run's
last line, then one JSON line (``program_ranges`` and ``layers``). The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import spans  # noqa: E402

RANGE = "repro."


# ---------------------------------------------------------------------
# counters
def pull_edges_per_query(run):
    """In-edge slots the backend's kernel pulls read in the window
    (``CudaBackend.stats["pull_edges"]``), per query completed."""
    edges = run.backend_stats.get("pull_edges")
    if edges is None or not run.completed:
        return None
    return edges / run.completed


def wait_ms(run, key: str):
    """``key`` of the service's ``stats()["waits"]`` (``queue_p95_ms``:
    submit to slot; ``in_slot_p95_ms``: slot to result), or None."""
    waits = run.service.get("stats", {}).get("waits", {})
    return waits.get(key)


# ---------------------------------------------------------------------
# ranges
def program_ranges(prof) -> dict | None:
    """The program's ranges in a finished ``torch.profiler.profile``, or
    None when it holds no window span:

    * ``window_s``, ``busy_s``: as ``spans.summarize`` reads them;
    * ``spans``: ``{range: [count, seconds]}`` of the ``repro.*`` host
      ranges that start in the window, their seconds cut at its end;
    * ``idle``: ``{benchmark span: {range: seconds}}``, the device's
      idle gaps by the innermost ``perfbench.*`` span (``window`` where
      none) and the innermost ``repro.*`` range (``""`` where none) open
      on the window's thread at each gap's middle.
    """
    window = None
    host, device = [], []
    for ev in prof.profiler.kineto_results.events():
        kind = spans._activity(ev)
        start, end = ev.start_ns(), ev.start_ns() + ev.duration_ns()
        if kind in spans.DEVICE_ACTIVITIES:
            device.append((start, end))
        elif kind in spans.HOST_ACTIVITIES:
            tid = getattr(ev, "start_thread_id", lambda: 0)()
            host.append((start, end, ev.name(), tid))
            if ev.name() == spans.WINDOW:
                window = host[-1]
    if window is None:
        return None
    w0, w1, _, tid = window
    busy = spans._union([(max(s, w0), min(e, w1)) for s, e in device
                         if min(e, w1) > max(s, w0)])
    gaps, t = [], w0
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if t < w1:
        gaps.append((t, w1))
    mine = [h for h in host if h[3] == tid]
    counts: dict = defaultdict(lambda: [0, 0.0])
    for s, e, name, _ in mine:
        if name.startswith(RANGE) and w0 <= s < w1:
            counts[name][0] += 1
            counts[name][1] += (min(e, w1) - s) * 1e-9
    return {"window_s": (w1 - w0) * 1e-9,
            "busy_s": sum(e - s for s, e in busy) * 1e-9,
            "spans": dict(counts), "idle": _idle_by_range(gaps, mine)}


def _idle_by_range(gaps: list, host: list) -> dict:
    """Idle seconds by the innermost benchmark span and program range
    open at each gap's middle; ranges on one thread nest, so one stack,
    walked once in time order, finds both."""
    host = sorted(host, key=lambda h: (h[0], -h[1]))
    out: dict = defaultdict(lambda: defaultdict(float))
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
                     if h[2].startswith(spans.PREFIX)
                     and h[2] != spans.WINDOW), spans.WINDOW)
        rng = next((h[2] for h in reversed(stack)
                    if h[2].startswith(RANGE)), "")
        out[span[len(spans.PREFIX):]][rng] += (g1 - g0) * 1e-9
    return {k: dict(v) for k, v in out.items()}


def layer_idle(ranges: dict) -> dict:
    """What the program's ranges give each layer: the idle milliseconds
    an engine step leaves under an innermost ``repro.engine.*`` or
    ``repro.backend.*`` range, per ``repro.engine.step``; the batch
    layer's under an innermost ``repro.batch.*`` range, per
    ``repro.batch.solve_batch`` or ``repro.batch.run_chunk``; the
    percent of the window the device idles under an innermost
    ``repro.service.*`` or ``repro.batch.*`` range; and, for each
    benchmark span, the share of its idle seconds under no ``repro.*``
    range."""
    by_range: dict = defaultdict(float)
    for per_span in ranges["idle"].values():
        for rng, sec in per_span.items():
            by_range[rng] += sec

    def idle(*layers) -> float:
        return sum(sec for rng, sec in by_range.items()
                   if rng.startswith(tuple(RANGE + x for x in layers)))

    def count(*names) -> int:
        return sum(ranges["spans"].get(RANGE + n, [0])[0] for n in names)
    steps = count("engine.step")
    batches = count("batch.solve_batch", "batch.run_chunk")
    return {
        "engine_step_idle_ms": (idle("engine.", "backend.") / steps * 1e3
                                if steps else None),
        "batch_idle_ms": (idle("batch.") / batches * 1e3
                          if batches else None),
        "service_idle_share": (100.0 * idle("service.", "batch.")
                               / ranges["window_s"]),
        "idle_by_range": dict(by_range),
        "outside_share": {span: (per.get("", 0.0) / sum(per.values())
                                 if sum(per.values()) else None)
                          for span, per in ranges["idle"].items()}}


# ---------------------------------------------------------------------
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from perfbench import harness
    from perfbench import run as cli
    found: dict = {}
    summarize = harness.summarize

    def both(prof):
        found["ranges"] = program_ranges(prof)
        return summarize(prof)
    harness.summarize = both
    try:
        rc = cli.main(["--workload", args.workload, "--seed",
                       str(args.seed), "--seconds", str(args.seconds),
                       "--trace", "1"])
    finally:
        harness.summarize = summarize
    ranges = found.get("ranges")
    line = {"workload": args.workload, "seed": args.seed,
            "program_ranges": ranges,
            "layers": layer_idle(ranges) if ranges else None}
    text = json.dumps(line)
    print(text, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(text + "\n")
    return rc


if __name__ == "__main__":
    sys.exit(main())
