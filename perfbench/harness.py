"""One run of one benchmark cell of ``repro_torch`` on one card.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) pairs a
configuration, ``configs/<config>.json`` (a graph deployment: its
generator in ``generators/<generator>.py``, its sizes and guarantees),
with a traffic mix, ``traffic/<traffic>.json`` (the queries and how they
arrive), which the one generator here reads. Each metric is read by
``metrics/<metric>.py`` from the :class:`Run` record, and each
algorithm's answers are judged by ``reference/<algorithm>.py``. A new
cell, mix, metric or reference is a new file, found by its name.

A run: set-up (the graph generated on the card from the configuration's
seed and built by the program's ``build_graph``, the warm-up of every
shape the mix uses), then the measured window (in a traced run, at most its
first ``TRACE_WINDOW_S`` seconds), then, with the program's state
freed, the comparison of a sample of the window's answers, drawn from
``--seed``, with the reference. Two kinds of traffic:

* ``closed``: back-to-back ``api.solve_batch`` calls of ``width`` queries
  each, until ``seconds`` have passed; the window ends with the last
  whole batch.
* ``open``: Poisson arrivals at ``rate_per_s`` into one
  ``QueryService``; each request is timed from when it was due to when
  the benchmark sees its result. Arrivals stop at the window's end and
  every admitted request is drained.

Nothing here imports the program or ``torch`` at import time.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np

from .spans import Spans, summarize

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
DRAIN_LIMIT_S = 120.0
# a traced run's window: a profile of a longer one takes minutes to read
TRACE_WINDOW_S = 10.0


def forbidden_modules(names) -> list:
    """The forbidden top-level packages among module ``names``, compared
    by whole top-level name (``repro_torch`` is not ``repro``)."""
    return sorted({str(n).split(".")[0] for n in names} & set(FORBIDDEN))


def load_json(kind: str, name: str) -> dict:
    with open(HERE / kind / f"{name}.json") as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``perfbench/<kind>/<name>.py``, loaded by its path."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    key = f"perfbench_{kind}_" + "".join(
        c if c.isalnum() else "_" for c in name)
    mod = sys.modules.get(key)
    if mod is None:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return mod


def load_benchmark(path: Path = ROOT / "BENCHMARK.json") -> dict:
    with open(path) as f:
        return json.load(f)


def cell_plan(bench: dict, workload: str) -> dict:
    """The cell's entry, its end-to-end and per-layer metrics (those
    whose ``workloads`` list it, or that list none)."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"unknown workload {workload!r}; known: "
                       f"{sorted(cells)}")
    cell = cells[workload]

    def mine(metrics):
        return [m for m in metrics
                if workload in m.get("workloads", [workload])]
    return {"cell": cell, "end_to_end": mine(bench["end_to_end"]),
            "per_layer": mine(bench["per_layer"])}


def rng(seed: int, stream: int) -> np.random.Generator:
    """Stream ``stream`` of the run's seed: sources 0, warm-up 1, the
    correctness sample 2, arrivals 3."""
    return np.random.default_rng([int(seed) % (1 << 64), stream])


@dataclasses.dataclass
class Run:
    """What a run measured; the metrics' readers take it."""
    workload: str
    config: dict
    traffic: dict
    seed: int
    seconds: float
    n: int = 0                # the graph's vertices and directed edges
    m: int = 0
    setup_s: float = 0.0
    window_s: float = 0.0
    attempted: int = 0
    completed: int = 0
    failed: int = 0
    batches: list = dataclasses.field(default_factory=list)
    latencies_ms: list = dataclasses.field(default_factory=list)
    submit_lag_ms: list = dataclasses.field(default_factory=list)
    completed_in_window: int = 0
    backlog_end: int = -1     # requests outstanding when arrivals stopped
    backend_stats: dict = dataclasses.field(default_factory=dict)
    service: dict = dataclasses.field(default_factory=dict)
    trace: Any = None


class Sample:
    """A reservoir of ``size`` answers, drawn from the seed's sample
    stream over the order in which the window produced them."""

    def __init__(self, size: int, gen: np.random.Generator):
        self.size, self.gen = size, gen
        self.seen = 0
        self.items: list = []           # (source, answer)

    def offer(self, sources, answer) -> None:
        """Offer the answers of ``sources``, in order; ``answer(j)`` gives
        the j-th's, fetched only where the reservoir keeps it."""
        slots = self.gen.integers(0, self.seen + np.arange(len(sources)) + 1)
        for j, (s, slot) in enumerate(zip(sources, slots)):
            if self.seen + j < self.size:
                self.items.append((int(s), answer(j)))
            elif slot < self.size:
                self.items[slot] = (int(s), answer(j))
        self.seen += len(sources)


class Sources:
    """Query vertices drawn from the run's source stream: uniform over
    the eligible vertices, or Zipf-skewed over a seeded ranking of them
    (``{"kind": "zipf", "s": ...}``); ``distinct`` within a batch."""

    def __init__(self, spec: dict, eligible: np.ndarray,
                 gen: np.random.Generator):
        self.kind = spec.get("kind", "uniform")
        self.distinct = bool(spec.get("distinct", False))
        self.eligible, self.gen = eligible, gen
        if self.kind == "zipf":
            ranks = np.arange(1, len(eligible) + 1, dtype=np.float64)
            p = ranks ** -float(spec["s"])
            self.cdf = np.cumsum(p / p.sum())
            self.eligible = gen.permutation(eligible)
        elif self.kind != "uniform":
            raise ValueError(f"unknown source kind {self.kind!r}")

    def draw(self, k: int) -> np.ndarray:
        if self.kind == "uniform":
            idx = self.gen.choice(len(self.eligible), size=k,
                                  replace=not self.distinct)
            return self.eligible[idx]
        out: list = []
        while len(out) < k:
            v = int(self.eligible[min(np.searchsorted(
                self.cdf, self.gen.random()), len(self.cdf) - 1)])
            if not (self.distinct and v in out):
                out.append(v)
        return np.asarray(out, dtype=np.int64)


def arrivals(rate: float, seconds: float, gen: np.random.Generator
             ) -> np.ndarray:
    """Due times of ``round(rate * seconds)`` requests in
    ``[0, seconds)``: exponential gaps at their quantiles, so every seed
    sends the same set of gaps, in an order drawn from the seed, scaled
    to fill the window."""
    count = max(1, int(round(rate * seconds)))
    q = (np.arange(count) + 0.5) / count
    gaps = gen.permutation(-np.log1p(-q))
    gaps *= seconds / gaps.sum()
    return np.concatenate([[0.0], np.cumsum(gaps)[:-1]])


# ---------------------------------------------------------------------
# set-up
@dataclasses.dataclass
class Context:
    device: Any
    g: Any
    edges: dict              # the generator's host arrays
    eligible: np.ndarray     # vertices of out-degree >= 1


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def setup(config: dict, traffic: dict, device) -> Context:
    from repro_torch.graphs import build_graph
    gen = load_module("generators", config["generator"])
    edges = gen.generate(**config["generator_args"], device=device)
    n = int(edges["n"])
    g = build_graph(edges["src"], edges["dst"], n=n, weights=edges["w"],
                    device=device)
    for key, got in (("n", g.n), ("m", g.m), ("d_ell", g.d_ell)):
        if key in config and int(config[key]) != int(got):
            raise RuntimeError(f"configuration {config['name']}: {key} is "
                               f"{got}, the file says {config[key]}")
    eligible = np.flatnonzero(np.bincount(edges["src"], minlength=n) > 0)
    return Context(device=device, g=g, edges=edges,
                   eligible=eligible.astype(np.int64))


def _params(traffic: dict) -> dict:
    return dict(traffic.get("params", {}))


def _solve_batch(ctx: Context, traffic: dict, sources, **extra):
    from repro_torch import api
    return api.solve_batch(ctx.g, traffic["algorithm"], sources=sources,
                           policy=traffic.get("policy"),
                           backend=traffic.get("backend", "cuda"),
                           **_params(traffic), **extra)


def _service(ctx: Context, traffic: dict, telemetry=None):
    """The open loop's ``QueryService``: its slots, chunk and how many
    finished results it keeps on the card, as the mix states them."""
    from repro_torch.service import QueryService
    return QueryService(ctx.g, slots=int(traffic["slots"]),
                        chunk_steps=int(traffic["chunk_steps"]),
                        max_records=int(traffic["max_records"]),
                        backend=traffic.get("backend", "cuda"),
                        telemetry=telemetry)


def _answer(traffic: dict, state: dict):
    return state[traffic["answer"]]


def warm_up(ctx: Context, traffic: dict, seed: int) -> None:
    """Run every shape the mix uses once before the window: a whole
    batch at the closed loop's width; for the open loop one engine step
    at every width a batch can start with (1 to ``slots``) and a short
    session of the service itself."""
    gen = rng(seed, 1)
    draw = Sources(traffic["sources"], ctx.eligible, gen)
    if traffic["mode"] == "closed":
        _solve_batch(ctx, traffic, draw.draw(traffic["width"]))
    else:
        slots = int(traffic["slots"])
        for w in range(1, slots + 1):
            _solve_batch(ctx, traffic, draw.draw(w), max_steps=1)
        svc = _service(ctx, traffic)
        for s in draw.draw(slots + slots // 2):
            svc.submit(traffic["algorithm"], int(s), **_params(traffic))
        svc.run_until_complete()
    _sync(ctx.device)


# ---------------------------------------------------------------------
# the window
def closed_loop(ctx: Context, traffic: dict, run: Run, spans: Spans,
                sample: Sample) -> None:
    width = int(traffic["width"])
    draw = Sources(traffic["sources"], ctx.eligible, rng(run.seed, 0))
    t0 = time.perf_counter()
    t1 = t0
    while t1 - t0 < run.seconds:
        srcs = draw.draw(width)
        with spans.span("solve_batch"):
            br = _solve_batch(ctx, traffic, srcs)
        with spans.span("sync"):
            _sync(ctx.device)
        t1 = time.perf_counter()
        run.batches.append({"width": width, "steps": int(br.steps)})
        run.completed += width
        with spans.span("sample"):
            sample.offer(srcs, lambda j: _answer(traffic, br.states[j]))
        del br
    run.window_s = t1 - t0
    run.attempted = run.completed


def open_loop(ctx: Context, traffic: dict, run: Run, spans: Spans,
              sample_idx: set, answers: dict, telemetry=None) -> None:
    svc = _service(ctx, traffic, telemetry)
    due = arrivals(float(traffic["rate_per_s"]), run.seconds,
                   rng(run.seed, 3))
    srcs = Sources(traffic["sources"], ctx.eligible,
                   rng(run.seed, 0)).draw(len(due))
    params, alg = _params(traffic), traffic["algorithm"]
    run.attempted = len(due)
    outstanding: dict = {}
    i = 0
    t0 = time.perf_counter()
    while i < len(due) or outstanding:
        now = time.perf_counter() - t0
        if i == len(due):
            if run.backlog_end < 0:
                run.backlog_end = len(outstanding)
            if now > run.seconds + DRAIN_LIMIT_S:
                break
        with spans.span("submit"):
            while i < len(due) and due[i] <= now:
                rid = svc.submit(alg, int(srcs[i]), **params)
                run.submit_lag_ms.append(
                    (time.perf_counter() - t0 - due[i]) * 1e3)
                outstanding[rid] = i
                i += 1
        if not svc.pending():
            if i < len(due):
                with spans.span("wait"):
                    time.sleep(max(0.0, min(due[i] - now, 0.01)))
            continue
        with spans.span("service_step"):
            svc.step()
        seen = time.perf_counter() - t0
        with spans.span("poll"):
            status = {r: svc.status(r)["status"] for r in outstanding}
            for rid in [r for r, st in status.items() if st != "pending"]:
                k = outstanding.pop(rid)
                if status[rid] != "done":    # failed, or its record gone
                    run.failed += 1
                    continue
                run.completed += 1
                run.latencies_ms.append((seen - due[k]) * 1e3)
                if seen <= run.seconds:
                    run.completed_in_window += 1
                if k in sample_idx:
                    answers[k] = (int(srcs[k]),
                                  _answer(traffic, svc.poll(rid)))
    run.failed += len(outstanding)
    run.window_s = time.perf_counter() - t0
    stats = svc.stats()
    run.service = {"stats": stats}
    if telemetry is not None:
        run.service["batch_widths"] = [
            e["width"] for e in telemetry.events
            if e.get("kind") == "event"
            and e.get("name") == "service.batch_start"]


def _backend_stats() -> dict:
    from repro_torch import api
    return dict(api.BACKEND_SHORTHANDS["cuda"].stats)


# ---------------------------------------------------------------------
# the comparison
def reference_edges(ctx_edges: dict, device) -> dict:
    import torch
    return {"src": torch.as_tensor(ctx_edges["src"], dtype=torch.int64,
                                   device=device),
            "dst": torch.as_tensor(ctx_edges["dst"], dtype=torch.int64,
                                   device=device),
            "n": int(ctx_edges["n"])}


def judge(traffic: dict, edges: dict, items: list, control: bool = False
          ) -> dict:
    """The compared numbers of ``items`` ((source, answer) pairs) against
    the reference; with ``control`` the reference's own control stands
    in for the program's answers."""
    ref = load_module("reference", traffic["algorithm"])
    sources = [s for s, _ in items]
    truth = ref.solve(edges, sources, _params(traffic))
    if control:
        low = ref.control(edges, sources, _params(traffic))
        answers = [low[:, j] for j in range(low.shape[1])]
    else:
        answers = [a for _, a in items]
    return ref.readings(answers, truth)


def verdict(readings: dict, limits: dict) -> tuple[bool, dict]:
    """Each compared number beside its limit; correct when every number
    is at or below its limit."""
    checks = {k: {"value": readings.get(k, math.inf), "limit": limits[k]}
              for k in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks


# ---------------------------------------------------------------------
def _metric_line(specs: list, run: Run) -> dict:
    out = {}
    for spec in specs:
        value = load_module("metrics", spec["name"]).read(run)
        if value is not None:
            out[spec["name"]] = {"value": float(value), "unit": spec["unit"]}
    return out


def measure(ctx: Context, traffic: dict, run: Run, trace: bool,
            t_start: float) -> list:
    """Warm-up and the window; returns the sampled (source, answer)
    pairs."""
    warm_up(ctx, traffic, run.seed)
    gc.collect()
    spans = Spans(trace)
    telemetry = None
    if trace and traffic["mode"] == "open":
        from repro_torch.obs import Telemetry
        telemetry = Telemetry()
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if ctx.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    stats0 = _backend_stats()
    run.setup_s = time.perf_counter() - t_start
    size = int(traffic.get("sample", 16))
    with spans.span("window"):
        if traffic["mode"] == "closed":
            sample = Sample(size, rng(run.seed, 2))
            closed_loop(ctx, traffic, run, spans, sample)
            items = sample.items
        else:
            count = max(1, int(round(float(traffic["rate_per_s"])
                                     * run.seconds)))
            pick = rng(run.seed, 2).choice(count, size=min(size, count),
                                           replace=False)
            answers: dict = {}
            open_loop(ctx, traffic, run, spans, set(int(k) for k in pick),
                      answers, telemetry)
            items = [answers[k] for k in sorted(answers)]
    if prof is not None:
        prof.__exit__(None, None, None)
        run.trace = summarize(prof)
        del prof
    stats1 = _backend_stats()
    run.backend_stats = {k: stats1[k] - stats0.get(k, 0) for k in stats1}
    return items


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device=None, bench: Optional[dict] = None,
             config: Optional[dict] = None, traffic: Optional[dict] = None,
             t_start: Optional[float] = None) -> tuple[dict, list]:
    """One run of ``workload``: the result object of the contract's last
    line, and the lines to print on standard error (each compared number
    beside its limit). ``config`` and ``traffic`` replace the cell's
    files (the tests' small sizes); ``device`` defaults to the card."""
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    plan = cell_plan(bench or load_benchmark(), workload)
    cell = plan["cell"]
    config = config or load_json("configs", cell["config"])
    traffic = traffic or load_json("traffic", cell["traffic"])
    dev = torch.device("cuda" if device is None else device)
    ctx = setup(config, traffic, dev)
    if trace:
        seconds = min(float(seconds), TRACE_WINDOW_S)
    run = Run(workload=workload, config=config, traffic=traffic,
              seed=int(seed), seconds=float(seconds), n=ctx.g.n, m=ctx.g.m)
    items = measure(ctx, traffic, run, trace, t_start)
    metrics = _metric_line(plan["per_layer" if trace else "end_to_end"], run)
    device_info: dict = {"platform": "gpu" if dev.type == "cuda"
                         else dev.type,
                         "kind": (torch.cuda.get_device_name(dev)
                                  if dev.type == "cuda" else dev.type),
                         "count": 1,
                         "memory_peak_bytes": (
                             int(torch.cuda.max_memory_allocated(dev))
                             if dev.type == "cuda" else 0)}
    if trace and run.trace is not None:
        device_info["busy_s"] = run.trace.busy_s
        device_info["window_s"] = run.trace.window_s
    # the program's state goes before the reference runs
    edges = ctx.edges
    del ctx
    from repro_torch import api
    api.clear_engine_cache()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    readings = judge(traffic, reference_edges(edges, dev), items) if items \
        else {}
    ok, checks = verdict(readings, traffic["limits"])
    ok = ok and run.failed == 0 and run.completed > 0
    result = {"correct": ok, "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics,
              "device": device_info}
    if trace and run.trace is not None:
        result["breakdown"] = {"device_ops": run.trace.device_ops,
                               "idle_gaps": run.trace.idle_gaps}
    result["checks"] = checks
    lines = [f"check {k}: {c['value']!r} (limit {c['limit']!r})"
             for k, c in checks.items()]
    lines.append(f"answers compared: {len(items)}, failed requests: "
                 f"{run.failed}, correct: {ok}")
    return result, lines
