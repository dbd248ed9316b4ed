"""The port's telemetry (``repro_torch.obs``) and stepwise engine against
the JAX package's ``repro.obs`` and ``PushPullEngine.run_stepwise``.

  * ``run_stepwise`` equals ``run`` (state bit for bit, Cost, steps,
    push steps, converged, every StepTrace row) for BFS, PageRank and
    PPR under every policy, through the dense backend and the CUDA
    backend's plain versions; the initial state is left unchanged;
    phase programs are rejected;
  * ``telemetry=None`` adds no events; step counter totals equal Cost;
    trace overflow, the event ring, spans, the JSONL round trip, a
    Chrome trace that loads; the port's ``OBS_EVENT_SCHEMA`` equals the
    reference's and ``benchmarks/obs_schema.json``;
  * on the same graph, the port's ``step`` and ``run`` events equal the
    reference's in every field but the times and the backend's name,
    ``decision_audit`` and ``render_report`` give the reference's result
    on the same events, and ``solve_batch`` and ``QueryService``
    telemetry match the reference's;
  * the port's own: its ``repro.*`` profiler ranges (none entered with
    no profiler recording, each layer's count under one), the backend's
    ``pull_edges`` counter, and the ring's wall-clock anchor
    ``epoch_ns``.
"""

import collections
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro.core import PallasBackend
from repro.graphs import kronecker as ref_kronecker
from repro.obs import Telemetry as RefTelemetry
from repro.obs import export as ref_export
from repro.obs import report as ref_report
from repro.service import QueryService as RefQueryService
from repro_torch import api
from repro_torch.core import CudaBackend
from repro_torch.core.engine import PushPullEngine
from repro_torch.graphs import GRAPH_ARRAYS, graph_from_arrays
from repro_torch.obs import Telemetry
from repro_torch.obs.export import (OBS_EVENT_SCHEMA, _final_events,
                                    load_jsonl, validate_events,
                                    validate_trace_file, write_chrome_trace,
                                    write_jsonl)
from repro_torch.kernels import tune
from repro_torch.obs.metrics import collect_tuner
from repro_torch.obs.report import decision_audit, main, render_report
from repro_torch.service import QueryService

ROOT = Path(__file__).resolve().parents[1]
ALGS = {"bfs": {"root": 0}, "pagerank": {"iters": 8},
        "ppr": {"source": 3}}
POLICIES = ("push", "pull", "gs", "grs", "auto")
# fields that carry host times, and the backend's own name
TIMES = {"ts_us", "us", "dur_us"}


def port_of(g):
    return graph_from_arrays({f: np.asarray(getattr(g, f))
                              for f in GRAPH_ARRAYS},
                             n=g.n, m=g.m, d_ell=g.d_ell, device="cpu")


@pytest.fixture(scope="module")
def pair():
    g = ref_kronecker(8, edge_factor=8, seed=3)
    return g, port_of(g)


def pinned(kind: str):
    """A CUDA (or Pallas) backend pinned so that no tuner probes."""
    pins = dict(autotune=False, block_n=64, block_e=128, push_block_n=64,
                push_strategy="scan")
    return PallasBackend(**pins) if kind == "pallas" else CudaBackend(**pins)


def engine_for(g, alg: str, policy, backend, trace: int = 64):
    spec = api.get_spec(alg)
    policy = api._resolve_policy(policy)
    backend = api._resolve_backend(backend)
    program, steps = spec.build(g, policy=policy, backend=backend)
    return spec, PushPullEngine(program=program, policy=policy,
                                max_steps=steps, backend=backend,
                                trace_capacity=trace)


def leaves(state) -> list:
    return ([state[k] for k in sorted(state)] if isinstance(state, dict)
            else [state])


def same_result(a, b) -> None:
    """Bit-identical engine results."""
    for x, y in zip(leaves(a.state), leaves(b.state), strict=True):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert a.cost.as_dict() == b.cost.as_dict()
    assert (a.steps, a.push_steps, a.converged, a.epochs) == (
        b.steps, b.push_steps, b.converged, b.epochs)
    assert a.trace.as_dict(a.steps) == b.trace.as_dict(b.steps)


# ---------------------------------------------------------------------
# the stepwise engine


@pytest.mark.parametrize("backend", ("dense", "cuda"))
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("alg", sorted(ALGS))
def test_run_stepwise_equals_run(pair, alg, policy, backend):
    _, tg = pair
    be = pinned("cuda") if backend == "cuda" else backend
    spec, eng = engine_for(tg, alg, policy, be)
    state0, frontier0 = spec.init(tg, **ALGS[alg])
    kept = [x.clone() for x in leaves(state0)] + [frontier0.clone()]
    whole = eng.run(tg, state0, frontier0)
    times: dict[int, float] = {}
    stepped = eng.run_stepwise(tg, state0, frontier0,
                               on_step=times.__setitem__)
    same_result(whole, stepped)
    assert sorted(times) == list(range(whole.steps))
    assert all(us > 0 for us in times.values())
    # neither path writes into the initial state
    for x, y in zip(leaves(state0) + [frontier0], kept, strict=True):
        assert torch.equal(x, y)


def test_stepwise_rejects_phase_programs(pair):
    _, tg = pair
    spec, eng = engine_for(tg, "sssp_delta", "auto", "dense", trace=0)
    assert not eng.supports_stepwise
    state0, frontier0 = spec.init(tg, source=0)
    with pytest.raises(ValueError, match="phase"):
        eng.run_stepwise(tg, state0, frontier0)


def test_phase_program_solve_with_telemetry_still_audits(pair):
    # a phase program runs under run(): step rows without wall times,
    # audited on the predicted basis
    _, tg = pair
    tel = Telemetry()
    plain = api.solve(tg, "sssp_delta", source=0, policy="auto")
    observed = api.solve(tg, "sssp_delta", source=0, policy="auto",
                         telemetry=tel)
    assert torch.equal(plain.state["dist"], observed.state["dist"])
    steps = [e for e in tel.events if e["kind"] == "step"]
    assert steps and all("us" not in e for e in steps)
    audits = [e for e in tel.events if e["kind"] == "audit"]
    assert audits and audits[0]["basis"] == "predicted"


# ---------------------------------------------------------------------
# the handle and its counters


def test_telemetry_none_bit_identical_and_zero_events(pair):
    _, tg = pair
    tel = Telemetry()
    plain = api.solve(tg, "bfs", root=0, policy="auto")
    assert tel.events == [] and len(tel.counters) == 0
    observed = api.solve(tg, "bfs", root=0, policy="auto", telemetry=tel)
    assert torch.equal(plain.state["dist"], observed.state["dist"])
    assert plain.cost.as_dict() == observed.cost.as_dict()
    assert (plain.steps, plain.push_steps) == (observed.steps,
                                               observed.push_steps)
    n_events = len(tel.events)
    assert n_events > 0
    api.solve(tg, "bfs", root=0, policy="auto")
    assert len(tel.events) == n_events


@pytest.mark.parametrize("case", ("ragged", "empty_rows", "self_loops",
                                  "duplicate_edges", "edgeless"))
def test_step_counter_totals_match_cost(case):
    from graph_strategies import build_case
    tg = port_of(build_case(case, 1))
    tel = Telemetry()
    r = api.solve(tg, "bfs", root=0, policy="auto", telemetry=tel)
    run_ev = [e for e in tel.events if e["kind"] == "run"][-1]
    steps = [e for e in tel.events if e["kind"] == "step"
             and e["run"] == run_ev["run"]]
    assert len(steps) == r.steps
    for key in ("reads", "writes", "atomics", "locks"):
        assert sum(e[key] for e in steps) == int(getattr(r.cost, key)) \
            == run_ev["counters"][key], key
    assert tel.counters.get("engine.cost.reads") == int(r.cost.reads)
    assert tel.counters.get("engine.steps") == r.steps


def test_counters_accumulate_without_double_count(pair):
    _, tg = pair
    tel = Telemetry()
    r1 = api.solve(tg, "bfs", root=0, telemetry=tel)
    r2 = api.solve(tg, "bfs", root=1, telemetry=tel)
    assert tel.counters.get("engine.runs") == 2
    assert tel.counters.get("engine.cost.reads") == \
        int(r1.cost.reads) + int(r2.cost.reads)


def test_trace_overflow_surfaced(pair):
    _, tg = pair
    tel = Telemetry()
    r = api.solve(tg, "bfs", root=0, policy="auto", trace=2, telemetry=tel)
    assert r.steps > 2
    dropped = r.steps - 2
    assert int(r.trace.overflow) == dropped
    run_ev = [e for e in tel.events if e["kind"] == "run"][-1]
    assert run_ev["trace_overflow"] == dropped
    assert "Trace overflow" in render_report(_final_events(tel))
    r = api.solve(tg, "bfs", root=0, policy="auto", trace=64)
    assert int(r.trace.overflow) == 0


def test_event_ring_bounded_and_counts_drops():
    tel = Telemetry(capacity=4)
    for _ in range(10):
        tel.emit("event", "x")
    assert len(tel.events) == 4 and tel.dropped == 6
    with pytest.raises(ValueError, match="capacity"):
        Telemetry(capacity=0)


def test_span_records_duration_and_fields():
    tel = Telemetry()
    with tel.span("work", device="cpu", phase="test") as sp:
        sp["extra"] = 1
    (ev,) = tel.events
    assert ev["kind"] == "span" and ev["name"] == "work"
    assert ev["dur_us"] >= 0 and ev["phase"] == "test" and ev["extra"] == 1
    assert tel.new_run() == 0 and tel.last_run == 0
    tel.emit("event", "y", run=0)
    assert [e["name"] for e in tel.events_for(0)] == ["y"]


# ---------------------------------------------------------------------
# exporters and the schema


def test_jsonl_round_trip_validates(pair, tmp_path):
    _, tg = pair
    tel = Telemetry()
    api.solve(tg, "bfs", root=0, policy="auto", telemetry=tel)
    path = tmp_path / "trace.jsonl"
    n = write_jsonl(tel, path)
    assert validate_trace_file(path) == n
    events = load_jsonl(path)
    assert events[0]["kind"] == "meta"
    assert {"run", "step", "audit", "span", "counter"} <= {
        e["kind"] for e in events}
    # the reference's validator accepts the port's trace
    assert ref_export.validate_trace_file(path) == n


def test_chrome_trace_loads(pair, tmp_path):
    _, tg = pair
    tel = Telemetry()
    api.solve(tg, "bfs", root=0, policy="auto", telemetry=tel)
    path = tmp_path / "trace.json"
    write_chrome_trace(tel, path)
    evs = json.loads(path.read_text())["traceEvents"]
    assert evs and all("ph" in e and "pid" in e for e in evs)
    xs = [e for e in evs if e["ph"] == "X" and e.get("cat") == "step"]
    assert xs and all(e["dur"] > 0 and e["ts"] >= 0 for e in xs)


def test_validate_events_rejects_bad_events(tmp_path):
    ok = [{"ts_us": 0.0, "kind": "counter", "name": "x", "value": 1}]
    assert validate_events(ok) == []
    assert validate_events([{"ts_us": -1.0, "kind": "counter",
                             "name": "x", "value": 1}])
    assert validate_events([{"ts_us": 0.0, "kind": "nonsense"}])
    assert validate_events([{"ts_us": 0.0, "kind": "run"}])
    assert validate_events([{"kind": "counter", "name": "x", "value": 1}])
    bad = tmp_path / "bad.jsonl"
    bad.write_text(json.dumps({"ts_us": 0.0, "kind": "run"}) + "\n")
    with pytest.raises(ValueError, match="schema violation"):
        validate_trace_file(bad)


def test_schema_equals_reference_and_committed_file():
    committed = json.loads((ROOT / "benchmarks" / "obs_schema.json")
                           .read_text())
    assert OBS_EVENT_SCHEMA == ref_export.OBS_EVENT_SCHEMA == committed


# ---------------------------------------------------------------------
# the audit and the report


WALL_STEPS = [
    {"kind": "step", "run": 0, "step": 0, "pushed": True,
     "predicted_push": 10.0, "predicted_pull": 100.0, "us": 50.0},
    {"kind": "step", "run": 0, "step": 1, "pushed": False,
     "predicted_push": 100.0, "predicted_pull": 10.0, "us": 50.0},
    # chose push at 400 us; pull predicted 10 -> ~50 us at the pull
    # rate: mispredicted
    {"kind": "step", "run": 0, "step": 2, "pushed": True,
     "predicted_push": 11.0, "predicted_pull": 10.0, "us": 400.0},
]
PREDICTED_STEPS = [
    {"kind": "step", "run": 0, "step": 0, "pushed": True,
     "predicted_push": 5.0, "predicted_pull": 50.0},
    {"kind": "step", "run": 0, "step": 1, "pushed": True,
     "predicted_push": 50.0, "predicted_pull": 5.0},
]


def test_decision_audit_bases():
    audit = decision_audit(WALL_STEPS)
    assert audit["basis"] == "wall" and audit["audited_steps"] == 3
    assert [r["mispredict"] for r in audit["steps"]] == [False, False, True]
    assert audit["mispredict_rate"] == pytest.approx(1 / 3)
    audit = decision_audit(PREDICTED_STEPS)
    assert audit["basis"] == "predicted" and audit["flagged"] == 1
    assert decision_audit([]) is None
    for events in (WALL_STEPS, PREDICTED_STEPS):
        assert decision_audit(events) == ref_report.decision_audit(events)


def test_report_renders_and_cli(pair, tmp_path):
    _, tg = pair
    tel = Telemetry()
    api.solve(tg, "bfs", root=0, policy="auto", telemetry=tel)
    report = render_report(_final_events(tel))
    assert "| reads | writes | atomics | locks |" in report
    assert "Decision audit" in report and "wall basis" in report
    trace, out = tmp_path / "t.jsonl", tmp_path / "report.md"
    write_jsonl(tel, trace)
    assert main([str(trace), "--out", str(out)]) == 0
    assert "Decision audit" in out.read_text()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.report", str(trace)],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr
    assert "Counter totals" in proc.stdout


# ---------------------------------------------------------------------
# against the reference, on the same graph


def strip(events, kinds=("step", "run")) -> list:
    return [{k: v for k, v in e.items() if k not in TIMES | {"backend"}}
            for e in events if e["kind"] in kinds]


@pytest.mark.parametrize("alg,policy,backend", [
    ("bfs", "auto", "dense"), ("bfs", "gs", "dense"),
    ("pagerank", "pull", "dense"), ("ppr", "auto", "dense"),
    ("bfs", "auto", "cuda"), ("pagerank", "push", "cuda"),
    ("sssp_delta", "auto", "dense")])
def test_events_equal_reference(pair, alg, policy, backend):
    """The Pallas side runs untimed: under the reference's stepwise loop
    its push kernel cannot build its bin plan inside the jitted step and
    the fallback ladder takes the plain push, which charges no binning.
    The port's timed steps are held to its untimed ``run`` above."""
    g, tg = pair
    kw = {"sssp_delta": {"source": 0, "delta": 2.5}}.get(alg, ALGS.get(alg))
    ref_be = pinned("pallas") if backend == "cuda" else backend
    port_be = pinned("cuda") if backend == "cuda" else backend
    ref_tel = RefTelemetry(step_timing=backend != "cuda")
    tel = Telemetry()
    ref_api.solve(g, alg, policy=policy, backend=ref_be, telemetry=ref_tel,
                  **kw)
    api.solve(tg, alg, policy=policy, backend=port_be, telemetry=tel, **kw)
    assert strip(tel.events) == strip(ref_tel.events)
    if ref_tel.step_timing:
        # timed steps on both sides, or on neither, and one basis
        assert [("us" in e) for e in tel.events if e["kind"] == "step"] \
            == [("us" in e) for e in ref_tel.events if e["kind"] == "step"]
        assert [e["basis"] for e in tel.events if e["kind"] == "audit"] \
            == [e["basis"] for e in ref_tel.events if e["kind"] == "audit"]
    # one audit and one report from one event list, in both packages
    for events in (_final_events(tel), ref_export._final_events(ref_tel)):
        assert decision_audit(events) == ref_report.decision_audit(events)
        assert render_report(events) == ref_report.render_report(events)


def test_solve_batch_telemetry_matches_plain_and_reference(pair):
    g, tg = pair
    ref_tel, tel = RefTelemetry(), Telemetry()
    plain = api.solve_batch(tg, "bfs", sources=[0, 5])
    observed = api.solve_batch(tg, "bfs", sources=[0, 5], telemetry=tel)
    assert torch.equal(plain.state["dist"], observed.state["dist"])
    assert [e["kind"] for e in tel.events].count("run") == 1
    ref_api.solve_batch(g, "bfs", sources=[0, 5], telemetry=ref_tel)
    assert strip(tel.events) == strip(ref_tel.events)


def service_events(tel) -> list:
    return [(e["kind"], e.get("name"), e.get("algorithm"), e.get("width"),
             e.get("steps")) for e in tel.events
            if str(e.get("name", "")).startswith("service.")]


def test_query_service_telemetry_matches_reference(pair):
    g, tg = pair
    ref_tel, tel = RefTelemetry(), Telemetry()
    ref_svc = RefQueryService(g, slots=2, telemetry=ref_tel)
    svc = QueryService(tg, slots=2, telemetry=tel)
    for s in (ref_svc, svc):
        rids = [s.submit("bfs", source=v) for v in (0, 1, 0)]
        rids.append(s.submit("wcc"))
        s.run_until_complete()
        assert all(s.poll(r) is not None for r in rids)
    names = {e.get("name") for e in tel.events}
    assert {"service.coalesce", "service.batch_start",
            "service.chunk"} <= names
    assert service_events(tel) == service_events(ref_tel)
    # the single wcc solve carries run and step events
    assert strip(tel.events) == strip(ref_tel.events)
    # the port's own wait gauges (``stats()["waits"]``) aside
    service = {k: v for k, v in tel.counters.as_dict().items()
               if k.startswith("service.")
               and not k.startswith("service.waits.")}
    assert service == {k: v for k, v in ref_tel.counters.as_dict().items()
                       if k.startswith("service.")}
    # folded in when the bfs batch drained: its two slotted queries (the
    # duplicate coalesced); the wcc solve after it is the third
    assert tel.counters.get("service.waits.count") == 2
    assert tel.counters.get("service.waits.in_slot_p95_ms") >= 0
    assert svc.stats()["waits"]["count"] == 3
    assert tel.counters.get("service.batches_started") >= 1
    assert validate_events(_final_events(tel)) == []


def test_tuner_and_backend_counters(pair):
    tel = Telemetry()
    stats = collect_tuner(tel)
    assert set(stats) == {"mem_hits", "disk_hits", "misses", "probes",
                          "writes", "write_errors", "probe_retries",
                          "probe_timeouts", "probe_failures",
                          "probe_degraded"}
    assert tel.counters.get("tuner.probes") == stats["probes"]
    assert api.DenseBackend().telemetry_counters() == {}
    _, tg = pair
    be = pinned("cuda")
    tel = Telemetry()
    api.solve(tg, "bfs", root=0, policy="auto", backend=be, telemetry=tel)
    counters = be.telemetry_counters()
    assert counters == be.stats and counters["kernel_push"] > 0
    assert tel.counters.get("backend.CudaBackend.kernel_push") == \
        counters["kernel_push"]


# ---------------------------------------------------------------------
# the program's ranges and counters


def _session(tg, be, telemetry=None):
    """A batched PPR solve, then a service session: a full-width batch
    that refills, a coalesced duplicate, an unbatchable single solve."""
    br = api.solve_batch(tg, "ppr", sources=[0, 5, 7], backend=be)
    svc = QueryService(tg, slots=2, chunk_steps=3, backend=be,
                       telemetry=telemetry)
    for s in (1, 2, 3, 1):
        svc.submit("ppr", s)
    svc.submit("pagerank", iters=5)
    svc.run_until_complete()
    return br, svc


def test_no_range_is_entered_without_a_profiler(pair, monkeypatch):
    _, tg = pair
    entered = []

    def counting(real):
        def enter(name, *a, **k):
            entered.append(name)
            return real(name, *a, **k)
        return enter
    for mod, attr in ((torch._C._profiler, "_RecordFunctionFast"),
                      (torch.profiler, "record_function"),
                      (torch.autograd.profiler, "record_function")):
        monkeypatch.setattr(mod, attr, counting(getattr(mod, attr)))
    be = pinned("cuda")
    _session(tg, be)
    _session(tg, be, telemetry=Telemetry())
    assert entered == []
    # the same calls do enter them while a profiler records
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _session(tg, be)
    assert "repro.engine.step" in entered


def _ranges(prof) -> collections.Counter:
    return collections.Counter(
        ev.name() for ev in prof.profiler.kineto_results.events()
        if ev.name().startswith("repro."))


def test_each_layer_opens_its_range_under_a_profiler(pair):
    _, tg = pair
    be = pinned("cuda")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        br = api.solve_batch(tg, "ppr", sources=[0, 5, 7], backend=be)
    got = _ranges(prof)
    # a fresh backend builds the pull's row plan once, then every step
    # is one full-scan pull fused with its update
    assert got == {"repro.batch.solve_batch": 1, "repro.engine.run": 1,
                   "repro.engine.step": br.steps,
                   "repro.backend.pull_update": br.steps,
                   "repro.backend.build": 1}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        br, svc = _session(tg, be)
    got, st = _ranges(prof), svc.stats()
    chunks, starts = st["chunks_run"], st["batches_started"] + 1
    assert got["repro.batch.solve_batch"] == 1
    assert got["repro.service.start"] == starts
    assert got["repro.service.chunk"] == got["repro.service.retire"] \
        == got["repro.batch.run_chunk"] == chunks
    # one engine run per chunk, the batch's and the single solve's
    assert got["repro.engine.run"] == chunks + 2
    assert got["repro.engine.step"] >= br.steps + chunks
    # a build only on a miss: the row plans of widths not seen before
    assert got["repro.backend.build"] == len(be._plans) - 1


def _sparse():
    """A graph of low in-degree, so that a late BFS's unvisited rows fit
    the frontier pull."""
    from repro_torch.graphs import erdos_renyi
    return erdos_renyi(300, 3.0, seed=2, device="cpu")


def test_push_frontier_pull_and_probe_ranges(tmp_path, monkeypatch):
    tg = _sparse()
    be = CudaBackend(autotune=False, block_n=64, block_e=128,
                     push_block_n=64, push_strategy="scan",
                     pull_frontier_cap=1 << 20)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        r = api.solve(tg, "bfs", root=0, policy="auto", backend=be)
        with Telemetry().span("work"):
            pass
    got = _ranges(prof)
    assert got["repro.engine.step"] == r.steps
    assert got["repro.backend.push"] == be.stats["kernel_push"] > 0
    assert got["repro.backend.pull_frontier"] == \
        be.stats["kernel_pull_frontier"] > 0
    assert got["repro.work"] == 1                 # a Telemetry span
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))
    tune.clear_memory_cache()
    try:
        probes = tune.tune_stats()["probes"]
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            tune.tune_pull(300, 6, 4, torch.int32, "min", "copy", "cpu")
        assert tune.tune_stats()["probes"] == probes + 1
        assert _ranges(prof)["repro.tune.probe"] == 1
    finally:
        tune.clear_memory_cache()


def test_pull_edges_counts_the_slots_each_kernel_pull_reads(pair):
    _, tg = pair
    be = pinned("cuda")
    br = api.solve_batch(tg, "ppr", sources=[0, 5, 7], backend=be)
    assert be.stats["pull_edges"] == br.steps * tg.m
    assert be.stats["kernel_pull"] == br.steps
    # a pull-only BFS: the touched (unvisited) rows' slots, or a full
    # scan where they do not fit, as _pull_scan_stats prices each pull
    tg = _sparse()
    be = CudaBackend(autotune=False, block_n=64, block_e=128,
                     push_block_n=64, push_strategy="scan",
                     pull_frontier_cap=1 << 20)
    priced = []
    real = be._pull_scan_stats

    def scan_stats(g, touched):
        out = real(g, touched)
        priced.append(out[0])
        return out
    object.__setattr__(be, "_pull_scan_stats", scan_stats)
    r = api.solve(tg, "bfs", root=0, policy="pull", backend=be)
    assert len(priced) == r.steps and be.stats["kernel_pull_frontier"] > 0
    assert be.stats["pull_edges"] == sum(priced)
    assert be.stats["pull_edges"] < r.steps * tg.m


def test_ring_export_carries_its_wall_clock_anchor(pair, tmp_path):
    before = time.time_ns()
    tel = Telemetry()
    after = time.time_ns()
    assert before <= tel.epoch_ns <= after
    _, tg = pair
    api.solve(tg, "bfs", root=0, policy="auto", telemetry=tel)
    path = tmp_path / "trace.jsonl"
    write_jsonl(tel, path)
    meta = load_jsonl(path)[0]
    assert meta["kind"] == "meta" and meta["epoch_ns"] == tel.epoch_ns
    assert validate_trace_file(path) and \
        ref_export.validate_trace_file(path)
    for source in (tel, load_jsonl(path)):
        write_chrome_trace(source, tmp_path / "trace.json")
        head = json.loads((tmp_path / "trace.json").read_text()
                          )["traceEvents"][0]
        assert head["ph"] == "M" and head["args"]["epoch_ns"] == \
            tel.epoch_ns
