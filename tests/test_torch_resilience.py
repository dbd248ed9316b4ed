"""The port's fault injection (``repro_torch.resilience``) and its seams
against the JAX package's ``repro.resilience``, on the CPU.

  * plans and specs: validation, the JSON round trip, each named plan's
    JSON equal to the reference's, and for each named plan and site the
    first 200 hits faulting in the port exactly where they fault in the
    reference; ``fault_point``, ``inject``, ``$REPRO_FAULT_PLAN`` and
    ``resilient_call``;
  * the engine: ``check_finite`` in both packages alike; an automatic
    resume from transient ``engine.step`` faults, bit-identical, with
    the reference's fault and resume counts; a permanent fault raising
    ``SolveInterrupted``; a manual resume from a checkpoint that later
    steps ran past, bit-identical; ``ci-default`` preserving BFS, WCC
    and PageRank through ``"cuda"``; ``kernels-down`` injecting nothing
    (the port has no kernel fallback ladder, by design);
  * the tuner: a transient probe fault retried, a permanent one taking
    the default unpersisted, the deadline, disk faults on the memory
    tier, and a non-injected probe error propagating;
  * the service: chunk retries, structured failure on a permanent
    fault, cache faults that recompute, a chaos schedule, and
    ``collect_resilience``.
"""

import dataclasses
import json
import time

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp
from repro import api as ref_api
from repro import resilience as ref_res
from repro.core.engine import PushPullEngine as RefEngine
from repro.graphs import erdos_renyi as ref_erdos_renyi
from repro_torch import api, resilience
from repro_torch.core import CudaBackend, DenseBackend
from repro_torch.core.engine import Checkpoint, PushPullEngine
from repro_torch.graphs import GRAPH_ARRAYS, build_graph, graph_from_arrays
from repro_torch.kernels import tune
from repro_torch.resilience import (SITES, DivergenceError, FaultInjected,
                                    FaultPlan, FaultSpec, ProbeTimeout,
                                    SolveInterrupted,
                                    clear_resilience_stats, drain_events,
                                    fault_point, inject, named_plans,
                                    resilience_stats, resilient_call)
from repro_torch.service import QueryService

HITS = 200


@pytest.fixture(autouse=True)
def _clean_resilience():
    """No active plan and fresh counters around every test, in both
    packages: chaos state must not leak across tests."""
    for pkg in (resilience, ref_res):
        pkg.deactivate()
        pkg.clear_resilience_stats()
    yield
    for pkg in (resilience, ref_res):
        pkg.deactivate()
        pkg.clear_resilience_stats()


@pytest.fixture
def cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))
    tune.clear_memory_cache()
    tune.clear_stats()
    yield tmp_path
    tune.clear_memory_cache()


def _plan(*specs, name="test", seed=0):
    return FaultPlan(name=name, seed=seed, specs=tuple(specs))


@pytest.fixture(scope="module")
def pair():
    g = ref_erdos_renyi(80, 4.0, seed=3, weighted=True)
    tg = graph_from_arrays({f: np.asarray(getattr(g, f))
                            for f in GRAPH_ARRAYS},
                           n=g.n, m=g.m, d_ell=g.d_ell, device="cpu")
    return g, tg


def pinned() -> CudaBackend:
    return CudaBackend(autotune=False, block_n=64, block_e=128,
                       push_block_n=64, push_strategy="scan")


# ---------------------------------------------------------------------------
# plans, specs and the injector
# ---------------------------------------------------------------------------

def test_spec_rejects_unknown_site_kind_error():
    with pytest.raises(ValueError, match="unknown fault site"):
        FaultSpec(site="nonsense.site")
    with pytest.raises(ValueError, match="transient"):
        FaultSpec(site="pallas.pull", kind="flaky")
    with pytest.raises(ValueError, match="unknown error class"):
        FaultSpec(site="pallas.pull", error="SegFault")
    with pytest.raises(ValueError, match=">= 1"):
        FaultSpec(site="pallas.pull", every=0)
    assert SITES == ref_res.SITES


def test_plan_rejects_duplicate_sites_and_round_trips_json():
    with pytest.raises(ValueError, match="duplicate"):
        _plan(FaultSpec(site="engine.step"), FaultSpec(site="engine.step"))
    with pytest.raises(TypeError, match="FaultSpec"):
        _plan("engine.step")
    plan = named_plans()["ci-default"]
    assert FaultPlan.from_json(plan.to_json()) == plan
    assert json.loads(plan.to_json())["name"] == "ci-default"


@pytest.mark.parametrize("name", sorted(named_plans()))
def test_named_plan_json_equals_reference(name):
    text = named_plans()[name].to_json()
    assert text == ref_res.named_plans()[name].to_json()
    # one plan JSON serves both packages
    assert ref_res.FaultPlan.from_json(text) == ref_res.named_plans()[name]


def fired(pkg, plan, site: str) -> list[bool]:
    out = []
    with pkg.inject(plan):
        for _ in range(HITS):
            try:
                pkg.fault_point(site)
                out.append(False)
            except (pkg.FaultInjected, OSError):
                out.append(True)
    return out


@pytest.mark.parametrize("site", SITES)
@pytest.mark.parametrize("name", sorted(named_plans()))
def test_schedule_equals_reference(name, site):
    plan = named_plans()[name]
    ref_plan = ref_res.FaultPlan.from_json(plan.to_json())
    assert fired(resilience, plan, site) == fired(ref_res, ref_plan, site)


def test_seeded_rate_and_periodic_schedules_equal_reference():
    for spec in (dict(rate=0.5), dict(every=3, start=2, count=2),
                 dict(kind="permanent", start=5)):
        plan = _plan(FaultSpec(site="service.chunk", **spec), seed=42)
        ref_plan = ref_res.FaultPlan.from_json(plan.to_json())
        got = fired(resilience, plan, "service.chunk")
        assert got == fired(ref_res, ref_plan, "service.chunk")
        assert got == fired(resilience, plan, "service.chunk")
        assert 0 < sum(got) < HITS


def test_injector_error_classes_and_stats():
    plan = _plan(FaultSpec(site="tune.cache.load", error="OSError",
                           every=2))
    with inject(plan) as inj:
        with pytest.raises(OSError, match="injected OSError"):
            fault_point("tune.cache.load")
        fault_point("tune.cache.load")
        with pytest.raises(FaultInjected) as ei:
            resilience.install(_plan(FaultSpec(site="engine.step")))
            fault_point("engine.step")
        assert (ei.value.site, ei.value.hit) == ("engine.step", 1)
    assert inj.stats() == {"hits": {"tune.cache.load": 2},
                           "injected": {"tune.cache.load": 1}}


def test_fault_point_rejects_unknown_site_only_when_active():
    fault_point("engine.step")           # no plan: a no-op
    with inject(_plan(FaultSpec(site="engine.step"))):
        with pytest.raises(ValueError, match="unknown fault site"):
            fault_point("not.a.site")


def test_inject_restores_previous_injector():
    outer = _plan(FaultSpec(site="tune.probe", kind="permanent"))
    inner = _plan(FaultSpec(site="engine.step", kind="permanent"))
    with inject(outer):
        with inject(inner):
            assert resilience.active_plan() is inner
        assert resilience.active_plan() is outer
    assert resilience.active_plan() is None


def test_resilient_call_retries_transient_and_exhausts_permanent():
    calls = []
    with inject(_plan(FaultSpec(site="service.chunk", every=99))):
        out = resilient_call("service.chunk",
                             lambda: calls.append(1) or "ok")
    assert out == "ok" and len(calls) == 1
    assert resilience_stats()["retry.service.chunk"] == 1
    with inject(_plan(FaultSpec(site="service.chunk", kind="permanent"))):
        with pytest.raises(FaultInjected):
            resilient_call("service.chunk", lambda: "never", retries=2)


def test_env_plan_selection(monkeypatch, tmp_path):
    from repro_torch.resilience import faults
    monkeypatch.setenv("REPRO_FAULT_PLAN", "ci-default")
    faults._install_from_env()
    assert resilience.active_plan().name == "ci-default"
    path = tmp_path / "plan.json"
    path.write_text(named_plans()["soak"].to_json())
    monkeypatch.setenv("REPRO_FAULT_PLAN", str(path))
    faults._install_from_env()
    assert resilience.active_plan() == named_plans()["soak"]
    resilience.deactivate()
    monkeypatch.setenv("REPRO_FAULT_PLAN", "no-such-plan")
    with pytest.raises(ValueError, match="REPRO_FAULT_PLAN"):
        faults._install_from_env()


# ---------------------------------------------------------------------------
# the engine: check_finite, checkpoints and resumes
# ---------------------------------------------------------------------------

FINITE_CASES = [          # (state, mode, trips)
    ({"x": [1.0, float("nan")]}, "nan", True),
    ({"x": [1.0, float("nan")]}, "all", True),
    ({"d": [0.0, float("inf")], "i": [1, 2]}, "nan", False),
    ({"d": [0.0, float("inf")], "i": [1, 2]}, "all", True),
    ({"d": [0.0, float("-inf")]}, True, True),
    ({"i": [1, 2]}, True, False),
    ({"x": [1.0, 2.0]}, "all", False),
]


def trips(check, state, mode, error) -> bool:
    try:
        check(state, mode, 3)
    except error as e:
        assert e.step == 3
        assert e.mode == ("all" if mode in ("all", True) else "nan")
        return True
    return False


@pytest.mark.parametrize("state,mode,want", FINITE_CASES)
def test_check_finite_modes_equal_reference(state, mode, want):
    port = {k: torch.tensor(v) for k, v in state.items()}
    ref = {k: jnp.asarray(v) for k, v in state.items()}
    assert trips(PushPullEngine._check_finite, port, mode,
                 DivergenceError) == want
    assert trips(RefEngine._check_finite, ref, mode,
                 ref_res.DivergenceError) == want


def test_solve_divergence_names_the_step(pair):
    """PageRank keeps finite state; forcing one NaN into its update trips
    the guard at the step that produced it."""
    _, tg = pair
    r = api.solve(tg, "pagerank", iters=6, check_finite="nan")
    assert r.steps == 6
    spec = api.get_spec("pagerank")
    policy = api._resolve_policy("pull")
    program, steps = spec.build(tg, policy=policy, backend=DenseBackend())
    upd = program.update_fn

    def poisoned(state, msgs, step):
        s, f, c = upd(state, msgs, step)
        return (torch.where(torch.arange(s.shape[0]) == 0, float("nan"), s)
                if step == 2 else s), f, c
    eng = PushPullEngine(program=dataclasses.replace(program,
                                                     update_fn=poisoned),
                         policy=policy, max_steps=steps)
    state0, frontier0 = spec.init(tg, iters=6)
    with pytest.raises(DivergenceError, match="after step 2"):
        eng.run_stepwise(tg, state0, frontier0, check_finite="nan")


def stats_of(pkg) -> dict:
    return {k: v for k, v in pkg.resilience_stats().items()
            if k.startswith(("injected.", "resume."))}


def test_solve_auto_resumes_transient_step_faults(pair):
    g, tg = pair
    ref = api.solve(tg, "bfs", root=1).state["dist"]
    # every=4 leaves 3 clean hits between faults, so each resume makes
    # progress and the solve finishes inside the resume budget
    plan = _plan(FaultSpec(site="engine.step", every=4, start=2))
    with inject(plan) as inj:
        r = api.solve(tg, "bfs", root=1, checkpoint_every=1)
    assert torch.equal(r.state["dist"], ref)
    assert inj.stats()["injected"]["engine.step"] >= 1
    assert resilience_stats()["resume.engine.step"] >= 1
    with ref_res.inject(ref_res.FaultPlan.from_json(plan.to_json())):
        ref_api.solve(g, "bfs", root=1, checkpoint_every=1)
    assert stats_of(resilience) == stats_of(ref_res)


def test_solve_permanent_step_fault_raises_structured(pair):
    _, tg = pair
    with inject(_plan(FaultSpec(site="engine.step", kind="permanent",
                                start=3))):
        with pytest.raises(SolveInterrupted) as ei:
            api.solve(tg, "bfs", root=0, checkpoint_every=1)
    assert isinstance(ei.value.__cause__, FaultInjected)
    assert isinstance(ei.value.checkpoint, Checkpoint)
    assert ei.value.checkpoint.step == 2


@pytest.mark.parametrize("backend", ("dense", "cuda"))
@pytest.mark.parametrize("alg,kw", [("pagerank", {"iters": 10}),
                                    ("bfs", {"root": 0})])
def test_manual_checkpoint_resume_is_bit_identical(pair, alg, kw, backend):
    """The checkpoint at step 2 is taken before step 3 runs past it (and
    writes its trace row and state); resuming from it, twice, gives the
    uninterrupted result bit for bit."""
    _, tg = pair
    spec = api.get_spec(alg)
    policy = api._resolve_policy("auto")
    be = pinned() if backend == "cuda" else DenseBackend()
    program, steps = spec.build(tg, policy=policy, backend=be)
    eng = PushPullEngine(program=program, policy=policy, max_steps=steps,
                         backend=be, trace_capacity=32)
    state0, frontier0 = spec.init(tg, **kw)
    whole = eng.run(tg, state0, frontier0)
    assert whole.steps >= 4
    with inject(_plan(FaultSpec(site="engine.step", kind="permanent",
                                start=4))):
        with pytest.raises(SolveInterrupted) as ei:
            eng.run_stepwise(tg, state0, frontier0, checkpoint_every=2)
    ckpt = ei.value.checkpoint
    assert ei.value.step == 3 and ckpt.step == 2
    for _ in range(2):
        resumed = eng.run_stepwise(tg, state0, frontier0, resume_from=ckpt)
        st = whole.state if isinstance(whole.state, dict) else {
            "x": whole.state}
        rt = resumed.state if isinstance(resumed.state, dict) else {
            "x": resumed.state}
        for k in st:
            assert torch.equal(st[k], rt[k]), k
        assert resumed.cost.as_dict() == whole.cost.as_dict()
        assert (resumed.steps, resumed.push_steps) == (whole.steps,
                                                       whole.push_steps)
        assert resumed.trace.as_dict(whole.steps) == \
            whole.trace.as_dict(whole.steps)


def test_checkpoint_rejected_for_phase_programs(pair):
    _, tg = pair
    with pytest.raises(ValueError, match="flat programs"):
        api.solve(tg, "betweenness", checkpoint_every=4)


@pytest.mark.parametrize("algorithm,kwargs,key,exact", [
    ("bfs", dict(root=0), "dist", True),
    ("wcc", dict(), None, True),
    ("pagerank", dict(iters=10), None, False),
])
def test_ci_default_plan_preserves_results(pair, cache, algorithm, kwargs,
                                           key, exact):
    """Every transient fault of ci-default is recovered through the
    autotuned CUDA backend: the tuner's cache loads and writes and its
    probes (BFS and WCC push; PageRank's pull has one candidate at this
    n, so nothing to probe) and the stepwise loop's steps (checkpoint
    every step)."""
    _, tg = pair

    def run():
        tune.clear_memory_cache()
        s = api.solve(tg, algorithm, backend=CudaBackend(),
                      checkpoint_every=1, **kwargs).state
        return s if key is None else s[key]

    want = run()
    with inject(named_plans()["ci-default"]) as inj:
        got = run()
    injected = inj.stats()["injected"]
    assert injected.get("engine.step", 0) >= 1
    if algorithm != "pagerank":
        assert injected.get("tune.cache.load", 0) >= 1
        assert injected.get("tune.probe", 0) >= 1
    if exact:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-7)


def test_kernels_down_injects_nothing(pair):
    """The JAX package's ``kernels-down`` plan faults its kernel
    dispatch; the port has no such seam (a kernel that fails raises),
    so the plan injects nothing and the answer is unchanged."""
    _, tg = pair
    want = api.solve(tg, "bfs", root=0, backend=pinned()).state["dist"]
    be = pinned()
    with inject(named_plans()["kernels-down"]) as inj:
        got = api.solve(tg, "bfs", root=0, backend=be,
                        checkpoint_every=2).state["dist"]
    assert torch.equal(got, want)
    assert inj.stats()["injected"] == {}
    assert be.stats["fallback_pull"] == be.stats["fallback_push"] == 0
    assert be.stats["kernel_push"] + be.stats["kernel_pull"] \
        + be.stats["kernel_pull_frontier"] > 0


def test_no_plan_no_counters(pair):
    _, tg = pair
    r = api.solve(tg, "bfs", root=0)
    assert r.converged
    assert resilience_stats() == {} and drain_events() == []


def test_solve_results_identical_with_and_without_guards(pair):
    _, tg = pair
    plain = api.solve(tg, "bfs", root=2)
    guarded = api.solve(tg, "bfs", root=2, check_finite="nan",
                        checkpoint_every=2)
    assert torch.equal(plain.state["dist"], guarded.state["dist"])
    assert plain.steps == guarded.steps
    # phase programs take the guard too, checked at run end
    assert api.solve(tg, "sssp_delta", source=0, delta=2.0,
                     check_finite="nan").converged


# ---------------------------------------------------------------------------
# the tuner: retries, the default, the deadline, the disk tier
# ---------------------------------------------------------------------------

def tune_small():
    return tune.tune_pull(400, 8, 1, torch.float32, "sum", "copy", "cpu")


def test_tuner_transient_probe_fault_retries(cache):
    with inject(_plan(FaultSpec(site="tune.probe", every=99))):
        best = tune_small()
    assert best in tune.pull_candidates(400, 1)
    s = tune.tune_stats()
    assert s["probe_retries"] == s["probe_failures"] == 1
    assert s["probe_degraded"] == 0 and s["writes"] == 1


def test_tuner_permanent_probe_fault_degrades_unpersisted(cache,
                                                          monkeypatch):
    monkeypatch.setenv("REPRO_TUNE_RETRIES", "1")
    with inject(_plan(FaultSpec(site="tune.probe", kind="permanent"))):
        best = tune_small()
    assert best == tune.pull_candidates(400, 1)[0]
    s = tune.tune_stats()
    assert s["probe_degraded"] == 1 and s["probe_failures"] == 2
    assert s["writes"] == 0
    assert not (cache / "tune_torch.json").exists()
    assert resilience_stats()["degraded.tune.probe"] == 1


def test_probe_deadline_raises_probe_timeout(cache, monkeypatch):
    monkeypatch.setenv("REPRO_TUNE_DEADLINE_S", "0")
    monkeypatch.setenv("REPRO_TUNE_RETRIES", "0")
    best = tune_small()
    assert best == tune.pull_candidates(400, 1)[0]
    s = tune.tune_stats()
    assert s["probe_timeouts"] == 1 and s["probe_degraded"] == 1
    assert s["writes"] == 0
    monkeypatch.setenv("REPRO_TUNE_DEADLINE_S", "0.01")
    seen = []

    def slow(in_time):
        time.sleep(0.05)
        try:
            in_time()
        except ProbeTimeout as e:
            seen.append(e)
            raise
        return 1
    assert tune._probe_guarded("pull", slow, 128) == (128, False)
    assert len(seen) == 1 and seen[0].kernel == "pull"
    assert "0.01s deadline" in str(seen[0])


def test_tuner_disk_faults_degrade_to_memory_tier(cache):
    plan = _plan(FaultSpec(site="tune.cache.load", kind="permanent",
                           error="OSError"),
                 FaultSpec(site="tune.cache.write", kind="permanent",
                           error="OSError"))
    with inject(plan):
        best = tune_small()
        again = tune_small()               # the memory tier serves it
    assert best == again
    s = tune.tune_stats()
    assert s["write_errors"] >= 1 and s["mem_hits"] >= 1
    assert not (cache / "tune_torch.json").exists()


def test_non_injected_probe_error_propagates(cache, monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("kernel failed to launch")
    monkeypatch.setattr(tune, "ell_spmv", broken)
    with pytest.raises(RuntimeError, match="failed to launch"):
        tune_small()
    s = tune.tune_stats()
    assert s["probe_degraded"] == s["probe_retries"] == 0


# ---------------------------------------------------------------------------
# the service
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def svc_graph():
    src = np.array([0, 1, 2, 3, 4, 0, 2])
    dst = np.array([1, 2, 3, 4, 5, 2, 5])
    return build_graph(src, dst, 6, device="cpu")


def test_permanent_chunk_fault_fails_structurally_no_hang(svc_graph):
    with inject(_plan(FaultSpec(site="service.chunk", kind="permanent"))):
        svc = QueryService(svc_graph, slots=2)
        rids = [svc.submit("bfs", source=s) for s in range(3)]
        svc.run_until_complete()
    for rid in rids:
        st = svc.status(rid)
        assert st["status"] == "failed" and "FaultInjected" in st["error"]
    fails = svc.stats()["failures"]
    assert fails and all(f["error"] == "FaultInjected" for f in fails)


def test_transient_chunk_fault_retries_and_serves(svc_graph):
    ref = api.solve(svc_graph, "bfs", root=0).state["dist"]
    with inject(_plan(FaultSpec(site="service.chunk", every=3))):
        svc = QueryService(svc_graph, slots=2)
        rid = svc.submit("bfs", source=0)
        svc.run_until_complete()
        got = svc.poll(rid)["dist"]
    assert torch.equal(got, ref)
    assert svc.chunk_retries >= 1
    assert svc.stats()["chunk_retries"] == svc.chunk_retries


def test_unbatchable_solve_retried_behind_the_chunk_site(svc_graph):
    ref = api.solve(svc_graph, "wcc").state
    with inject(_plan(FaultSpec(site="service.chunk", every=3))):
        svc = QueryService(svc_graph)
        rid = svc.submit("wcc")
        svc.run_until_complete()
    assert torch.equal(svc.poll(rid), ref)
    assert svc.chunk_retries == 1


def test_cache_faults_degrade_to_recompute(svc_graph):
    plan = _plan(FaultSpec(site="service.cache.get", kind="permanent",
                           error="OSError"),
                 FaultSpec(site="service.cache.put", kind="permanent",
                           error="OSError"))
    ref = api.solve(svc_graph, "bfs", root=2).state["dist"]
    with inject(plan):
        svc = QueryService(svc_graph, slots=2)
        r1 = svc.submit("bfs", source=2)
        svc.run_until_complete()
        r2 = svc.submit("bfs", source=2)   # lookup faults -> recompute
        svc.run_until_complete()
    assert torch.equal(svc.poll(r1)["dist"], ref)
    assert torch.equal(svc.poll(r2)["dist"], ref)
    assert svc.cache_errors >= 2
    assert not svc.record(r2).cached
    assert resilience_stats()["fallback.service.cache.get"] >= 2


def test_force_retire_under_faults_returns_best_effort(svc_graph):
    with inject(_plan(FaultSpec(site="service.chunk", every=3))):
        svc = QueryService(svc_graph, slots=2, chunk_steps=1,
                           max_chunks_per_query=1)
        rid = svc.submit("ppr", source=0, tol=0.0)   # never settles
        svc.run_until_complete()
    assert svc.stats()["force_retired"] == 1
    rec = svc.record(rid)
    assert rec.done and not rec.converged and svc.poll(rid) is not None
    assert svc.chunk_retries >= 1
    assert not svc.record(svc.submit("ppr", source=0, tol=0.0)).cached


_CHAOS_SITES = ("service.chunk", "service.cache.get", "service.cache.put",
                "engine.step", "tune.cache.load", "tune.cache.write")


@settings(max_examples=12, deadline=None)
@given(seed=st.integers(0, 2**16),
       n_sites=st.integers(1, len(_CHAOS_SITES)),
       order_seed=st.integers(0, 2**16))
def test_scheduler_chaos_schedule(seed, n_sites, order_seed):
    """Random transient fault sites and arrival orders: the service
    always drains, and every query gets the fault-free answer."""
    src = np.array([0, 1, 2, 3, 4, 0, 2])
    dst = np.array([1, 2, 3, 4, 5, 2, 5])
    g = build_graph(src, dst, 6, device="cpu")
    refs = {s: api.solve(g, "bfs", root=s).state["dist"] for s in range(6)}
    rng = np.random.default_rng(seed)
    sites = list(rng.choice(_CHAOS_SITES, size=n_sites, replace=False))
    specs = tuple(FaultSpec(site=s, every=int(rng.integers(2, 5)),
                            error=("OSError" if ".cache." in s
                                   else "FaultInjected"))
                  for s in sites)
    arrival = np.random.default_rng(order_seed).permutation(6)
    try:
        with inject(FaultPlan(name="hyp", seed=seed, specs=specs)):
            svc = QueryService(g, slots=3)
            rids = {int(s): svc.submit("bfs", source=int(s))
                    for s in arrival}
            svc.run_until_complete()
            for s, rid in rids.items():
                assert torch.equal(svc.poll(rid)["dist"], refs[s]), (s,
                                                                     sites)
    finally:
        resilience.deactivate()
        clear_resilience_stats()


def test_collect_resilience_counters_events_and_report(pair):
    from repro_torch.obs import Telemetry, collect_resilience, render_report
    _, tg = pair
    tel = Telemetry()
    with inject(_plan(FaultSpec(site="engine.step", every=4, start=2))):
        api.solve(tg, "bfs", root=0, checkpoint_every=1, telemetry=tel)
    counters = tel.counters.as_dict()
    assert counters["resilience.injected.engine.step"] >= 1
    assert counters["resilience.resume.engine.step"] >= 1
    names = {e.get("name") for e in tel.events if e.get("kind") == "event"}
    assert "resilience.fault" in names
    assert any(n.startswith("resilience.resume") for n in names)
    md = render_report(tel.events)
    assert "## Resilience" in md and "resilience.fault" in md
    assert drain_events() == []          # drained into the handle
    collect_resilience(tel)


def test_service_telemetry_under_faults(svc_graph):
    from repro_torch.obs import Telemetry
    tel = Telemetry()
    plan = _plan(FaultSpec(site="service.chunk", every=3),
                 FaultSpec(site="service.cache.put", error="OSError"))
    with inject(plan):
        svc = QueryService(svc_graph, slots=2, telemetry=tel)
        for s in range(4):
            svc.submit("bfs", source=s)
        svc.run_until_complete()
    assert tel.counters.get("service.chunk_retries") >= 1
    assert tel.counters.get("service.cache_errors") >= 1
    assert tel.counters.get("resilience.retry.service.chunk") >= 1
    names = {e.get("name") for e in tel.events}
    assert {"service.batch_start", "service.chunk",
            "resilience.retry.service.chunk",
            "resilience.fallback.service.cache.put"} <= names
