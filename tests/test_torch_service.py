"""The port's batched serving against the JAX package's ``repro.service``.

  * ``api.solve_batch`` for BFS, Δ-stepping SSSP and personalized
    PageRank against ``repro.api.solve_batch``, backends paired
    dense↔dense, ell↔ell and cuda↔pallas (blocks and push strategy
    pinned on both sides, for both strategies; on the CPU the port runs
    each kernel's plain version, the reference its Pallas kernels in
    interpret mode), under push and pull;
  * ``QueryService`` against the reference ``QueryService`` on the same
    submit sequence: results, cache hits, coalescing, chunk and batch
    counts, ``AdmissionError`` past ``max_queue`` and
    ``DeadlineExceeded`` under an injected clock.

Integer and min/max state bit for bit, float sums rtol = atol = 1e-5;
Cost counters, steps, push steps, epochs, converged and done exactly.
"""

import jax
import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro.core import PallasBackend
from repro.graphs import erdos_renyi as ref_erdos_renyi
from repro.service import QueryService as RefQueryService
from repro_torch import api
from repro_torch.core import CudaBackend
from repro_torch.graphs import GRAPH_ARRAYS, graph_from_arrays
from repro_torch.resilience import AdmissionError, DeadlineExceeded
from repro_torch.service import QueryService, batchable

ALGS = {"bfs": {}, "sssp_delta": {"delta": 2.5}, "ppr": {}}
SOURCES = [0, 3, 7, 3, 101]
PAIRS = ("dense", "ell", "cuda-scan", "cuda-mxu")


@pytest.fixture(scope="module")
def pair():
    g = ref_erdos_renyi(120, 4.0, seed=11, weighted=True)
    tg = graph_from_arrays({f: np.asarray(getattr(g, f))
                            for f in GRAPH_ARRAYS},
                           n=g.n, m=g.m, d_ell=g.d_ell, device="cpu")
    return g, tg


def backends(name: str):
    """(reference, port) backends of one pair; the CUDA side pinned so
    neither tuner probes or writes a cache file."""
    if not name.startswith("cuda"):
        return name, name
    strategy = name.split("-")[1]
    pins = dict(autotune=False, block_n=64, block_e=128, push_block_n=64,
                push_strategy=strategy)
    return PallasBackend(**pins), CudaBackend(**pins)


def assert_state(got: dict, want: dict, what: str):
    assert sorted(got) == sorted(want), what
    for k in want:
        a, b = got[k].numpy(), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (what, k)
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5,
                                       err_msg=f"{what} {k}")
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{what} {k}")


@pytest.mark.parametrize("policy", ("push", "pull"))
@pytest.mark.parametrize("backend", PAIRS)
@pytest.mark.parametrize("alg", sorted(ALGS))
def test_solve_batch_matches_reference(pair, alg, backend, policy):
    g, tg = pair
    ref_be, port_be = backends(backend)
    want = ref_api.solve_batch(g, alg, sources=SOURCES, policy=policy,
                               backend=ref_be, **ALGS[alg])
    got = api.solve_batch(tg, alg, sources=SOURCES, policy=policy,
                          backend=port_be, **ALGS[alg])
    assert got.batch == want.batch == len(SOURCES)
    for i in range(len(SOURCES)):
        assert_state(got.states[i], want.states[i], f"query {i}")
    assert got.cost.as_dict() == want.cost.as_dict()
    assert (got.steps, got.push_steps, got.epochs, got.converged) == (
        int(want.steps), int(want.push_steps), int(want.epochs),
        bool(want.converged))
    np.testing.assert_array_equal(got.done.numpy(), np.asarray(want.done))
    if isinstance(port_be, CudaBackend):
        assert port_be.stats["fallback_push"] == 0
        assert port_be.stats["fallback_pull"] == 0


def test_solve_batch_rejects_bad_inputs(pair):
    _, tg = pair
    assert batchable() == ["bfs", "ppr", "sssp_delta"]
    with pytest.raises(KeyError, match="no batched program"):
        api.solve_batch(tg, "pagerank", sources=[0])
    with pytest.raises(ValueError, match="non-empty"):
        api.solve_batch(tg, "bfs", sources=[])
    with pytest.raises(ValueError, match="out of range"):
        api.solve_batch(tg, "bfs", sources=[0, tg.n])


# -- QueryService ---------------------------------------------------------
def drive(svc_cls, g, backend):
    """One submit sequence: three groups, a duplicate that coalesces, an
    unbatchable query, slot refills over short chunks, then a repeat that
    hits the cache."""
    svc = svc_cls(g, slots=3, chunk_steps=3)
    subs = ([("bfs", s, {}) for s in (0, 5, 9, 12, 40)]
            + [("ppr", s, {}) for s in (2, 2, 30)]
            + [("sssp_delta", s, {"delta": 2.5}) for s in (1, 77, 3)]
            + [("pagerank", None, {"iters": 5})])
    rids = [svc.submit(a, s, backend=backend, **kw) for a, s, kw in subs]
    svc.run_until_complete()
    again = svc.submit("bfs", 9, backend=backend)
    out = []
    for rid in rids + [again]:
        rec = svc.record(rid)
        out.append((rec.algorithm, rec.state, rec.cached, rec.converged))
    return out, svc.stats()


STAT_KEYS = ("submitted", "pending", "coalesced", "batches_started",
             "chunks_run", "force_retired", "deadline_expired",
             "admission_rejected")


@pytest.mark.parametrize("backend", ("dense", "cuda-mxu"))
def test_query_service_matches_reference(pair, backend):
    g, tg = pair
    ref_be, port_be = backends(backend)
    want, want_stats = drive(RefQueryService, g, ref_be)
    got, got_stats = drive(QueryService, tg, port_be)
    for (alg, gs, gc, gv), (_, ws, wc, wv) in zip(got, want):
        if not isinstance(ws, dict):
            gs, ws = {"rank": gs}, {"rank": ws}
        assert_state(gs, jax.device_get(ws), alg)
        assert (gc, gv) == (wc, wv), alg
    assert got[-1][2] is True                  # the repeat hit the cache
    assert got_stats["coalesced"] == 1
    for k in STAT_KEYS:
        assert got_stats[k] == want_stats[k], k
    assert got_stats["cache"] == want_stats["cache"]


def test_admission_control_matches_reference(pair):
    g, tg = pair
    results = []
    for cls, graph, err in ((RefQueryService, g, None),
                            (QueryService, tg, AdmissionError)):
        svc = cls(graph, max_queue=2)
        svc.submit("bfs", 0)
        svc.submit("bfs", 1)
        with pytest.raises(RuntimeError) as exc:
            svc.submit("bfs", 2)
        assert type(exc.value).__name__ == "AdmissionError"
        if err is not None:
            assert isinstance(exc.value, err) and exc.value.max_queue == 2
        svc.submit("bfs", 1)                     # coalesces: admitted
        svc.run_until_complete()
        results.append((svc.stats()["admission_rejected"],
                        svc.stats()["coalesced"], svc.stats()["submitted"]))
    assert results[0] == results[1] == (1, 1, 3)


def test_deadlines_match_reference(pair):
    g, tg = pair
    outcomes = []
    for cls, graph in ((RefQueryService, g), (QueryService, tg)):
        now = [0.0]
        svc = cls(graph, slots=2, chunk_steps=2, clock=lambda: now[0])
        late = svc.submit("sssp_delta", 1, delta=2.5, deadline_ms=5.0)
        ok = svc.submit("sssp_delta", 2, delta=2.5)
        queued = svc.submit("ppr", 4, deadline_ms=50.0)
        now[0] = 0.02                     # 20 ms: `late` has expired
        svc.run_until_complete()
        with pytest.raises(RuntimeError) as exc:
            svc.poll(late)
        cause = exc.value.__cause__
        assert type(cause).__name__ == "DeadlineExceeded"
        assert svc.status(late)["status"] == "failed"
        outcomes.append((cause.where, svc.poll(ok) is not None,
                         svc.poll(queued) is not None,
                         svc.stats()["deadline_expired"]))
        if cls is QueryService:
            assert isinstance(cause, DeadlineExceeded)
    assert outcomes[0] == outcomes[1]


def test_batched_results_do_not_alias_the_running_batch(pair):
    """A finished query's state is a copy: refilling its slot does not
    change what the caller already holds."""
    _, tg = pair
    svc = QueryService(tg, slots=2, chunk_steps=1)
    rids = [svc.submit("bfs", s) for s in (0, 50, 60, 70)]
    svc.run_until_complete()
    for rid, s in zip(rids, (0, 50, 60, 70)):
        want = api.solve(tg, "bfs", root=s).state
        got = svc.poll(rid)
        for k in want:
            assert torch.equal(got[k], want[k])


def _rank(values, q):
    vals = sorted(values)
    return vals[max(0, -(-q * len(vals) // 100) - 1)]


def test_waits_are_stamped_on_the_services_clock(pair, monkeypatch):
    """Queue and in-slot waits on an injected clock that moves only in a
    chunk (1 s) and a single solve (0.25 s): exact for queries slotted
    at a batch's start, at a refill and for a single solve; coalesced
    followers and cache hits never hold a slot and are left out."""
    from repro_torch.service import scheduler
    _, tg = pair
    now = [0.0]
    chunks = []                      # the rids slotted in each chunk
    run_chunk, solve = scheduler.run_chunk, api.solve

    def timed_chunk(*a, **k):
        chunks.append({s[0] for s in svc._active.slot_rids if s})
        now[0] += 1.0
        return run_chunk(*a, **k)

    def timed_solve(*a, **k):
        now[0] += 0.25
        return solve(*a, **k)
    monkeypatch.setattr(scheduler, "run_chunk", timed_chunk)
    monkeypatch.setattr(api, "solve", timed_solve)
    svc = QueryService(tg, slots=2, chunk_steps=1, clock=lambda: now[0])
    assert svc.stats()["waits"] == {"count": 0}
    batched = [svc.submit("bfs", s) for s in (0, 50, 60)]   # 60 refills
    follower = svc.submit("bfs", 50)
    now[0] = 2.0
    svc.run_until_complete()
    t_single = now[0]
    single = svc.submit("pagerank", iters=3)
    now[0] += 0.5
    svc.run_until_complete()
    hit = svc.submit("bfs", 0)
    want = []
    for rid in batched:
        first = min(i for i, c in enumerate(chunks) if rid in c)
        last = max(i for i, c in enumerate(chunks) if rid in c)
        rec = svc.record(rid)
        assert rec.slotted_at == 2.0 + first
        assert rec.finished_at == 3.0 + last
        want.append(((2.0 + first) * 1e3, (last - first + 1) * 1e3))
    assert svc.record(batched[2]).slotted_at > 2.0      # a refill
    rec = svc.record(single)
    assert (rec.slotted_at, rec.finished_at) == (t_single + 0.5,
                                                 t_single + 0.75)
    want.append((500.0, 250.0))
    assert svc.record(follower).slotted_at is None
    assert svc.record(follower).finished_at == \
        svc.record(batched[1]).finished_at
    assert svc.record(hit).cached and svc.record(hit).slotted_at is None
    got = svc.stats()["waits"]
    assert got["count"] == 4
    for q in (50, 95):
        assert got[f"queue_p{q}_ms"] == _rank([w[0] for w in want], q)
        assert got[f"in_slot_p{q}_ms"] == _rank([w[1] for w in want], q)
    # only the newest WAITS_KEPT finished queries are kept
    monkeypatch.setattr(scheduler, "WAITS_KEPT", 2)
    svc = QueryService(tg, clock=lambda: now[0])
    for iters, wait in ((3, 4.0), (4, 1.0), (5, 2.0)):
        svc.submit("pagerank", iters=iters)
        now[0] += wait
        svc.run_until_complete()
    got = svc.stats()["waits"]
    assert got["count"] == 2
    assert (got["queue_p50_ms"], got["queue_p95_ms"]) == (1000.0, 2000.0)


# -- batched PPR's pull and update in one launch (CudaBackend.pull_update)
def _ppr_step_inputs(g, width: int, seed: int):
    """(x, base, rank, resid) of one batched PPR step at ``width``
    columns, ``x`` the program's ``rank / deg``; from three columns on,
    column 0 is frozen (residual below tol) and column 1 carries a NaN."""
    gen = torch.Generator().manual_seed(seed)
    rank = torch.rand((g.n, width), generator=gen)
    base = torch.where(torch.rand((g.n, width), generator=gen) < 0.1,
                       0.15, 0.0)
    resid = torch.rand((width,), generator=gen) + 1e-3
    if width >= 3:
        resid[0] = 1e-7
        rank[g.n // 2, 1] = float("nan")
    x = rank / g.out_deg.clamp(min=1).to(torch.float32)[:, None]
    return x, base, rank, resid


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32)


@pytest.mark.parametrize("width", (1, 3, 64))
@pytest.mark.parametrize("graph", ("erdos_renyi", "star"))
def test_ppr_step_plain_is_the_pull_then_the_update(graph, width):
    """``ell_spmv_ppr_step`` on the CPU against ``ell_spmv_plain`` and
    the batched PPR update as the program wrote it before the fusion
    (damp a float32 tensor), bit for bit: frozen columns keep their
    ranks and residuals, a NaN column's residual is NaN."""
    from repro_torch.graphs import erdos_renyi, star
    from repro_torch.kernels.ell_spmv import (ell_row_plan, ell_spmv_plain,
                                              ell_spmv_ppr_step)
    g = (erdos_renyi(150, 5.0, seed=4, device="cpu") if graph ==
         "erdos_renyi" else star(90, device="cpu"))
    x, base, rank, resid = _ppr_step_inputs(g, width, seed=width)
    damp, tol = 0.85, 1e-6
    plan = ell_row_plan(g.in_deg, g.n, g.d_ell, width)
    got_rank, got_resid = ell_spmv_ppr_step(
        x, g.ell_idx, g.ell_w, base, rank, resid, damp=damp, tol=tol,
        plan=plan)
    msgs = ell_spmv_plain(torch.cat([x, x.new_zeros((1, width))]),
                          g.ell_idx, g.ell_w, "sum", "copy",
                          row_len=g.in_deg)
    active = resid >= tol
    want_rank = torch.where(active[None, :],
                            base + torch.tensor(damp) * msgs, rank)
    want_resid = torch.where(active,
                             (want_rank - rank).abs().amax(dim=0), resid)
    assert torch.equal(_bits(got_rank), _bits(want_rank))
    assert torch.equal(_bits(got_resid), _bits(want_resid))
    if width >= 3:
        assert torch.equal(got_rank[:, 0], rank[:, 0])
        assert got_resid[0] == resid[0] and got_resid[1].isnan()


def _unfused(monkeypatch):
    monkeypatch.setattr(CudaBackend, "pull_update",
                        lambda self, *a, **k: None)


@pytest.mark.parametrize("loop", ("run", "run_stepwise"))
def test_fused_ppr_batch_equals_the_unfused_steps(pair, loop, monkeypatch):
    """``solve_batch(g, "ppr")`` on the CUDA backend's plain versions:
    every step fused (one launch each), and states, steps and ``Cost``
    bit for bit those of the same backend forced to pull and update
    apart; steps and ``Cost`` equal to the ``"ell"`` backend's, states
    to rtol = atol = 1e-5, as the reference comparisons hold them."""
    from repro_torch.obs import Telemetry
    _, tg = pair
    pins = dict(autotune=False, block_n=64, block_e=128, push_block_n=64,
                push_strategy="scan")
    sources = [0, 3, 7, 3, 101]

    def solve(be):
        kw = {} if loop == "run" else {"telemetry": Telemetry()}
        return api.solve_batch(tg, "ppr", sources=sources, backend=be, **kw)
    # run_stepwise takes one step more first, on a copy, and drops it
    warm = 0 if loop == "run" else 1
    be = CudaBackend(**pins)
    got = solve(be)
    assert be.stats["fused_pull_update"] == be.stats["kernel_pull"] \
        == got.steps + warm > warm
    ell = api.solve_batch(tg, "ppr", sources=sources, backend="ell")
    assert got.cost.as_dict() == ell.cost.as_dict()
    assert got.steps == ell.steps
    for k in ell.state:        # the ell pull sums in another order
        torch.testing.assert_close(got.state[k], ell.state[k], rtol=1e-5,
                                   atol=1e-5)
    with monkeypatch.context() as mp:
        _unfused(mp)
        apart = CudaBackend(**pins)
        want = solve(apart)
    assert apart.stats["fused_pull_update"] == 0
    assert apart.stats["kernel_pull"] == want.steps + warm
    assert want.steps == got.steps
    assert got.cost.as_dict() == want.cost.as_dict()
    for k in want.state:
        assert torch.equal(_bits(got.state[k]), _bits(want.state[k])), k


@pytest.mark.parametrize("case", ("ppr_width_65", "bfs"))
def test_other_pulls_are_not_fused(pair, case):
    """A batched BFS pull, and each step of a PPR batch wider than the
    fused step takes while more columns than it takes are active (the
    first step: all are), run the plain full-scan pull: no fused
    launch."""
    _, tg = pair
    be = CudaBackend(autotune=False, block_n=64, block_e=128,
                     push_block_n=64, push_strategy="scan")
    if case == "bfs":
        br = api.solve_batch(tg, "bfs", sources=[0, 3, 7], policy="pull",
                             backend=be)
        assert be.stats["fused_pull_update"] == 0
    else:
        br = api.solve_batch(tg, "ppr", sources=list(range(65)),
                             backend=be, max_steps=1)
        assert be.stats["fused_pull_update"] == 0
        assert be.stats["kernel_pull"] == br.steps == 1
    assert br.steps > 0
    assert be.stats["kernel_pull"] + be.stats["kernel_pull_frontier"] > 0


def test_a_wide_ppr_batch_fuses_the_steps_of_its_last_active_columns(
        monkeypatch):
    """A 100-wide PPR batch whose sources converge at different steps (a
    star's hub and leaves, and vertices of small components): the steps
    with more than 64 active columns pull and update apart, the others
    run the fused step on their active columns alone. Steps, ``Cost``
    and the trace's rows equal the same backend's forced apart; ranks
    and residuals within rtol = atol = 1e-5 (the narrow pull sums each
    column in another order)."""
    from repro_torch.graphs import build_graph
    from repro_torch.obs import Telemetry
    n = 300
    src = [0] * 199 + list(range(1, 200)) + [200, 201, 202, 203]
    dst = list(range(1, 200)) + [0] * 199 + [201, 200, 203, 202]
    g = build_graph(src, dst, n=n, device="cpu")
    sources = list(range(0, 198, 2)) + [200]
    pins = dict(autotune=False, block_n=64, block_e=128, push_block_n=64,
                push_strategy="scan")

    def solve(be):
        tel = Telemetry()
        br = api.solve_batch(g, "ppr", sources=sources, backend=be,
                             telemetry=tel)
        rows = [{k: v for k, v in e.items() if k not in ("ts_us", "us")}
                for e in tel.events if e.get("kind") == "step"]
        return br, rows
    be = CudaBackend(**pins)
    got, got_rows = solve(be)
    with monkeypatch.context() as mp:
        _unfused(mp)
        apart = CudaBackend(**pins)
        want, want_rows = solve(apart)
    assert 0 < be.stats["fused_pull_update"] < be.stats["kernel_pull"]
    assert apart.stats["fused_pull_update"] == 0
    assert got.steps == want.steps and got_rows == want_rows
    assert got.cost.as_dict() == want.cost.as_dict()
    for k in want.state:
        torch.testing.assert_close(got.state[k], want.state[k], rtol=1e-5,
                                   atol=1e-5)


def test_a_narrow_fused_step_leaves_the_callers_state_as_it_was():
    """The narrow fused step of a wide PPR batch writes its ranks into a
    copy of a state the caller handed in (a chunk's first step), and in
    place only into a rank it made itself in the same run: the caller's
    state, and the state a finished chunk returned, are left bit for bit
    as they were when the next chunk starts from them."""
    from repro_torch.graphs import erdos_renyi
    from repro_torch.service.batch import run_chunk
    from repro_torch.service.programs import ppr_batch_init
    g = erdos_renyi(200, 5.0, seed=2, device="cpu")
    width = 100
    state, frontier = ppr_batch_init(g, list(range(width)))
    state["rank"] = state["base"].clone()
    state["resid"][:70] = 0.0                # 30 columns still active
    be = CudaBackend(autotune=False, block_n=64, block_e=128,
                     push_block_n=64, push_strategy="scan")
    kept = {k: v.clone() for k, v in state.items()}
    first, _ = run_chunk(g, "ppr", width, state=state, frontier=frontier,
                         backend=be, max_steps=3)
    assert be.stats["fused_pull_update"] == 3
    for k in kept:
        assert torch.equal(_bits(state[k]), _bits(kept[k])), k
    done = {k: v.clone() for k, v in first.state.items()}
    second, _ = run_chunk(g, "ppr", width, state=first.state,
                          frontier=frontier, backend=be, max_steps=3)
    assert be.stats["fused_pull_update"] == 6
    for k in done:
        assert torch.equal(_bits(first.state[k]), _bits(done[k])), k
    assert not torch.equal(second.state["rank"], first.state["rank"])
