"""Slice 7 of the port against the JAX package: the six algorithms that
run on the engine beside BFS, PageRank, PPR and Δ-stepping (WCC,
δ-PageRank, Brandes BC, Boman coloring, Borůvka MST, triangle count),
the engine's ``local_fn`` steps, ``core.linalg``, the PA split and
``pagerank_pa``, the coloring strategies, the legacy wrappers and
``QueryService`` serving the unbatchable algorithms as single solves.

The port's graph carries the reference graph's arrays across. Backends
pair dense↔dense and ell↔ell under every policy, and cuda↔pallas (the
port's kernels' plain versions on the CPU, the reference's Pallas
kernels in interpret mode) under push, pull and GenericSwitch, the
pins of ``test_torch_solve.py``. Integer, min and max state must match
bit for bit, float sums to rtol = atol = 1e-5; the Cost counters,
steps, push steps, epochs, the converged flag and every StepTrace row
(direction, frontier statistics, predictions, counter deltas) exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro.core import MIN_PLUS as REF_MIN_PLUS
from repro.core import OR_AND as REF_OR_AND
from repro.core import PLUS_TIMES as REF_PLUS_TIMES
from repro.core import Cost as RefCost
from repro.core import PallasBackend
from repro.core import spmspv_push as ref_spmspv_push
from repro.core import spmv_pull as ref_spmv_pull
from repro.core import algorithms as ref_algs
from repro.core.algorithms.pagerank import \
    pagerank_pa_prepare as ref_pa_prepare
from repro.core.strategies import greedy_tail_coloring as ref_greedy_tail
from repro.graphs import erdos_renyi as ref_erdos_renyi
from repro.graphs import partition as ref_partition
from repro.service import QueryService as RefQueryService
from repro_torch import api
from repro_torch.core import (MIN_PLUS, OR_AND, PLUS_TIMES, Cost,
                              CudaBackend, spmspv_push, spmv_pull)
from repro_torch.core import algorithms as algs
from repro_torch.core.algorithms.coloring import _fe_coloring
from repro_torch.core.algorithms.pagerank import pagerank_pa_prepare
from repro_torch.core.strategies import greedy_tail_coloring
from repro_torch.graphs import GRAPH_ARRAYS, graph_from_arrays, partition
from repro_torch.service import QueryService

ALGS = {"wcc": {}, "pr_delta": {},
        "betweenness": {"num_sources": 4, "source_offset": 3},
        "coloring": {}, "mst_boruvka": {}, "triangle_count": {}}
POLICIES = ("push", "pull", "gs", "grs", "auto")
CUDA_POLICIES = ("push", "pull", "gs")
TRACE = 32
PINS = dict(autotune=False, block_n=64, block_e=128, push_block_n=64,
            push_strategy="scan")

CASES = [(a, p, b) for a in sorted(ALGS) for p in POLICIES
         for b in ("dense", "ell", "cuda")
         if b != "cuda" or p in CUDA_POLICIES]
# a sparse graph of many components (a forest for MST, sources outside
# the giant component for BC, isolated vertices for WCC)
SPARSE_CASES = [(a, p, b) for a in ("wcc", "betweenness", "mst_boruvka")
                for p in ("push", "pull", "gs") for b in ("dense", "cuda")]


def carry(g):
    return graph_from_arrays({f: np.asarray(getattr(g, f))
                              for f in GRAPH_ARRAYS},
                             n=g.n, m=g.m, d_ell=g.d_ell, device="cpu")


@pytest.fixture(scope="module")
def graphs():
    out = {}
    for name, (avg, seed) in (("er", (4.0, 11)), ("sparse", (0.8, 5))):
        g = ref_erdos_renyi(160, avg, seed=seed, weighted=True)
        out[name] = (g, carry(g))
    return out


@pytest.fixture(scope="module")
def ref_runs(graphs):
    """The reference's solves, run once per (graph, alg, policy,
    backend)."""
    cache = {}

    def run(gname, alg, policy, backend):
        key = (gname, alg, policy, backend)
        if key not in cache:
            be = PallasBackend(**PINS) if backend == "cuda" else backend
            cache[key] = ref_api.solve(graphs[gname][0], alg, policy=policy,
                                       backend=be, trace=TRACE, **ALGS[alg])
        return cache[key]
    return run


def cost_dict(cost) -> dict:
    return {k: int(getattr(cost, k)) for k in Cost.zeros()._fields()}


def assert_leaves(got, want, what=""):
    """Port tensors against reference arrays, leaf by leaf (dicts by
    sorted key): dtype and shape equal; floats to 1e-5, the rest
    exactly."""
    want_leaves = jax.tree_util.tree_leaves(want)
    got_leaves = ([got[k] for k in sorted(got)] if isinstance(got, dict)
                  else [got])
    assert len(got_leaves) == len(want_leaves), what
    for a, b in zip(got_leaves, want_leaves):
        a, b = a.cpu().numpy(), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype,
                                                           b.dtype)
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5,
                                       err_msg=what)
        else:
            np.testing.assert_array_equal(a, b, err_msg=what)


def assert_run(got, want, what=""):
    assert_leaves(got.state, want.state, what)
    assert got.cost.as_dict() == cost_dict(want.cost), what
    assert (got.steps, got.push_steps, got.epochs, got.converged) == (
        int(want.steps), int(want.push_steps), int(want.epochs),
        bool(want.converged)), what
    steps = int(want.steps)
    assert got.trace.as_dict(steps) == want.trace.as_dict(steps), what


def port_backend(name: str):
    return CudaBackend(**PINS) if name == "cuda" else name


@pytest.mark.parametrize("alg,policy,backend", CASES,
                         ids=["-".join(c) for c in CASES])
def test_algorithm_matches_reference(graphs, ref_runs, alg, policy,
                                     backend):
    want = ref_runs("er", alg, policy, backend)
    be = port_backend(backend)
    got = api.solve(graphs["er"][1], alg, policy=policy, backend=be,
                    trace=TRACE, **ALGS[alg])
    assert_run(got, want, f"{alg}/{policy}/{backend}")
    if backend == "cuda":
        s = be.stats
        assert s["fallback_pull"] == s["fallback_push"] == 0
        kernels = (s["kernel_pull"] + s["kernel_pull_frontier"]
                   + s["kernel_push"] + s["skip_empty_pull"])
        # local_fn steps never touch the exchange backend
        local = alg in ("coloring", "mst_boruvka", "triangle_count")
        assert (kernels == 0) == local


@pytest.mark.parametrize("alg,policy,backend", SPARSE_CASES,
                         ids=["-".join(c) for c in SPARSE_CASES])
def test_sparse_graph_matches_reference(graphs, ref_runs, alg, policy,
                                        backend):
    want = ref_runs("sparse", alg, policy, backend)
    got = api.solve(graphs["sparse"][1], alg, policy=policy,
                    backend=port_backend(backend), trace=TRACE, **ALGS[alg])
    assert_run(got, want, f"sparse {alg}/{policy}/{backend}")


def test_all_ten_algorithms_are_registered():
    assert api.algorithms() == ref_api.algorithms()
    for name in api.algorithms():
        mine, ref = api.get_spec(name), ref_api.get_spec(name)
        assert mine.default_policy.name == ref.default_policy.name, name
        assert mine.runtime_keys == ref.runtime_keys, name
        assert mine.paper == ref.paper, name


def test_bc_pulls_sums_through_the_frontier_kernel(graphs):
    """BC's backward pulls (f32 sums over ``level == lvl - 1``) and its
    forward pulls over the unvisited set take the frontier pull where
    the touched rows fit, the full scan where they do not."""
    be = CudaBackend(**PINS)
    api.solve(graphs["er"][1], "betweenness", policy="pull", backend=be,
              **ALGS["betweenness"])
    assert be.stats["kernel_pull_frontier"] > 0
    assert be.stats["kernel_pull"] > 0
    assert be.stats["fallback_pull"] == 0


# -- linalg -------------------------------------------------------------
SEMIRINGS = {"plus_times": (PLUS_TIMES, REF_PLUS_TIMES),
             "min_plus": (MIN_PLUS, REF_MIN_PLUS),
             "or_and": (OR_AND, REF_OR_AND)}


@pytest.mark.parametrize("product", ("pull", "push"))
@pytest.mark.parametrize("sr", sorted(SEMIRINGS))
def test_linalg_matches_reference(graphs, sr, product):
    g, tg = graphs["sparse"]
    mine, ref = SEMIRINGS[sr]
    rng = np.random.default_rng(3)
    x = rng.normal(size=g.n).astype(np.float32)
    nonzero = rng.random(g.n) < 0.3
    if product == "pull":
        want, wcost = ref_spmv_pull(g, jnp.asarray(x), ref)
        got, cost = spmv_pull(tg, torch.from_numpy(x), mine)
    else:
        want, wcost = ref_spmspv_push(g, jnp.asarray(x),
                                      jnp.asarray(nonzero), ref)
        got, cost = spmspv_push(tg, torch.from_numpy(x),
                                torch.from_numpy(nonzero), mine)
    assert_leaves(got, want, f"{sr}/{product}")
    assert cost.as_dict() == cost_dict(wcost)


# -- the PA split and pagerank_pa -----------------------------------------
@pytest.mark.parametrize("n,parts", [(160, 1), (160, 7), (160, 16),
                                     (5, 5)])
def test_partition_1d_matches_reference(n, parts):
    mine, ref = partition.partition_1d(n, parts), \
        ref_partition.partition_1d(n, parts)
    assert (mine.n, mine.num_parts, mine.shard_size, mine.n_padded) == (
        ref.n, ref.num_parts, ref.shard_size, ref.n_padded)
    v = np.arange(n + 3)
    np.testing.assert_array_equal(mine.owner_np(v), ref.owner_np(v))
    np.testing.assert_array_equal(
        mine.owner(torch.from_numpy(v)).numpy(),
        np.asarray(ref.owner(jnp.asarray(v))))


@pytest.mark.parametrize("n,parts", [(4, 0), (4, 5)])
def test_partition_1d_rejects_bad_counts(n, parts):
    with pytest.raises(ValueError, match="num_parts"):
        partition.partition_1d(n, parts)


def assert_edges(mine, ref):
    assert (mine.cap, mine.num_parts) == (ref.cap, ref.num_parts)
    for f in ("src", "dst", "w", "valid", "count"):
        np.testing.assert_array_equal(getattr(mine, f).numpy(),
                                      np.asarray(getattr(ref, f)), f)


@pytest.mark.parametrize("parts,align", [(1, 128), (3, 8), (16, 128)])
def test_pa_split_matches_reference(graphs, parts, align):
    g, tg = graphs["er"]
    local, remote, stats = partition.pa_split(
        tg, partition.partition_1d(g.n, parts), align=align)
    rpart = ref_partition.partition_1d(g.n, parts)
    r_local, r_remote, r_stats = ref_partition.pa_split(g, rpart,
                                                        align=align)
    assert_edges(local, r_local)
    assert_edges(remote, r_remote)
    assert stats == r_stats
    assert_edges(partition.pa_regroup_by_dst(
        partition.partition_1d(g.n, parts), remote, g.n, align=align),
        ref_partition.pa_regroup_by_dst(rpart, r_remote, g.n, align=align))


@pytest.mark.parametrize("parts", (1, 7, 16))
def test_pagerank_pa_matches_reference(graphs, parts):
    g, tg = graphs["er"]
    want = ref_algs.pagerank_pa(g, parts, iters=12)
    got = algs.pagerank_pa(tg, parts, iters=12)
    assert_leaves(got.ranks, want.ranks)
    assert got.cost.as_dict() == cost_dict(want.cost)
    assert got.iterations == want.iterations
    assert pagerank_pa_prepare(tg, parts)[1] == ref_pa_prepare(g, parts)[1]


# -- the coloring strategies ----------------------------------------------
@pytest.mark.parametrize("use_gs", (False, True))
@pytest.mark.parametrize("seed", (0, 7))
def test_fe_coloring_matches_reference(graphs, seed, use_gs):
    """Fed the permutation ``jax.random.permutation`` drew for the
    reference's key, the port's Frontier-Exploit coloring is the
    reference's."""
    g, tg = graphs["er"]
    key = jax.random.PRNGKey(seed)
    want = ref_algs.fe_coloring(g, key, use_gs=use_gs)
    prio = np.asarray(jax.random.permutation(key, g.n)).astype(np.int32)
    got = _fe_coloring(tg, torch.from_numpy(prio), use_gs=use_gs)
    assert_leaves(got.colors, want.colors)
    assert got.cost.as_dict() == cost_dict(want.cost)
    assert got.iterations == int(want.iterations)
    assert int(got.num_colors) == int(want.num_colors)


def test_fe_coloring_draws_from_its_generator(graphs):
    _, tg = graphs["er"]
    runs = [algs.fe_coloring(tg, torch.Generator().manual_seed(s))
            for s in (1, 1, 2)]
    assert torch.equal(runs[0].colors, runs[1].colors)
    for r in runs:
        assert bool(algs.validate_coloring(tg, r.colors))
        assert bool((r.colors > 0).all())


@pytest.mark.parametrize("parts", (4, 16))
def test_conflict_removal_coloring_matches_reference(graphs, parts):
    g, tg = graphs["er"]
    want = ref_algs.conflict_removal_coloring(g, num_parts=parts)
    got = algs.conflict_removal_coloring(tg, num_parts=parts)
    assert_leaves(got.colors, want.colors)
    assert got.cost.as_dict() == cost_dict(want.cost)
    assert bool(algs.validate_coloring(tg, got.colors))


@pytest.mark.parametrize("frac", (0.0, 0.3, 1.0))
def test_greedy_sequential_matches_reference(graphs, frac):
    """Over a mask with some vertices already colored: the port visits
    only the masked uncolored vertices, with the reference's colors and
    Cost; the GrS tail hand-off likewise."""
    g, tg = graphs["er"]
    rng = np.random.default_rng(int(frac * 10))
    mask = rng.random(g.n) < 0.6
    colors0 = np.where(rng.random(g.n) < frac, 3, 0).astype(np.int32)
    want, wcost = ref_algs.greedy_sequential(
        g, jnp.asarray(colors0), jnp.asarray(mask), 64, RefCost())
    got, cost = algs.greedy_sequential(
        tg, torch.from_numpy(colors0), torch.from_numpy(mask), 64,
        Cost.zeros())
    assert_leaves(got, want)
    assert cost.as_dict() == cost_dict(wcost)
    want, wcost = ref_greedy_tail(g, jnp.asarray(colors0), 64, RefCost())
    got, cost = greedy_tail_coloring(tg, torch.from_numpy(colors0), 64,
                                     Cost.zeros())
    assert_leaves(got, want)
    assert cost.as_dict() == cost_dict(wcost)


@pytest.mark.parametrize("n", (100, 160))
def test_phase1_lanes_past_n_match_reference(n):
    """n = 100 over 16 parts (shards of 7) leaves whole lanes past n,
    which the reference's scatter writes after the last real one."""
    g = ref_erdos_renyi(n, 3.0, seed=2, weighted=True)
    tg = carry(g)
    want = ref_api.solve(g, "coloring", policy="push")
    got = api.solve(tg, "coloring", policy="push")
    assert_leaves(got.state, want.state)
    assert got.cost.as_dict() == cost_dict(want.cost)
    assert got.epochs == int(want.epochs)


def test_validate_coloring_matches_reference(graphs):
    g, tg = graphs["er"]
    good = api.solve(tg, "coloring").state["colors"]
    bad = good.clone()
    bad[int(tg.coo_dst[0])] = bad[int(tg.coo_src[0])]
    for colors in (good, bad, torch.zeros_like(good)):
        assert bool(algs.validate_coloring(tg, colors)) == bool(
            ref_algs.validate_coloring(g, jnp.asarray(colors.numpy())))


# -- legacy wrappers ------------------------------------------------------
LEGACY = {
    "wcc": lambda m, g: m.wcc(g),
    "pagerank_delta": lambda m, g: m.pagerank_delta(g, direction="pull"),
    "betweenness_centrality": lambda m, g: m.betweenness_centrality(
        g, num_sources=3),
    "boman_coloring": lambda m, g: m.boman_coloring(g, direction="pull"),
    "boruvka_mst": lambda m, g: m.boruvka_mst(g),
    "triangle_count": lambda m, g: m.triangle_count(g, direction="push"),
    "pagerank": lambda m, g: m.pagerank(g, iters=5, use_ell=True),
}


@pytest.mark.parametrize("name", sorted(LEGACY))
def test_legacy_wrappers_match_reference(graphs, name):
    g, tg = graphs["sparse"]
    want = LEGACY[name](ref_algs, g)
    got = LEGACY[name](algs, tg)
    assert type(got).__name__ == type(want).__name__
    for field in want._fields:
        a, b = getattr(got, field), getattr(want, field)
        if field == "cost":
            assert a.as_dict() == cost_dict(b)
        elif isinstance(a, torch.Tensor):
            assert_leaves(a, b, field)
        else:
            assert a == int(b), field


# -- QueryService ---------------------------------------------------------
def test_query_service_serves_single_solves_like_reference(graphs):
    """``wcc`` and ``triangle_count`` have no batched program: the
    service runs each as one solve, caches it, and coalesces a repeat."""
    g, tg = graphs["sparse"]
    out = []
    for cls, graph in ((RefQueryService, g), (QueryService, tg)):
        svc = cls(graph, slots=2)
        rids = [svc.submit("wcc"), svc.submit("triangle_count"),
                svc.submit("wcc", policy="push"), svc.submit("wcc")]
        svc.run_until_complete()
        again = svc.submit("triangle_count")
        recs = [svc.record(r) for r in rids + [again]]
        stats = svc.stats()
        out.append(([(r.state, r.cached, r.converged) for r in recs],
                    {k: stats[k] for k in ("submitted", "coalesced",
                                           "batches_started", "pending")},
                    stats["cache"]))
    (want, wstats, wcache), (got, gstats, gcache) = out
    for (gs, gc, gv), (ws, wc, wv) in zip(got, want):
        if not isinstance(ws, dict):
            gs, ws = {"labels": gs}, {"labels": ws}
        assert_leaves(gs, jax.device_get(ws))
        assert (gc, gv) == (wc, wv)
    assert got[-1][1] is True
    assert gstats == wstats and gcache == wcache
