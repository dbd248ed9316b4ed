"""The row layout against the dense ELL.

A graph whose dense ``[n, d_ell]`` ELL would be mostly padding is built
without it (``build_graph``'s ``DENSE_ELL_MAX_PAD`` rule): its pull
kernels read the CSR through the row offsets ``in_ptr``. Both layouts
must give the same pulls, the same ``Cost`` and the same ``StepTrace``
rows. On the plain (CPU) paths the row layout packs each chunk of rows
into the dense shape, so the results are bit for bit the dense ones;
on the card integers, min and max are bit for bit, float sums within
rtol = atol = 1e-5 (another summation order; the tests marked ``cuda``).
The file imports nothing of JAX, so its card tests run on a machine with
the card and no JAX:

    python -m pytest -q -m cuda tests/test_torch_row_layout.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import api
from repro_torch.core import CudaBackend
from repro_torch.core.direction import Direction
from repro_torch.graphs import build_graph, erdos_renyi, kronecker, star
from repro_torch.graphs import structure
from repro_torch.graphs.structure import DENSE_ELL_MAX_PAD, dense_ell
from repro_torch.kernels import tune
from repro_torch.kernels.ell_pull_frontier import (ell_pull_frontier_full,
                                                   ell_pull_frontier_plain,
                                                   frontier_rows)
from repro_torch.kernels.ell_spmv import (PPR_STEP_MAX_WIDTH, ell_row_plan,
                                          ell_spmv, ell_spmv_plain,
                                          ell_spmv_ppr_step,
                                          ell_spmv_ppr_step_plain)
from repro_torch.obs import Telemetry

COMBINES = ("sum", "min", "max")
MSGS = ("copy", "mul", "add")
DTYPES = (torch.float32, torch.float64, torch.int32, torch.int64)
WIDTHS = (1, 8, 256)


@pytest.fixture(autouse=True)
def tune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))
    tune.clear_memory_cache()
    yield
    tune.clear_memory_cache()


def _dense_twin(g):
    """The same edges built with the dense ELL (an explicit d_ell)."""
    return build_graph(g.coo_src.cpu().numpy(), g.coo_dst.cpu().numpy(),
                       n=g.n, weights=g.coo_w.cpu().numpy(), d_ell=g.d_ell,
                       device=g.device)


def _payload(n, width, dtype, seed, device):
    rng = np.random.default_rng(seed)
    shape = (n + 1,) if width == 1 else (n + 1, width)
    if dtype.is_floating_point:
        a = rng.normal(size=shape)
    else:
        a = rng.integers(-50, 50, size=shape)
    x = torch.from_numpy(a).to(dtype).to(device)
    x[-1] = 0
    return x


def _same(got, want, combine, what, exact):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    if not exact and combine == "sum" and got.dtype.is_floating_point:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5,
                                   msg=lambda m: f"{what}: {m}")
    else:
        assert torch.equal(got, want), what


def _both_layouts(g, x, combine, msg, width, exact, seed=0):
    """Every pull entry point on the row layout against the dense one."""
    idx, w = dense_ell(g)
    rows_kw = dict(row_ptr=g.in_ptr, d_ell=g.d_ell)
    tag = f"{x.dtype} {combine}/{msg} w{width}"
    want = ell_spmv_plain(x, idx, w, combine, msg, row_len=g.in_deg)
    _same(ell_spmv_plain(x, g.coo_src, g.coo_w, combine, msg,
                         row_len=g.in_deg, **rows_kw), want, combine,
          "ell_spmv_plain " + tag, True)
    # with the backend's cached plan, and with none (built from row_ptr)
    for plan in (ell_row_plan(g.in_deg, g.n, g.d_ell, width), None):
        got = ell_spmv(x, g.coo_src, g.coo_w, combine, msg, plan=plan,
                       row_ptr=g.in_ptr, d_ell=g.d_ell)
        _same(got, want, combine, "ell_spmv " + tag, exact)
        again = ell_spmv(x, g.coo_src, g.coo_w, combine, msg, plan=plan,
                         row_ptr=g.in_ptr, d_ell=g.d_ell)
        assert torch.equal(got, again), "ell_spmv again " + tag
    gen = torch.Generator().manual_seed(seed)
    touched = (torch.rand(g.n, generator=gen) < 0.3).to(x.device)
    rows = frontier_rows(touched, 64)
    want = ell_pull_frontier_full(x, idx, w, rows, combine, msg,
                                  row_len=g.in_deg)
    _same(ell_pull_frontier_full(x, g.coo_src, g.coo_w, rows, combine, msg,
                                 row_len=g.in_deg, **rows_kw), want, combine,
          "ell_pull_frontier_full " + tag, exact)
    _same(ell_pull_frontier_plain(x, g.coo_src, g.coo_w, rows, combine, msg,
                                  row_len=g.in_deg, **rows_kw),
          ell_pull_frontier_plain(x, idx, w, rows, combine, msg,
                                  row_len=g.in_deg), combine,
          "ell_pull_frontier_plain " + tag, True)
    if (x.dtype, combine, msg) == (torch.float32, "sum", "copy") \
            and width <= PPR_STEP_MAX_WIDTH:
        xs = x[:-1].reshape(g.n, -1).contiguous()
        base = torch.rand(xs.shape, generator=gen).to(x.device)
        rank = torch.rand(xs.shape, generator=gen).to(x.device)
        resid = torch.full((xs.shape[1],), 1.0, device=x.device)
        resid[0] = 0.0                      # a converged column stays
        plan = ell_row_plan(g.in_deg, g.n, g.d_ell, xs.shape[1])
        want = ell_spmv_ppr_step_plain(xs, idx, w, base, rank, resid,
                                       damp=0.85, tol=1e-6,
                                       row_len=g.in_deg)
        got = ell_spmv_ppr_step(xs, g.coo_src, g.coo_w, base, rank, resid,
                                damp=0.85, tol=1e-6, plan=plan,
                                row_ptr=g.in_ptr)
        for a, b, part in zip(got, want, ("rank", "resid")):
            _same(a, b, "sum", f"ell_spmv_ppr_step {part} w{width}", exact)


@pytest.fixture(scope="module")
def hub_graph():
    g = kronecker(8, 4, seed=2, weighted=True, device="cpu")
    assert g.pull_layout == "rows"
    return g


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("msg", MSGS)
@pytest.mark.parametrize("combine", COMBINES)
def test_row_layout_matches_dense_on_the_plain_paths(hub_graph, combine,
                                                     msg, dtype, width):
    x = _payload(hub_graph.n, width, dtype, 7, "cpu")
    _both_layouts(hub_graph, x, combine, msg, width, exact=True)


def test_an_edgeless_graph_pulls_the_identity_on_the_row_layout():
    g = build_graph([], [], n=5, device="cpu")
    assert g.pull_layout == "rows" and g.m == 0
    for combine in COMBINES:
        x = _payload(5, 3, torch.int32, 1, "cpu")
        _both_layouts(g, x, combine, "copy", 3, exact=True)


def test_build_graph_picks_the_layout():
    """Dense while n · d_ell ≤ DENSE_ELL_MAX_PAD · m, else the row
    layout; an explicit d_ell keeps the dense layout."""
    urand = erdos_renyi(512, 16.0, seed=0, device="cpu")   # GAP urand, s9
    assert urand.pull_layout == "dense"
    assert urand.n * urand.d_ell <= DENSE_ELL_MAX_PAD * urand.m
    assert urand.pull_arrays[2] is None
    kron = kronecker(10, 16, seed=0, device="cpu")
    assert kron.pull_layout == "rows"
    assert kron.n * kron.d_ell > DENSE_ELL_MAX_PAD * kron.m
    assert kron.pull_arrays == (kron.coo_src, kron.coo_w, kron.in_ptr)
    assert not kron._dense                  # nothing dense built
    hub = star(300, device="cpu")
    assert hub.pull_layout == "rows" and hub.d_ell == 304
    forced = kronecker(10, 16, seed=0, d_ell=kron.d_ell, device="cpu")
    assert forced.pull_layout == "dense" and forced.d_ell == kron.d_ell
    forced_star = star(300, d_ell=400, device="cpu")
    assert forced_star.pull_layout == "dense"
    assert tuple(forced_star.ell_idx.shape) == (300, 400)


def test_the_dense_view_on_demand_is_todays_matrix(monkeypatch):
    g = kronecker(10, 16, seed=3, weighted=True, device="cpu")
    today = _dense_twin(g)
    assert g.pull_layout == "rows" and today.pull_layout == "dense"
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        idx, w = dense_ell(g)
    names = [e.name for e in prof.events()]
    assert names.count("repro.graph.dense_ell") == 1
    assert torch.equal(idx, today.ell_idx) and torch.equal(w, today.ell_w)
    assert g.ell_idx is idx and g.ell_w is w      # built once
    assert dense_ell(today) == (today.ell_idx, today.ell_w)


def test_a_dense_view_too_large_raises_before_allocating(monkeypatch):
    g = kronecker(10, 16, seed=3, device="cpu")
    monkeypatch.setattr(structure, "_free_bytes", lambda dev: 1 << 20)

    def no_alloc(*a, **k):
        raise AssertionError("allocated before the check")
    monkeypatch.setattr(torch, "full", no_alloc)
    monkeypatch.setattr(torch, "zeros", no_alloc)
    with pytest.raises(ValueError, match=f"{g.n * g.d_ell * 8} bytes"):
        g.ell_idx
    assert not g._dense


@pytest.fixture
def no_dense_view(monkeypatch):
    def refuse(g):
        if g.pull_layout == "rows":
            raise AssertionError("the dense view of a row-layout graph "
                                 "was read")
        return g.dense_idx, g.dense_w
    monkeypatch.setattr(structure, "dense_ell", refuse)


@pytest.mark.parametrize("autotune", (False, True),
                         ids=("pinned", "autotuned"))
def test_cuda_backend_never_reads_the_dense_view(hub_graph, no_dense_view,
                                                 autotune):
    g = hub_graph
    be = (CudaBackend(pull_frontier_cap=1 << 20) if autotune else
          CudaBackend(autotune=False, block_n=64, block_e=128,
                      push_block_n=64, push_strategy="scan",
                      pull_frontier_cap=1 << 20))
    api.solve_batch(g, "ppr", sources=[0, 5, 9], backend=be)       # fused
    api.solve_batch(g, "ppr", sources=list(range(65)), backend=be,
                    iters=3)
    api.solve(g, "bfs", root=1, policy="pull", backend=be)
    api.solve(g, "sssp_delta", source=1, policy="gs", backend=be)
    api.solve(g, "pagerank", policy="pull", backend=be, iters=3)
    touched = torch.zeros(g.n, dtype=torch.bool)
    touched[torch.argsort(g.in_deg)[-3:]] = True        # three hub rows
    out, _ = be.relax(g, torch.arange(g.n, dtype=torch.int32), None,
                      direction=Direction.PULL, combine="min",
                      touched=touched)
    s = be.stats
    assert s["kernel_pull_frontier"] > 0 and s["fused_pull_update"] > 0
    assert s["row_layout_pulls"] == s["kernel_pull"] + \
        s["kernel_pull_frontier"]
    assert s["hub_slots"] > 0 and s["fallback_pull"] == 0


def test_hub_slots_count_the_plans_hub_rows(hub_graph):
    g, dense = hub_graph, _dense_twin(hub_graph)
    for graph in (g, dense):
        be = CudaBackend(autotune=False, block_n=64, block_e=128,
                         push_block_n=64, push_strategy="scan")
        br = api.solve_batch(graph, "ppr", sources=list(range(40)),
                             backend=be, iters=4)
        plan = be.pull_plan(graph, 40)
        lens = graph.in_deg[plan.rows[plan.class_off[4]:].long()]
        assert plan.hub_slots == int(lens.sum()) > 0
        assert be.stats["hub_slots"] == br.steps * plan.hub_slots
        assert be.stats["pull_edges"] == br.steps * graph.m
        assert be.stats["row_layout_pulls"] == (
            br.steps if graph.pull_layout == "rows" else 0)


def _steps(tel):
    return [{k: v for k, v in e.items() if k not in ("ts_us", "us")}
            for e in tel.events if e.get("kind") == "step"]


@pytest.mark.parametrize("algorithm,sources,kw", [
    ("ppr", [0, 5, 9], {}),
    ("ppr", list(range(70)), {"iters": 5}),
    ("bfs", [0, 5, 9, 200], {}),
], ids=("ppr_fused", "ppr_wide", "bfs"))
def test_solve_batch_is_the_same_on_both_layouts(hub_graph, algorithm,
                                                 sources, kw):
    runs = []
    for graph in (hub_graph, _dense_twin(hub_graph)):
        tel = Telemetry()
        be = CudaBackend(autotune=False, block_n=64, block_e=128,
                         push_block_n=64, push_strategy="scan",
                         pull_frontier_cap=1 << 20)
        br = api.solve_batch(graph, algorithm, sources=sources, backend=be,
                             telemetry=tel, **kw)
        runs.append((br, _steps(tel)))
    (a, sa), (b, sb) = runs
    assert (a.steps, a.push_steps) == (b.steps, b.push_steps)
    for x, y in zip(a.states, b.states):
        assert x.keys() == y.keys()
        for k in x:
            assert torch.equal(x[k], y[k]), k
    for f in dataclasses.fields(a.cost):
        assert torch.equal(getattr(a.cost, f.name),
                           getattr(b.cost, f.name)), f.name
    assert sa == sb and sa


# ---------------------------------------------------------------------
# the card
@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def card_graphs(cuda):
    """Row-layout graphs on the card: Kronecker (hub rows cut into
    pieces at width 256), a star whose hub is cut at every width, and a
    graph with no edges."""
    return {"kron": kronecker(11, 16, seed=2, weighted=True, device=cuda),
            "star": star(3 * 4096 + 6, device=cuda),
            "edgeless": build_graph([], [], n=9, device=cuda)}


@pytest.mark.cuda
@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("msg", MSGS)
@pytest.mark.parametrize("combine", COMBINES)
def test_row_layout_kernels_match_dense_on_the_card(card_graphs, combine,
                                                    msg, dtype, width):
    for name, g in card_graphs.items():
        assert g.pull_layout == "rows", name
        x = _payload(g.n, width, dtype, 7, g.device)
        _both_layouts(g, x, combine, msg, width, exact=False)


@pytest.mark.cuda
@pytest.mark.parametrize("width", (1, 3, 33, 64))
def test_row_layout_ppr_step_matches_its_dense_kernel(card_graphs, width):
    """The fused PPR step on the row layout against the dense layout's
    kernel: the ranks within 1e-5, the residuals the largest change."""
    g = card_graphs["kron"]
    idx, w = dense_ell(g)
    gen = torch.Generator(device=g.device).manual_seed(width)
    x = torch.rand((g.n, width), generator=gen, device=g.device)
    base = torch.rand((g.n, width), generator=gen, device=g.device)
    rank = torch.rand((g.n, width), generator=gen, device=g.device)
    resid = torch.ones((width,), device=g.device)
    plan = ell_row_plan(g.in_deg, g.n, g.d_ell, width)
    want = ell_spmv_ppr_step(x, idx, w, base, rank, resid, damp=0.85,
                             tol=1e-6, plan=plan)
    got = ell_spmv_ppr_step(x, g.coo_src, g.coo_w, base, rank, resid,
                            damp=0.85, tol=1e-6, plan=plan,
                            row_ptr=g.in_ptr)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_row_layout_solve_batch_on_the_card(card_graphs):
    g = card_graphs["kron"]
    dense = _dense_twin(g)
    for algorithm, sources in (("ppr", list(range(0, 600, 3))),
                               ("bfs", [0, 5, 9, 300])):
        got = api.solve_batch(g, algorithm, sources=sources, backend="cuda")
        want = api.solve_batch(dense, algorithm, sources=sources,
                               backend="cuda")
        assert got.steps == want.steps
        for x, y in zip(got.states, want.states):
            for k in x:
                if x[k].dtype.is_floating_point and algorithm == "ppr":
                    torch.testing.assert_close(x[k], y[k], rtol=1e-5,
                                               atol=1e-5)
                else:
                    assert torch.equal(x[k], y[k]), k
