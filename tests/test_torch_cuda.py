"""The port's CUDA kernels against their plain PyTorch versions, on the
card.

Every test here needs a CUDA device (marker ``cuda``) and skips where
there is none. The file imports nothing of JAX, so it runs on a machine
with the card and no JAX:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

The ``hub`` case (12,293 in-edges on one destination) splits the
full-scan pull's hub row across CTAs at every payload width and the
scan push's bins across units; both must also give the same bits when
called again (the last-arriving CTA resets its counter).

Tolerances: integers, min and max bit for bit; float sums rtol = atol =
1e-5 (the kernels sum floats in float64 in another order than the plain
versions). The model kernels, as ``tests/test_kernels.py`` holds the
Pallas ones: flash attention rtol = atol = 3e-4 in f32 and 2e-2 in bf16
(the kernel feeds P to P·V in bf16, the plain version keeps it f32);
the CIN layer rtol = atol = 2e-4 in f32 (both sum in f32, in other
orders) and 2e-2 in bf16 (the output rounds to bf16).
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from repro_torch import api
from repro_torch.graphs import erdos_renyi, standin, star
from repro_torch.graphs.structure import pad_values
from repro_torch.kernels import _build, tune
from repro_torch.kernels.coo_push import (build_push_plan, coo_push,
                                          coo_push_plain)
from repro_torch.kernels.ell_pull_frontier import (ell_pull_frontier,
                                                   ell_pull_frontier_full,
                                                   ell_pull_frontier_plain,
                                                   frontier_rows)
from repro_torch.kernels.ell_spmv import (ell_row_plan, ell_spmv,
                                          ell_spmv_plain, ell_spmv_ppr_step,
                                          ell_spmv_ppr_step_plain,
                                          ppr_update)
from repro_torch.kernels import cin as cin_mod
from repro_torch.kernels.cin import (cin_dx0, cin_dx0_plain, cin_layer,
                                     cin_layer_plain, cin_weight_grad,
                                     cin_weight_grad_plain)
from repro_torch.kernels.flash_attention import (GLOBAL_WINDOW, HEAD_DIMS,
                                                 flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_fwd,
                                                 flash_attention_plain_gqa)
from repro_torch.core.primitives import mask_untouched

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def tune_cache(tmp_path, monkeypatch):
    """The autotuned backends write their cache under ``tmp_path``."""
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))
    tune.clear_memory_cache()
    yield
    tune.clear_memory_cache()


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def graphs(cuda):
    return cs.small_graphs(cuda)


@pytest.mark.parametrize("dtype", cs.DTYPES, ids=str)
@pytest.mark.parametrize("combine", cs.COMBINES)
@pytest.mark.parametrize("case", cs.SMALL_CASES)
def test_kernels_match_plain(graphs, cuda, case, combine, dtype):
    g = graphs[case]
    gen = torch.Generator(device=cuda).manual_seed(3)
    rows = frontier_rows(torch.rand(g.n, generator=gen, device=cuda) < 0.3,
                         16)
    active = torch.rand(g.n, generator=gen, device=cuda) < 0.5
    plan = (build_push_plan(g.coo_src, g.coo_dst, g.coo_w, g.n, 8)
            if g.m else None)
    for i, (msg, width) in enumerate((m, w) for m in cs.MSGS
                                     for w in cs.WIDTHS):
        shape = (g.n + 1,) + (() if width is None else (width,))
        x = cs.payload(shape, dtype, i, cuda)
        x[-1] = 0
        tag = f"{msg}/w{width}"
        cs.max_abs_err(ell_spmv(x, g.ell_idx, g.ell_w, combine, msg),
                       ell_spmv_plain(x, g.ell_idx, g.ell_w, combine, msg),
                       combine, "ell_spmv " + tag)
        cs.max_abs_err(
            ell_pull_frontier(x, g.ell_idx, g.ell_w, rows, combine, msg),
            ell_pull_frontier_plain(x, g.ell_idx, g.ell_w, rows, combine,
                                    msg), combine, "ell_pull_frontier " + tag)
        got = coo_push(x[:-1], active, g.coo_src, g.coo_dst, g.coo_w, g.n,
                       combine, msg, plan=plan)
        if plan is not None:
            cs.max_abs_err(got, coo_push_plain(x[:-1], active, plan, g.n,
                                               combine, msg),
                           combine, "coo_push " + tag)


def test_each_wrapper_counts_its_launches(graphs, cuda):
    g = graphs["ragged"]
    x = pad_values(torch.ones(g.n, device=cuda))
    rows = frontier_rows(torch.ones(g.n, dtype=torch.bool, device=cuda), 32)
    active = torch.ones(g.n, dtype=torch.bool, device=cuda)
    before = _build.launch_counts()
    ell_spmv(x, g.ell_idx, g.ell_w)
    ell_pull_frontier(x, g.ell_idx, g.ell_w, rows)
    coo_push(x[:-1], active, g.coo_src, g.coo_dst, g.coo_w, g.n)
    coo_push(x[:-1], active, g.coo_src, g.coo_dst, g.coo_w, g.n,
             strategy="mxu")
    q = torch.ones((1, 8, 2, 16), device=cuda)
    out, lse = flash_attention_fwd(q, q, q, want_lse=True)
    flash_attention_bwd(q, q, q, out, lse, q)
    xk = torch.ones((3, 4, 5), device=cuda)
    cin_layer(xk, xk, torch.ones((2, 4, 4), device=cuda))
    g = torch.ones((3, 2, 5), device=cuda)
    cin_weight_grad(g, xk, xk)
    cin_dx0(g, xk, torch.ones((2, 4, 4), device=cuda))
    r = torch.ones((3, 2), device=cuda)
    ell_spmv_ppr_step(r, r.new_zeros((3, 4), dtype=torch.int32),
                      r.new_zeros((3, 4)), r, r, r[0], damp=0.85, tol=1e-6)
    after = _build.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "ell_spmv": 1, "ell_spmv_ppr": 1, "ell_pull_frontier": 1,
        "coo_push": 1,
        "coo_push_mxu": 1, "flash_attention": 1, "flash_attention_bwd": 1,
        "cin": 1, "cin_dw": 1, "cin_dx0": 1}


def test_frontier_full_equals_masked_full_scan(cuda):
    g = erdos_renyi(3000, 6.0, seed=2, weighted=True, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(4)
    x = pad_values(torch.rand(g.n, generator=gen, device=cuda))
    touched = torch.rand(g.n, generator=gen, device=cuda) < 0.1
    for combine in cs.COMBINES:
        full = ell_pull_frontier_full(x, g.ell_idx, g.ell_w,
                                      frontier_rows(touched, 512),
                                      combine=combine, msg="add")
        want = mask_untouched(ell_spmv(x, g.ell_idx, g.ell_w, combine,
                                       "add"), touched, combine)
        cs.max_abs_err(full, want, combine, f"_full {combine}")


@pytest.mark.parametrize("alg,kw", [("bfs", {"root": 5}),
                                    ("pagerank", {"iters": 8}),
                                    ("sssp_delta", {"source": 5,
                                                    "delta": 4.0})])
@pytest.mark.parametrize("policy", ("push", "pull", "gs", "grs", "auto"))
def test_cuda_solve_matches_dense_on_card(cuda, alg, kw, policy):
    g = standin("rca", scale=1 / 256, weighted=True, device=cuda)
    be = api.CudaBackend()
    got = api.solve(g, alg, policy=policy, backend=be, **kw)
    want = api.solve(g, alg, policy=policy, backend="dense", **kw)
    gs = got.state if isinstance(got.state, dict) else {"r": got.state}
    ws = want.state if isinstance(want.state, dict) else {"r": want.state}
    for k in ws:
        cs.max_abs_err(gs[k], ws[k], "sum" if alg == "pagerank" else "min",
                       f"{alg}/{policy} {k}")
    assert be.stats["fallback_pull"] == be.stats["fallback_push"] == 0
    assert got.steps == want.steps and got.converged == want.converged


@pytest.mark.parametrize("batch", (None, 3, 8, 16, 32, 33, 64, 130),
                         ids=lambda b: f"B{b}")
@pytest.mark.parametrize("case", ("ragged", "duplicate_edges", "empty_rows",
                                  "star", "dead", "hub"))
def test_mxu_push_matches_plain(graphs, cuda, case, batch):
    """The one-hot push against its plain versions (``cs.mxu_err``: float
    sums against the float64 plain sum, each destination within 2 ·
    2^-24 · Σ|terms| of the float64 sum, on absolute payloads against
    the float32 one-hot plain version, and on the signed ones within the
    plain version's own gap to the float64 sum plus 1e-5 (1 + |sum|);
    everything else bit for bit) over combine × dtype × msg (float sums
    on the tensor cores; min, max, integer and float64 sums through the
    window reduce), with bins of 8, 100 and 256 and units of 64 (256
    edges, the least) and 4,096 slots; payload widths from one column to
    32 in one launch and 33, 64 and 130 in slices of 32. ``star`` has
    one hub taking every edge of its bin, so its
    tile is cut across several units at block_e 64; ``empty_rows`` has
    bins with no edge; ``dead`` is the ragged graph with no active
    source, so no bin has a live edge; ``hub`` has a destination of
    12,293 in-edges, the shape of a power-law hub under the window
    reduce. Calling again gives the same bits."""
    g = star(3000, device=cuda) if case == "star" else graphs[
        "ragged" if case == "dead" else case]
    gen = torch.Generator(device=cuda).manual_seed(6)
    active = torch.rand(g.n, generator=gen, device=cuda) < 0.7
    if case == "dead":
        active[:] = False
    for bin_n in (8, 100, 256):
        plan = build_push_plan(g.coo_src, g.coo_dst, g.coo_w, g.n, bin_n)
        for i, (dtype, combine, msg) in enumerate(
                (d, c, m) for d in cs.DTYPES for c in cs.COMBINES
                for m in cs.MSGS):
            shape = (g.n,) + (() if batch is None else (batch,))
            x = cs.payload(shape, dtype, i, cuda)
            for block_e in (64, 4096):
                cs.mxu_err(x, active, g, plan, combine, msg, block_e,
                           f"mxu {case} bin {bin_n} {dtype} {combine} "
                           f"{msg} be {block_e}")
                got = coo_push(x, active, g.coo_src, g.coo_dst, g.coo_w,
                               g.n, combine, msg, plan=plan,
                               strategy="mxu", block_e=block_e)
                again = coo_push(x, active, g.coo_src, g.coo_dst, g.coo_w,
                                 g.n, combine, msg, plan=plan,
                                 strategy="mxu", block_e=block_e)
                assert torch.equal(got, again)


def test_mxu_push_refuses_wide_bins(graphs, cuda):
    g = graphs["ragged"]
    plan = build_push_plan(g.coo_src, g.coo_dst, g.coo_w, g.n, 512)
    x = torch.ones(g.n, device=cuda)
    active = torch.ones(g.n, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="at most 256"):
        coo_push(x, active, g.coo_src, g.coo_dst, g.coo_w, g.n, plan=plan,
                 strategy="mxu")


@pytest.mark.parametrize("batch", (None, 16), ids=lambda b: f"B{b}")
@pytest.mark.parametrize("msg", ("copy", "mul"))
def test_push_holds_a_signed_cancelling_bin(cuda, msg, batch):
    """One bin whose terms cancel: vertex 0 takes 1,024 in-edges whose
    messages are +2^14, a term of ~1e-2, -2^14 (the same weight as its
    +2^14), another small term, and so on. The scan push holds 1e-5 of
    the float64 sum; the one-hot push holds ``cs.mxu_err``: 1e-5 of the
    float64 sum and, per element, ``|kernel - plain| <= |plain - f64| +
    1e-5 (1 + |f64|)`` (its four aligned parts sum exactly on the tensor
    cores; a split relative to each message's exponent left 5e-3 here).
    Units of 64 and 1,024 slots."""
    gen = torch.Generator(device="cpu").manual_seed(31)
    n, deg = 2048, 1024
    src = torch.arange(1, deg + 1)
    w = torch.rand(deg, generator=gen) * 1.5 + 0.5
    neg = torch.nonzero(src % 4 == 3).flatten()
    w[neg] = w[neg - 2]
    g = cs.build_graph(src.numpy(), torch.zeros(deg, dtype=torch.long)
                       .numpy(), n=n, weights=w.numpy(), device=cuda)
    shape = (n,) if batch is None else (n, batch)
    ids = torch.arange(n).reshape((n,) + (1,) * (len(shape) - 1))
    x = torch.randn(shape, generator=gen) * 1e-2
    x = torch.where(ids % 4 == 1, 2.0 ** 14, x)
    x = torch.where(ids % 4 == 3, -2.0 ** 14, x).to(cuda)
    active = torch.ones(n, dtype=torch.bool, device=cuda)
    plan = build_push_plan(g.coo_src, g.coo_dst, g.coo_w, g.n, 8)
    exact = coo_push_plain(x, active, plan, n, "sum", msg)
    assert float(exact.abs()[0].max()) < 1.0
    for block_e in (64, 1024):
        scan = coo_push(x, active, g.coo_src, g.coo_dst, g.coo_w, n, "sum",
                        msg, plan=plan, strategy="scan", block_e=block_e)
        cs.max_abs_err(scan, exact, "sum", f"scan be {block_e}")
        cs.mxu_err(x, active, g, plan, "sum", msg, block_e,
                   f"cancelling bin {msg} B{batch} be {block_e}")


@pytest.mark.parametrize("batch", (None, 16), ids=lambda b: f"B{b}")
@pytest.mark.parametrize("msg", ("copy", "mul"))
def test_push_keeps_each_destination_relative(cuda, msg, batch):
    """Rows of one tile whose terms lie far apart: destination d takes
    in-edges only from sources of its class d % 4, whose payloads are
    2^-60, 2^-20, 2^20 or 2^60 times a normal value times 2^k (k in
    -15 .. 15), so a column spans about 2^150 and each row about 2^30;
    destination 0 also takes 5,000 in-edges of every class (several
    chunks and units). ``cs.mxu_err`` holds every destination within
    2 · 2^-24 · Σ|terms| of the float64 sum (a scale for the whole
    column lost the small rows' every bit) and within the float32 plain
    version's own gap plus 1e-5 (1 + |sum|). Bins of 8 and 256, units of
    64 and 1,024 slots."""
    rng = np.random.default_rng(37)
    n = 4096
    deg = rng.integers(1, 40, size=n)
    dst = np.repeat(np.arange(n), deg)
    src = rng.integers(0, n // 4, size=dst.size) * 4 + dst % 4
    src = np.concatenate([src, rng.integers(0, n, size=5000)])
    dst = np.concatenate([dst, np.zeros(5000, np.int64)])
    w = rng.uniform(0.5, 2.0, size=src.size)
    g = cs.build_graph(src, dst, n=n, weights=w, device=cuda)
    shape = (n,) if batch is None else (n, batch)
    ids = np.arange(n).reshape((n,) + (1,) * (len(shape) - 1))
    x = (rng.normal(size=shape) * np.exp2(40.0 * (ids % 4) - 60.0)
         * np.exp2(rng.integers(-15, 16, size=shape)))
    x = torch.from_numpy(x).to(torch.float32).to(cuda)
    active = torch.from_numpy(rng.random(n) < 0.8).to(cuda)
    for bin_n in (8, 256):
        plan = build_push_plan(g.coo_src, g.coo_dst, g.coo_w, g.n, bin_n)
        for block_e in (64, 1024):
            cs.mxu_err(x, active, g, plan, "sum", msg, block_e,
                       f"classes {msg} B{batch} bin {bin_n} be {block_e}",
                       spread=True)


@pytest.mark.parametrize("strategy", ("scan", "mxu"))
@pytest.mark.parametrize("alg,kw,key", [("bfs", {}, "root"),
                                        ("sssp_delta", {"delta": 4.0},
                                         "source"),
                                        ("ppr", {}, "source")])
def test_batched_solve_equals_single_source_on_card(cuda, alg, kw, key,
                                                    strategy):
    g = standin("rca", scale=1 / 256, weighted=True, device=cuda)
    sources = [0, 17, 300, 17, 4000]
    be = api.CudaBackend(push_strategy=strategy, autotune=False)
    br = api.solve_batch(g, alg, sources=sources, policy="push",
                         backend=be, **kw)
    for i, s in enumerate(sources):
        one = api.solve(g, alg, policy="push", backend=be, **{key: s}, **kw)
        for k, want in one.state.items():
            cs.max_abs_err(br.states[i][k], want,
                           "sum" if alg == "ppr" else "min",
                           f"{alg}/{strategy} source {s} {k}")
    assert be.stats["fallback_pull"] == be.stats["fallback_push"] == 0
    assert bool(br.done.all())


SLICE7 = [("wcc", {}), ("pr_delta", {"tol": 1e-7}),
          ("betweenness", {"num_sources": 4, "source_offset": 7}),
          ("coloring", {}), ("mst_boruvka", {}), ("triangle_count", {})]


@pytest.mark.parametrize("alg,kw", SLICE7, ids=[a for a, _ in SLICE7])
@pytest.mark.parametrize("policy", ("push", "pull", "gs"))
def test_slice7_solve_matches_dense_on_card(cuda, alg, kw, policy):
    """Each algorithm of slice 7 through the CUDA backend against the
    dense backend, both on the card, on a sparse random graph with
    several components. Integers bit for bit; BC's float sums to rtol =
    atol = 1e-5 of its largest value (σ and δ are summed in other
    orders); δ-PageRank's ranks to the L1 gap two runs of its tolerance
    may leave, 2 n tol / (1 - damp), since the dense backend's atomic
    float sums may flip a residual at the tolerance and with it the
    steps. The exchange algorithms launch kernels and never fall back;
    the local-step ones touch no backend."""
    g = erdos_renyi(3000, 1.5, seed=4, weighted=True, device=cuda)
    be = api.CudaBackend()
    got = api.solve(g, alg, policy=policy, backend=be, **kw)
    want = api.solve(g, alg, policy=policy, backend="dense", **kw)
    gs, ws = ((r.state if isinstance(r.state, dict) else {"labels": r.state})
              for r in (got, want))
    for k, b in ws.items():
        a = gs[k]
        assert a.dtype == b.dtype and a.shape == b.shape, k
        if alg == "pr_delta":
            gap = float((a.double() - b.double()).abs().sum())
            assert gap <= 2 * g.n * kw["tol"] / 0.15, (k, gap)
        elif a.dtype.is_floating_point:
            scale = max(float(b.abs().max()), 1.0)
            torch.testing.assert_close(a / scale, b / scale, rtol=1e-5,
                                       atol=1e-5)
        else:
            assert torch.equal(a, b), f"{alg}/{policy} {k}"
    if alg != "pr_delta":
        assert (got.steps, got.epochs, got.converged) == (
            want.steps, want.epochs, want.converged)
    assert got.converged and got.steps > 0
    s = be.stats
    assert s["fallback_pull"] == s["fallback_push"] == 0
    kernels = s["kernel_pull"] + s["kernel_pull_frontier"] + s["kernel_push"]
    if alg in ("coloring", "mst_boruvka", "triangle_count"):
        assert kernels == 0 and s["skip_empty_pull"] == 0
    else:
        assert kernels > 0


def normal(shape, seed: int, device, dtype=torch.float32) -> torch.Tensor:
    return cs.normal(shape, torch.Generator(device=device).manual_seed(seed),
                     dtype)


@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float32), ids=str)
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("T,group,window,softcap", [
    (1, 1, GLOBAL_WINDOW, 0.0), (63, 2, GLOBAL_WINDOW, 50.0),
    (130, 4, 17, 0.0), (200, 2, 64, 30.0),
    (63, 4, GLOBAL_WINDOW, 50.0), (129, 8, 17, 0.0), (300, 1, 128, 30.0),
    (300, 4, GLOBAL_WINDOW, 0.0), (130, 8, 64, 50.0)])
def test_flash_attention_matches_plain(cuda, dtype, d, T, group, window,
                                       softcap):
    """Every head dim; ragged T (1, 63, 129, 130, 200, 300 against the
    bf16 kernel's 128-row query tiles and 64- or 128-key tiles); GQA
    groups 1, 2 (gemma2-9b's), 4 (llama3.2-1b's) and 8; windows shorter
    than a tile and equal to one; soft-capping."""
    B, Hk = 2, 2
    q = normal((B, T, Hk * group, d), 1, cuda, dtype)
    k = normal((B, T, Hk, d), 2, cuda, dtype)
    v = normal((B, T, Hk, d), 3, cuda, dtype)
    got = flash_attention(q, k, v, window, softcap)
    want = flash_attention_plain_gqa(q, k, v, window, softcap)
    assert got.dtype == want.dtype and got.shape == want.shape
    tol = 2e-2 if dtype == torch.bfloat16 else 3e-4
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_flash_attention_refuses_what_it_has_no_instance_for(cuda):
    q = torch.ones((1, 8, 2, 24), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="bf16 or f32"):
        flash_attention(q[..., :16].half(), q[..., :16].half(),
                        q[..., :16].half())


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16), ids=str)
@pytest.mark.parametrize("B", (1, 37, 300))
@pytest.mark.parametrize("Hp,F,H,D", [(39, 39, 200, 10), (200, 39, 200, 10),
                                      (5, 4, 7, 6), (200, 39, 70, 10),
                                      (13, 9, 37, 3)])
def test_cin_layer_matches_plain(cuda, dtype, B, Hp, F, H, D):
    """Ragged B against the 128-column tile (columns are b * D + d), the
    first layer's shape (Hp = F), the later layers' (Hp = 200, on the
    product width N = 200 that fits H), and odd H on the general width
    (7 and 37 in one tile of 64, 70 in two); F = 39, 4 and 9 padded to
    a multiple of 8. Few columns (B = 1, 37) split K over several CTAs
    (up to 31 ranges at B = 1), 300 rows do not."""
    xk = normal((B, Hp, D), 4, cuda, dtype)
    x0 = normal((B, F, D), 5, cuda, dtype)
    w = (normal((H, Hp, F), 6, cuda) * (2.0 / (Hp * F)) ** 0.5).to(dtype)
    got = cin_layer(xk, x0, w)
    want = cin_layer_plain(xk, x0, w)
    assert got.dtype == want.dtype and got.shape == want.shape
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-4
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("width", (None, 16, 32, 33), ids=lambda b: f"B{b}")
def test_ell_spmv_hub_plan_matches_plain(graphs, cuda, width):
    """The row plan at widths whose column lanes (1, 16, 32, 32 over two
    tiles) give hub pieces of 8,192, 512 and 256 slots."""
    g = graphs["hub"]
    plan = ell_row_plan(g.in_deg, g.n, g.d_ell, width or 1)
    assert plan.pieces > plan.counters.shape[0]          # a split hub
    for i, (dtype, combine, msg) in enumerate(
            (d, c, m) for d in cs.DTYPES for c in cs.COMBINES
            for m in ("copy", "mul")):
        shape = (g.n + 1,) + (() if width is None else (width,))
        x = cs.payload(shape, dtype, i, cuda)
        x[-1] = 0
        want = ell_spmv_plain(x, g.ell_idx, g.ell_w, combine, msg,
                              row_len=g.in_deg)
        for block_n in (8, 128):
            got = ell_spmv(x, g.ell_idx, g.ell_w, combine, msg,
                           block_n=block_n, row_len=g.in_deg, plan=plan)
            cs.max_abs_err(got, want, combine,
                           f"ell_spmv hub B{width} {dtype} {combine} {msg} "
                           f"block_n {block_n}")
            again = ell_spmv(x, g.ell_idx, g.ell_w, combine, msg,
                             block_n=block_n, row_len=g.in_deg, plan=plan)
            assert torch.equal(got, again)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32)


def _ppr_step_case(g, width: int, seed: int, cuda, dyadic: bool):
    """(x, base, rank, resid) of one batched PPR step on ``g``; with
    ``dyadic`` every value is a small multiple of 2^-10, so that the
    float64 sums are exact in any order. From three columns on, column 0
    is frozen (residual below tol) and column 1 carries a NaN."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    shape = (g.n, width)
    if dyadic:
        rank = torch.randint(0, 64, shape, generator=gen, device=cuda) / 1024
    else:
        rank = torch.rand(shape, generator=gen, device=cuda)
    base = torch.where(torch.rand(shape, generator=gen, device=cuda) < 0.2,
                       0.15, 0.0)
    resid = torch.rand((width,), generator=gen, device=cuda) + 1e-3
    if width >= 3:
        resid[0] = 1e-7
        rank[g.n // 3 + 1, 1] = float("nan")
    x = rank / g.out_deg.clamp(min=1).to(torch.float32)[:, None]
    if dyadic:
        x = rank
    return x, base, rank, resid


@pytest.mark.parametrize("width", (1, 3, 8, 33, 64), ids=lambda b: f"B{b}")
@pytest.mark.parametrize("case", ("hub", "dense"))
def test_ppr_step_kernel_matches_plain(graphs, cuda, case, width):
    """The fused PPR step on the hub graph (its hub split into pieces at
    every width) and on a graph of in-degree about 40 (every row longer
    than 32 slots a one-piece hub at 32 column lanes): on dyadic
    payloads bit for bit its plain version, on random ones bit for bit
    ``ell_spmv`` then ``ppr_update``; the same bits when called again
    (the hub counters reset themselves)."""
    g = (graphs["hub"] if case == "hub"
         else erdos_renyi(300, 20.0, seed=5, device=cuda))
    plan = ell_row_plan(g.in_deg, g.n, g.d_ell, width)
    if case == "hub":
        assert plan.pieces > plan.counters.shape[0]      # a split hub
    elif width > 16:
        assert plan.pieces == plan.counters.shape[0] > 100
    damp, tol = 0.85, 1e-6
    for dyadic in (True, False):
        x, base, rank, resid = _ppr_step_case(g, width, width, cuda, dyadic)
        if dyadic:
            want = ell_spmv_ppr_step_plain(x, g.ell_idx, g.ell_w, base,
                                           rank, resid, damp=damp, tol=tol,
                                           row_len=g.in_deg)
        else:
            msgs = ell_spmv(pad_values(x), g.ell_idx, g.ell_w, "sum",
                            "copy", row_len=g.in_deg, plan=plan)
            want = ppr_update(base, rank, resid, msgs, damp, tol)
        for _ in range(2):
            for block_n in (8, 128):
                got = ell_spmv_ppr_step(x, g.ell_idx, g.ell_w, base, rank,
                                        resid, damp=damp, tol=tol,
                                        block_n=block_n, plan=plan)
                for a, b in zip(got, want):
                    assert torch.equal(_bits(a), _bits(b)), (dyadic,
                                                             block_n)
        if width >= 3:
            assert got[1][1].isnan() and got[1][0] == resid[0]


@pytest.mark.parametrize("loop", ("run", "run_stepwise"))
def test_fused_ppr_batch_equals_the_unfused_steps_on_card(cuda, loop,
                                                         monkeypatch):
    """``solve_batch(g, "ppr")`` on the card at widths 64 and 3 (and a
    star, whose hub row is split at width 64): fused, one launch a step,
    against the same backend forced to pull and update apart, states,
    steps and ``Cost`` bit for bit."""
    from repro_torch.core import CudaBackend
    from repro_torch.obs import Telemetry
    pins = dict(autotune=False, block_n=1024, block_e=1024,
                push_block_n=1024, push_strategy="scan")
    cases = [(erdos_renyi(20000, 12.0, seed=3, device=cuda), 64),
             (erdos_renyi(20000, 12.0, seed=3, device=cuda), 3),
             (star(5000, device=cuda), 64)]
    for g, width in cases:
        sources = list(range(1, 2 * width, 2))

        def solve(be):
            kw = {} if loop == "run" else {"telemetry": Telemetry()}
            return api.solve_batch(g, "ppr", sources=sources, backend=be,
                                   **kw)
        fused = CudaBackend(**pins)
        _build.reset_launch_counts()
        got = solve(fused)
        launches = _build.launch_counts()
        assert launches["ell_spmv_ppr"] == fused.stats[
            "fused_pull_update"] == fused.stats["kernel_pull"] > 0
        assert launches["ell_spmv"] == 0
        with monkeypatch.context() as mp:
            mp.setattr(CudaBackend, "pull_update",
                       lambda self, *a, **k: None)
            apart = CudaBackend(**pins)
            want = solve(apart)
        assert apart.stats["fused_pull_update"] == 0
        assert (got.steps, got.cost.as_dict()) == (want.steps,
                                                   want.cost.as_dict())
        for k in want.state:
            assert torch.equal(_bits(got.state[k]), _bits(want.state[k])), k


# registers and spill bytes of the float32 sum/copy ell_spmv_kernel
# instance (the one PPR's unfused pulls run), from `ptxas -v` on the
# H100's toolkit before the epilogue parameter was added
F32_SUM_COPY_PTXAS = (40, 0)


def _ptxas_entries(text: str) -> dict:
    """{mangled entry: (registers, spill bytes)} of a ``ptxas -v`` log."""
    import re
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = [0, 0]
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[name][1] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def test_ell_spmv_instances_keep_their_registers(cuda):
    """The 36 ``ell_spmv_kernel`` instances with the plain store on the
    dense layout (layout flag ``Lb0E``) and their 36 row-layout twins
    (``Lb1E``) stay within the launch bounds' 40 registers, and the
    dense float32 sum/copy one keeps the registers and spills it had
    before the epilogue parameter; the fused PPR instances, one per
    layout, fit the same bounds, and the dense one spills nothing (the
    row layout's spills a few words, and times as its twins held to 48
    and 64 registers do, PERF.md)."""
    _build.load("ell_spmv")
    entries = _ptxas_entries(
        _build.lib_path("ell_spmv").with_suffix(".log").read_text())
    store = {k: v for k, v in entries.items()
             if "ell_spmv_kernel" in k and "StoreRows" in k}
    dense = {k: v for k, v in store.items() if "Lb0E" in k}
    rows = {k: v for k, v in store.items() if "Lb1E" in k}
    fused = [v for k, v in entries.items()
             if "ell_spmv_kernel" in k and "PprStep" in k]
    assert len(dense) == len(rows) == 36 and len(fused) == 2
    assert all(regs <= 40 for regs, _ in store.values())
    assert [v for k, v in dense.items()
            if "ell_spmv_kernelIfffLi0ELi0E" in k] == [F32_SUM_COPY_PTXAS]
    fused_dense = [v for k, v in entries.items()
                   if "ell_spmv_kernel" in k and "PprStepELb0E" in k]
    assert all(regs <= 40 for regs, _ in fused)
    assert len(fused_dense) == 1 and fused_dense[0][1] == 0


@pytest.mark.parametrize("width", (None, 8, 33), ids=lambda b: f"B{b}")
@pytest.mark.parametrize("bin_n", (8, 24), ids=("bin8", "bin_n"))
def test_scan_push_splits_match_plain(graphs, cuda, bin_n, width):
    """block_e 256, 1,024 and 8,192 (the edges of a unit at width 1, a
    C-th of that at C column lanes, at least 256) over bins of 8 and one
    bin of all n: the hub's run crosses units and pieces."""
    g = graphs["hub"]
    plan = build_push_plan(g.coo_src, g.coo_dst, g.coo_w, g.n, bin_n)
    gen = torch.Generator(device=cuda).manual_seed(8)
    active = torch.rand(g.n, generator=gen, device=cuda) < 0.7
    for i, (dtype, combine, msg) in enumerate(
            (d, c, m) for d in cs.DTYPES for c in cs.COMBINES
            for m in ("copy", "add")):
        shape = (g.n,) + (() if width is None else (width,))
        x = cs.payload(shape, dtype, i, cuda)
        want = coo_push_plain(x, active, plan, g.n, combine, msg)
        for block_e in (256, 1024, 8192):
            got = coo_push(x, active, g.coo_src, g.coo_dst, g.coo_w, g.n,
                           combine, msg, plan=plan, block_e=block_e)
            cs.max_abs_err(got, want, combine,
                           f"coo_push hub bin {bin_n} B{width} {dtype} "
                           f"{combine} {msg} block_e {block_e}")
            again = coo_push(x, active, g.coo_src, g.coo_dst, g.coo_w, g.n,
                             combine, msg, plan=plan, block_e=block_e)
            assert torch.equal(got, again)


@pytest.mark.parametrize("width", (None, 3, 33), ids=lambda b: f"B{b}")
def test_frontier_pull_pieces_match_plain(graphs, cuda, width):
    """The frontier pull over the hub graph (a row of 12,293 in-edges:
    13 pieces at width 1, 385 at 33 columns), with and without
    ``row_len``, on a list of every row, a list of a few rows with
    sentinels and a list of sentinels only; a second call gives the same
    bits (the last unit of a split row resets its counter)."""
    g = graphs["hub"]
    hub_row = int(torch.argmax(g.in_deg))
    lists = {"all": torch.arange(g.n, dtype=torch.int32, device=cuda),
             "few": torch.tensor([hub_row, g.n, 3, hub_row, g.n, 0],
                                 dtype=torch.int32, device=cuda),
             "sentinels": torch.full((5,), g.n, dtype=torch.int32,
                                     device=cuda)}
    for i, (dtype, combine, msg) in enumerate(
            (d, c, m) for d in cs.DTYPES for c in cs.COMBINES
            for m in cs.MSGS):
        shape = (g.n + 1,) + (() if width is None else (width,))
        x = cs.payload(shape, dtype, i, cuda)
        x[-1] = 0
        for name, rows in lists.items():
            for row_len in (None, g.in_deg):
                kw = dict(row_len=row_len)
                want = ell_pull_frontier_plain(x, g.ell_idx, g.ell_w, rows,
                                               combine, msg, **kw)
                for block_r in (128, 4096):
                    got = ell_pull_frontier(x, g.ell_idx, g.ell_w, rows,
                                            combine, msg, block_r=block_r,
                                            **kw)
                    cs.max_abs_err(got, want, combine,
                                   f"ell_pull_frontier hub {name} B{width} "
                                   f"{dtype} {combine} {msg} row_len "
                                   f"{row_len is not None} block_r "
                                   f"{block_r}")
                    again = ell_pull_frontier(x, g.ell_idx, g.ell_w, rows,
                                              combine, msg, block_r=block_r,
                                              **kw)
                    assert torch.equal(got, again)


# -- slice 8: float32 sums of the dense backend, the stepwise engine, spans


def dense_push_sum(cuda, terms: list[float]) -> float:
    """The dense backend's push of ``terms`` (float32), one edge each,
    into vertex 0."""
    from repro_torch.core.backend import DenseBackend
    from repro_torch.core.cost_model import Cost
    from repro_torch.graphs import build_graph
    k = len(terms)
    g = build_graph(np.arange(1, k + 1), np.zeros(k, np.int64), k + 1,
                    device=cuda)
    values = torch.tensor([0.0] + terms, dtype=torch.float32, device=cuda)
    frontier = torch.ones(k + 1, dtype=torch.bool, device=cuda)
    out, _ = DenseBackend().push(g, values, frontier, "sum", None,
                                 Cost.zeros(cuda))
    return out[0].item()


def test_dense_push_keeps_subnormal_terms(cuda):
    """Two 2^-130 terms sum to 2^-129: float32 atomics would flush both
    to zero, the float64 accumulator keeps them."""
    assert dense_push_sum(cuda, [2.0 ** -130, 2.0 ** -130]) == 2.0 ** -129


def test_dense_push_rounds_once(cuda):
    """1 + 2^-24 + 2^-24 rounds once, to 1 + 2^-23; summed in float32
    from 1.0 on, each 2^-24 would round away."""
    assert dense_push_sum(cuda, [1.0, 2.0 ** -24, 2.0 ** -24]) == \
        1.0 + 2.0 ** -23


@pytest.mark.parametrize("alg,policy,kw", [
    ("bfs", "auto", {"root": 0}), ("bfs", "gs", {"root": 0}),
    ("pagerank", "pull", {"iters": 10}), ("pagerank", "push", {"iters": 10}),
    ("ppr", "auto", {"source": 3})])
def test_run_stepwise_equals_run_on_card(cuda, alg, policy, kw):
    """Through the autotuned CUDA backend, the same instance (its tuned
    blocks and plans) launches the same kernels in both loops: state,
    Cost, steps and every StepTrace row bit for bit, and the telemetry
    path of ``solve`` equals the plain one."""
    from repro_torch.core.engine import PushPullEngine
    from repro_torch.graphs import kronecker
    from repro_torch.obs import Telemetry
    g = kronecker(12, edge_factor=16, seed=0, weighted=True, device=cuda)
    be = api.CudaBackend()
    spec = api.get_spec(alg)
    pol = api._resolve_policy(policy)
    program, steps = spec.build(g, policy=pol, backend=be)
    eng = PushPullEngine(program=program, policy=pol, max_steps=steps,
                         backend=be, trace_capacity=64)
    state0, frontier0 = spec.init(g, **kw)
    whole = eng.run(g, state0, frontier0)
    times = {}
    stepped = eng.run_stepwise(g, state0, frontier0,
                               on_step=times.__setitem__)
    sw, ss = ((r.state if isinstance(r.state, dict) else {"x": r.state})
              for r in (whole, stepped))
    for k in sw:
        assert torch.equal(sw[k], ss[k]), k
    assert whole.cost.as_dict() == stepped.cost.as_dict()
    assert (whole.steps, whole.push_steps) == (stepped.steps,
                                               stepped.push_steps)
    assert whole.trace.as_dict(whole.steps) == \
        stepped.trace.as_dict(whole.steps)
    assert sorted(times) == list(range(whole.steps))
    plain = api.solve(g, alg, policy=policy, backend=be, **kw)
    tel = Telemetry()
    seen = api.solve(g, alg, policy=policy, backend=be, telemetry=tel, **kw)
    ps, os_ = ((r.state if isinstance(r.state, dict) else {"x": r.state})
               for r in (plain, seen))
    for k in ps:
        assert torch.equal(ps[k], os_[k]), k
    assert plain.cost.as_dict() == seen.cost.as_dict()
    timed = [e for e in tel.events if e["kind"] == "step"]
    assert len(timed) == seen.steps and all("us" in e for e in timed)
    assert be.stats["fallback_pull"] == be.stats["fallback_push"] == 0


def test_span_covers_the_kernels_it_wraps(cuda):
    """A span given the card's device ends with a synchronize: its
    ``dur_us`` is at least the CUDA-event time of the launches inside
    it, not the time to enqueue them."""
    from repro_torch.obs import Telemetry
    g = standin("rca", scale=1 / 4, weighted=True, device=cuda)
    x = pad_values(torch.rand((g.n, 16), device=cuda))
    plan = ell_row_plan(g.in_deg, g.n, g.d_ell, 16)
    ell_spmv(x, g.ell_idx, g.ell_w, "sum", "mul", row_len=g.in_deg,
             plan=plan)
    torch.cuda.synchronize()
    tel = Telemetry()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with tel.span("pull", device=cuda):
        start.record()
        for _ in range(20):
            ell_spmv(x, g.ell_idx, g.ell_w, "sum", "mul", row_len=g.in_deg,
                     plan=plan)
        end.record()
    kernel_us = start.elapsed_time(end) * 1e3
    (ev,) = tel.events
    assert kernel_us > 0 and ev["dur_us"] >= kernel_us


@pytest.mark.parametrize("alg,policy,kw", [
    ("bfs", "auto", {"root": 0}), ("pagerank", "pull", {"iters": 10}),
    ("pagerank", "push", {"iters": 10}),
    ("sssp_delta", "push", {"source": 0, "delta": 2.0})])
def test_sharded_solve_equals_cuda_backend(cuda, alg, policy, kw):
    """Four shards on one card (slice 9), with ``ell_spmv`` inside each
    shard's pull: the answer equals the single-device CUDA backend's
    (integers and min bit for bit, float sums to 1e-5 relative), and the
    sharded pull launches the kernel with no fallback."""
    from repro_torch.graphs import kronecker
    from repro_torch.shard import ShardedBackend
    g = kronecker(12, edge_factor=16, seed=0, weighted=True, device=cuda)
    sb = ShardedBackend.prepare(g, devices=[cuda] * 4, inner="cuda")
    want = api.solve(g, alg, policy=policy, backend=api.CudaBackend(), **kw)
    _build.reset_launch_counts()
    got = api.solve(g, alg, policy=policy, backend=sb, **kw)
    launched = _build.launch_counts()["ell_spmv"]
    sw, sg = ((r.state if isinstance(r.state, dict) else {"x": r.state})
              for r in (want, got))
    for k in sw:
        if alg == "pagerank":
            torch.testing.assert_close(sg[k], sw[k], rtol=1e-5, atol=0)
        else:
            assert torch.equal(sg[k], sw[k]), k
    assert sb.stats["fallback_pull"] == 0
    pulls = got.steps - got.push_steps
    assert launched == sb.stats["kernel_pull"] == 4 * pulls
    if policy == "pull":
        assert launched > 0


# -- slice 10: gradients through the model kernels ---------------------------
def rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float32), ids=str)
@pytest.mark.parametrize("T,group,window,softcap,d", [
    (300, 4, GLOBAL_WINDOW, 0.0, 64), (130, 2, 17, 50.0, 256),
    (200, 8, 64, 30.0, 32)])
def test_flash_attention_gradients_match_plain(cuda, dtype, T, group,
                                               window, softcap, d):
    """The ``FlashAttention`` Function (the kernel forward, the backward
    kernel; the Function's q-chunk of 64 is read only on the CPU)
    against autograd through the plain version: each gradient within
    ``chip_smoke.FLASH_GRAD_TOL`` (f32 1e-4, bf16 1e-2) of its largest
    entry; one forward and one backward launch."""
    B, Hk = 2, 2
    q = normal((B, T, Hk * group, d), 1, cuda, dtype).requires_grad_()
    k = normal((B, T, Hk, d), 2, cuda, dtype).requires_grad_()
    v = normal((B, T, Hk, d), 3, cuda, dtype).requires_grad_()
    dout = normal((B, T, Hk * group, d), 4, cuda, dtype)
    _build.reset_launch_counts()
    out = flash_attention(q, k, v, window, softcap, None, 64)
    assert out.grad_fn is not None
    assert _build.launch_counts()["flash_attention"] == 1
    got = torch.autograd.grad(out, (q, k, v), dout)
    assert _build.launch_counts()["flash_attention_bwd"] == 1
    want = torch.autograd.grad(flash_attention_plain_gqa(q, k, v, window,
                                                         softcap),
                               (q, k, v), dout)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert rel_gap(a, b) <= cs.FLASH_GRAD_TOL[dtype]


@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float32), ids=str)
@pytest.mark.parametrize("d", HEAD_DIMS)
@pytest.mark.parametrize("T,group,window,softcap", [
    (1, 2, GLOBAL_WINDOW, 0.0), (130, 4, 17, 50.0),
    (384, 8, GLOBAL_WINDOW, 50.0), (200, 1, GLOBAL_WINDOW, 0.0),
    (1000, 8, 17, 50.0), (2048, 4, GLOBAL_WINDOW, 0.0)])
def test_flash_attention_bwd_kernel_matches_its_plain_version(
        cuda, dtype, d, T, group, window, softcap):
    """The backward kernel against ``flash_attention_bwd_plain`` on the
    same output and logsumexp (``chip_smoke.grad_gaps``), the same bits
    from two launches, and the forward's logsumexp against the plain
    one's. T = 200 and 1,000 leave a ragged last tile of 64 queries and
    of 64 or 128 keys; at 2,048 up to 32 key tiles add into each dQ tile
    in turn, which two launches must still do in the same order."""
    B, Hk = 2, 2
    q = normal((B, T, Hk * group, d), 5, cuda, dtype)
    k = normal((B, T, Hk, d), 6, cuda, dtype)
    v = normal((B, T, Hk, d), 7, cuda, dtype)
    dout = normal((B, T, Hk * group, d), 8, cuda, dtype)
    out, lse = flash_attention_fwd(q, k, v, window, softcap, want_lse=True)
    plain_lse = flash_attention_plain_gqa(q, k, v, window, softcap,
                                          return_lse=True)[1]
    assert rel_gap(lse, plain_lse) <= cs.FLASH_LSE_TOL
    got = flash_attention_bwd(q, k, v, out, lse, dout, window, softcap)
    again = flash_attention_bwd(q, k, v, out, lse, dout, window, softcap)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = flash_attention_bwd_plain(q, k, v, dout, window, softcap,
                                     out=out, lse=lse)
    assert [(a.dtype, a.shape) for a in got] == [(b.dtype, b.shape)
                                                 for b in want]
    assert max(cs.grad_gaps(got, want)) <= cs.FLASH_GRAD_TOL[dtype]


@pytest.mark.parametrize("B,Hp,F,H,D", [(37, 39, 39, 200, 10),
                                        (37, 200, 39, 200, 10),
                                        (300, 13, 9, 37, 3)])
def test_cin_layer_gradients_match_plain(cuda, B, Hp, F, H, D):
    """The ``CinLayer`` Function (dxk a layer launch on a permuted
    weight, dx0 and dw their own kernels) against autograd through the
    plain version, f32: each within ``chip_smoke.CIN_GRAD_TOL`` (1e-4) of
    its largest entry; four launches (the forward, dxk, dw, dx0), none
    plain."""
    xk = normal((B, Hp, D), 4, cuda).requires_grad_()
    x0 = normal((B, F, D), 5, cuda).requires_grad_()
    w = (normal((H, Hp, F), 6, cuda) * (2.0 / (Hp * F)) ** 0.5
         ).requires_grad_()
    g = normal((B, H, D), 7, cuda)
    _build.reset_launch_counts()
    out = cin_layer(xk, x0, w)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (xk, x0, w), g)
    counts = _build.launch_counts()
    assert (counts["cin"], counts["cin_dw"], counts["cin_dx0"]) == (2, 1, 1)
    want = torch.autograd.grad(cin_layer_plain(xk, x0, w), (xk, x0, w), g)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert rel_gap(a, b) <= cs.CIN_GRAD_TOL


# (Hp, F, H, D): the layers' shapes, odd H on the width of 64 (one and
# two h tiles), F padded to 40 and 200 by the dx0 kernel and above 200
# (two blocks of fields), Hp not a multiple of 16 or of the dx0 kernel's
# groups of i
CIN_BWD_SHAPES = [(39, 39, 200, 10), (200, 39, 200, 10), (5, 4, 7, 6),
                  (200, 39, 70, 10), (13, 9, 37, 3), (20, 41, 9, 4),
                  (7, 7, 8, 6), (13, 230, 37, 3)]


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16), ids=str)
@pytest.mark.parametrize("B", (1, 37, 300))
@pytest.mark.parametrize("Hp,F,H,D", CIN_BWD_SHAPES)
def test_cin_bwd_kernels_match_plain(cuda, dtype, B, Hp, F, H, D):
    """The dw and dx0 kernels against their plain versions on the same
    inputs: dw (f32) within ``chip_smoke.CIN_GRAD_TOL`` (1e-4) of its
    largest entry in both dtypes (bf16 inputs are exact in f32); dx0
    within 1e-4 in f32 and ``chip_smoke.CIN_TOL`` (2e-2) in bf16 (its
    output rounds to bf16). Few columns split dw's K and dx0's units over
    CTAs (B = 1, 37); two launches give the same bits."""
    xk = normal((B, Hp, D), 14, cuda, dtype)
    x0 = normal((B, F, D), 15, cuda, dtype)
    w = (normal((H, Hp, F), 16, cuda) * (2.0 / (Hp * F)) ** 0.5).to(dtype)
    g = normal((B, H, D), 17, cuda, dtype)
    dw, dx0 = cin_weight_grad(g, xk, x0), cin_dx0(g, xk, w)
    assert torch.equal(dw, cin_weight_grad(g, xk, x0))
    assert torch.equal(dx0, cin_dx0(g, xk, w))
    want_dw = cin_weight_grad_plain(g, xk, x0)
    want_dx0 = cin_dx0_plain(g, xk, w)
    assert (dw.dtype, dw.shape) == (want_dw.dtype, want_dw.shape)
    assert (dx0.dtype, dx0.shape) == (want_dx0.dtype, want_dx0.shape)
    assert rel_gap(dw, want_dw) <= cs.CIN_GRAD_TOL
    assert rel_gap(dx0, want_dx0) <= (cs.CIN_TOL[dtype]
                                      if dtype == torch.bfloat16
                                      else cs.CIN_GRAD_TOL)


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16), ids=str)
def test_cin_bwd_prepass_writes_the_packed_layouts(cuda, dtype):
    """The kernels' pre-passes write the operands bit for bit as
    ``dw_operands`` and ``dx0_operands`` lay them out (the layouts the
    CPU tests check)."""
    B, Hp, F, H, D = 37, 13, 9, 37, 3
    xk = normal((B, Hp, D), 18, cuda, dtype)
    x0 = normal((B, F, D), 19, cuda, dtype)
    g = normal((B, H, D), 20, cuda, dtype)
    w = normal((H, Hp, F), 21, cuda, dtype)
    _, ops = cin_mod._dw_launch(g, xk, x0)
    want = cin_mod.dw_operands(g, xk, x0)
    assert all(torch.equal(ops[k], want[k]) for k in ("g", "xk", "x0"))
    _, ga = cin_mod._dx0_launch(g, xk, w)
    assert torch.equal(ga, cin_mod.dx0_operands(g))


def test_cin_packing_follows_an_in_place_optimizer_step(cuda):
    """After ``apply_updates`` writes w in place, the kernel packs it
    anew: its output equals the plain layer on the updated w."""
    from repro_torch.train import OptConfig, apply_updates, init_opt
    xk = normal((64, 39, 10), 8, cuda)
    w = (normal((200, 39, 39), 9, cuda) * 0.03)
    before = cin_layer(xk, xk, w)
    params = {"w": w}
    cfg = OptConfig(warmup_steps=0, lr=1e-2)
    apply_updates(params, {"w": normal(w.shape, 10, cuda)},
                  init_opt(params, cfg), cfg)
    assert params["w"] is w
    after = cin_layer(xk, xk, w)
    assert not torch.equal(after, before)
    torch.testing.assert_close(after, cin_layer_plain(xk, xk, w), rtol=2e-4,
                               atol=2e-4)


def test_cin_layer_refuses_more_fields_than_it_stages(cuda):
    from repro_torch.kernels.cin import max_fields
    F = max_fields(200) + 1
    x0 = torch.zeros((2, F, 4), device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        cin_layer(torch.zeros((2, 3, 4), device=cuda), x0,
                  torch.zeros((200, 3, F), device=cuda))


def test_lm_loss_gradients_kernel_against_naive(cuda):
    """A small f32 llama (head dim 32) on the card: every parameter's
    gradient through the flash kernel's Function (remat on) against the
    plain ``"naive"`` attention, ‖Δg‖ / ‖g‖ within
    ``chip_smoke.LM_GRAD_TOL`` (f32: 1e-4)."""
    import dataclasses
    from repro_torch.configs.archs import smoke_config
    from repro_torch.dist.overlap import value_and_grad
    from repro_torch.models import transformer as tf
    cfg = dataclasses.replace(smoke_config("llama3.2-1b"), d_model=128,
                              n_heads=4, n_kv_heads=2, q_chunk=16)
    params = tf.init_params(cfg, seed=0, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 97), generator=gen, device=cuda)
    grads = {}
    for impl in ("blockwise", "naive"):
        c = dataclasses.replace(cfg, attn_impl=impl)
        _build.reset_launch_counts()
        grads[impl] = value_and_grad(
            lambda p, b, c=c: tf.lm_loss(p, c, b[:, :-1], b[:, 1:]), params,
            toks)[1]
        launched = _build.launch_counts()["flash_attention"]
        assert launched == (2 * cfg.n_layers if impl == "blockwise" else 0)
    assert cs.worst_leaf(grads["blockwise"], grads["naive"]) <= \
        cs.LM_GRAD_TOL[torch.float32]


# -- slice 11: the GNN and MoE families -------------------------------------
def test_chunked_float64_segment_sum_equals_one_sum_on_card(cuda,
                                                            monkeypatch):
    """A float32 segment_sum of 4 M rows × 8 on the card, its float64 copy
    made 1 MB at a time (32 chunks), against one float64 ``index_add_``
    of the whole input rounded once: the same up to the order of the
    float64 atomics (rtol 1e-6, atol 1e-9); two 2^-130 terms, each in
    its own chunk, still sum to 2^-129."""
    from repro_torch.sparse import segment as seg
    gen = torch.Generator(device=cuda).manual_seed(0)
    m, d, n = 1 << 22, 8, 1 << 16
    data = torch.randn((m, d), generator=gen, device=cuda)
    ids = torch.randint(-5, n + 5, (m,), generator=gen, device=cuda)
    want = torch.zeros((n + 1, d), dtype=torch.float64, device=cuda)
    want = want.index_add_(0, seg._spill_ids(ids, n), data.double())
    monkeypatch.setattr(seg, "SUM_CHUNK_BYTES", 1 << 20)
    got = seg.segment_sum(data, ids, n)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want[:n].float(), rtol=1e-6, atol=1e-9)
    monkeypatch.setattr(seg, "SUM_CHUNK_BYTES", 8)
    tiny = seg.segment_sum(torch.full((2,), 2.0 ** -130, device=cuda),
                           torch.zeros(2, dtype=torch.long, device=cuda), 1)
    assert tiny.item() == 2.0 ** -129


def test_gin_push_equals_pull_on_card(cuda):
    """GIN at a small width on the card: push equals pull (rtol = atol =
    1e-5), and both equal the CPU's forward on the same graph and
    weights within 1e-5 of the largest |output| (the card sums in
    float64, the CPU in float32; an output that cancels to near 0 keeps
    the absolute rounding of its terms)."""
    import dataclasses
    from repro_torch.configs.archs import smoke_config
    from repro_torch.models import gnn
    from repro_torch.models.common import tree_map
    cfg = smoke_config("gin-tu")
    g = erdos_renyi(300, 6.0, seed=3, weighted=True, device=cuda)
    gc = erdos_renyi(300, 6.0, seed=3, weighted=True, device="cpu")
    p = gnn.gin_init(cfg, seed=0, device=cuda)
    h = torch.randn((300, cfg.d_in), generator=torch.Generator(
        device=cuda).manual_seed(1), device=cuda)
    pull = gnn.gin_apply(p, cfg, g, h)
    push = gnn.gin_apply(p, dataclasses.replace(cfg, direction="push"), g, h)
    torch.testing.assert_close(push, pull, rtol=1e-5, atol=1e-5)
    cpu = gnn.gin_apply(tree_map(lambda t: t.cpu(), p), cfg, gc, h.cpu())
    assert float((pull.cpu() - cpu).abs().max()) <= \
        1e-5 * float(cpu.abs().max())


def moe_case(cuda, **kw):
    from repro_torch.models import moe
    cfg = moe.MoEConfig(d_model=64, d_ff_expert=32, n_experts=8, top_k=2,
                        n_shared=1, capacity_factor=8.0, **kw)
    gen = torch.Generator(device=cuda).manual_seed(2)
    p = moe.moe_init(gen, cfg)
    x = torch.randn((2, 32, 64), generator=gen, device=cuda)
    return moe, cfg, p, x


@pytest.mark.parametrize("capacity", (0.5, 8.0))
def test_moe_push_equals_pull_on_card(cuda, capacity):
    import dataclasses
    moe, cfg, p, x = moe_case(cuda)
    cfg = dataclasses.replace(cfg, capacity_factor=capacity)
    pull = moe.moe_apply(p, dataclasses.replace(cfg, dispatch="pull"), x)
    push = moe.moe_apply(p, dataclasses.replace(cfg, dispatch="push"), x)
    torch.testing.assert_close(push, pull, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode,combine", [("psum", "f32"), ("a2a", "f32"),
                                          ("psum", "bf16")])
def test_moe_apply_ep_on_one_card_equals_moe_apply(cuda, mode, combine):
    """Four expert shards on one card (``[cuda] * 4``), a capacity that
    drops nothing: equal to ``moe_apply`` (f32 rtol = atol = 1e-5; the
    bf16 combine within 2^-6 of the largest |output|)."""
    import dataclasses
    from repro_torch.dist.sharding import set_activation_mesh
    from repro_torch.shard import make_shard_mesh
    moe, cfg, p, x = moe_case(cuda, dispatch="pull")
    want = moe.moe_apply(p, cfg, x)
    set_activation_mesh(make_shard_mesh(4, axis="model",
                                        devices=[cuda] * 4))
    try:
        got = moe.moe_apply_ep(p, dataclasses.replace(
            cfg, ep_mode=mode, combine_dtype=combine), x)
    finally:
        set_activation_mesh(None)
    if combine == "bf16":
        assert float((got - want).abs().max()) <= \
            2 ** -6 * float(want.abs().max())
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------- slice 12: the cells --
def test_kernel_wrappers_on_meta_launch_nothing(cuda):
    """On ``meta`` a wrapper returns the shape and counts the work, with
    the card present: no launch."""
    from repro_torch.kernels.roofline import cin_work, flash_work
    q = torch.empty(2, 130, 8, 64, dtype=torch.bfloat16, device="meta")
    kv = torch.empty(2, 130, 2, 64, dtype=torch.bfloat16, device="meta")
    xk = torch.empty(37, 39, 10, device="meta")
    w = torch.empty(200, 39, 39, device="meta")
    before = _build.launch_counts()
    _build.reset_kernel_work()
    assert flash_attention(q, kv, kv).shape == q.shape
    assert cin_layer(xk, xk, w).shape == (37, 200, 10)
    assert _build.launch_counts() == before
    work = _build.kernel_work()
    assert work["flash_attention"]["flops"] == flash_work(
        2, 130, 8, 2, 64, GLOBAL_WINDOW, 2)[1]
    assert work["cin"]["flops"] == cin_work(37, 200, 39, 39, 10, 4)[1]


@pytest.mark.parametrize("arch,shape", [("xdeepfm", "serve_p99"),
                                        ("xdeepfm", "train_batch"),
                                        ("gin-tu", "molecule")])
def test_cell_flops_on_card_equal_meta(cuda, arch, shape):
    """The same step counted on the card (real tensors, the kernels
    launched) and on meta: equal FLOPs, aten operators and kernel work
    alike; the card's launches happened."""
    from repro_torch.configs import build_cell
    from repro_torch.launch.dryrun import count_step
    from repro_torch.launch.mesh import make_production_mesh
    mesh = make_production_mesh()
    meta = count_step(build_cell(arch, shape, mesh))
    before = _build.launch_counts()
    card = count_step(build_cell(arch, shape, mesh, device=cuda))
    torch.cuda.synchronize()
    assert card["flops"] == meta["flops"]
    assert card["flops_aten"] == meta["flops_aten"]
    assert card["kernels"] == meta["kernels"]
    if arch == "xdeepfm":
        assert _build.launch_counts()["cin"] > before["cin"]
