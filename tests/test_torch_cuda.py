"""The port's CUDA kernels against their plain PyTorch versions, on the
card.

Every test here needs a CUDA device (marker ``cuda``) and skips where
there is none. The file imports nothing of JAX, so it runs on a machine
with the card and no JAX:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: integers, min and max bit for bit; float sums rtol = atol =
1e-5 (the kernels sum floats in float64 in another order than the plain
versions).
"""

import pytest
import torch

import chip_smoke as cs
from repro_torch import api
from repro_torch.graphs import erdos_renyi, standin
from repro_torch.graphs.structure import pad_values
from repro_torch.kernels import _build
from repro_torch.kernels.coo_push import (build_push_plan, coo_push,
                                          coo_push_plain)
from repro_torch.kernels.ell_pull_frontier import (ell_pull_frontier,
                                                   ell_pull_frontier_full,
                                                   ell_pull_frontier_plain,
                                                   frontier_rows)
from repro_torch.kernels.ell_spmv import ell_spmv, ell_spmv_plain
from repro_torch.core.primitives import mask_untouched

pytestmark = pytest.mark.cuda


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
    after = _build.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "ell_spmv": 1, "ell_pull_frontier": 1, "coo_push": 1}


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
