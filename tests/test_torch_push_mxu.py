"""The port's one-hot push (``coo_push(strategy="mxu")``) against the
JAX package's ``coo_push_pallas(strategy="mxu")`` in Pallas interpret
mode, over combine × dtype × msg × payload rank, on the disjoint union
of the adversarial graph cases (a hub, empty rows, self loops, duplicate
edges) and on an edgeless graph.

On the CPU the port's wrapper runs ``coo_push_mxu_plain``, which keeps
the reference's numerics: each ``block_e`` chunk of a bin reduced in the
message dtype (a one-hot matmul for float sums, a masked window reduce
otherwise), chunks combined in order. Both sides use bins of 8
destinations and 64-slot chunks over a 128-aligned plan, so every bin
spans two chunks. Integer results and min/max bit for bit, float sums to
rtol = atol = 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.coo_push import coo_push_pallas
from repro_torch.kernels import _build
from repro_torch.graphs import star
from repro_torch.kernels.coo_push import (MXU_TILE, build_push_plan,
                                          coo_push, coo_push_mxu_plain,
                                          coo_push_plain, mxu_unit_edges,
                                          mxu_units)
from test_torch_kernels import GRID, GRID_IDS, assert_same, payload
from test_torch_push import push_graphs  # noqa: F401  (module fixture)

BIN_N = 8
BLOCK_E = 64


@pytest.mark.parametrize("combine,dtype,msg,batch", GRID, ids=GRID_IDS)
def test_coo_push_mxu_matches_pallas(push_graphs, combine, dtype, msg,
                                     batch):
    active = np.random.default_rng(5).random(push_graphs["union"][0].n) < 0.5
    for g, tg, ref_plan, plan in push_graphs.values():
        x = payload(g.n, dtype, batch)
        want = coo_push_pallas(jnp.asarray(x), jnp.asarray(active),
                               g.coo_src, g.coo_dst, g.coo_w, g.n,
                               combine=combine, msg=msg, block_e=BLOCK_E,
                               block_n=BIN_N, interpret=True,
                               plan=ref_plan, strategy="mxu")
        got = coo_push(torch.from_numpy(x), torch.from_numpy(active),
                       tg.coo_src, tg.coo_dst, tg.coo_w, tg.n,
                       combine=combine, msg=msg, plan=plan,
                       strategy="mxu", block_e=BLOCK_E)
        assert_same(got, want, combine)


@pytest.mark.parametrize("block_e", (8, 64, 100, 4096))
def test_chunking_keeps_the_result(push_graphs, block_e):
    """The chunk size changes only the float summation order: the
    one-hot push equals the scan push whatever ``block_e`` is, including
    a ragged last chunk."""
    g, tg, _, plan = push_graphs["union"]
    active = torch.from_numpy(np.random.default_rng(2).random(g.n) < 0.6)
    for dtype in ("float32", "int32"):
        x = torch.from_numpy(payload(g.n, dtype, 3))
        for combine in ("sum", "max"):
            got = coo_push_mxu_plain(x, active, plan, g.n, combine, "mul",
                                     block_e)
            want = coo_push_plain(x, active, plan, g.n, combine, "mul")
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_strategy_and_device_checks(push_graphs):
    """An unknown strategy raises; a CPU tensor runs the plain version
    and launches nothing; a plan wider than the card's one-hot kernel
    still runs on the CPU."""
    _, tg, _, _ = push_graphs["union"]
    x = torch.ones(tg.n)
    active = torch.ones(tg.n, dtype=torch.bool)
    args = (x, active, tg.coo_src, tg.coo_dst, tg.coo_w, tg.n)
    with pytest.raises(ValueError, match="strategy"):
        coo_push(*args, strategy="dense")
    before = _build.launch_counts()
    wide = build_push_plan(tg.coo_src, tg.coo_dst, tg.coo_w, tg.n, 512)
    got = coo_push(*args, plan=wide, strategy="mxu", combine="sum",
                   msg="copy")
    torch.testing.assert_close(got, tg.in_deg.to(torch.float32))
    assert _build.launch_counts() == before


def direct_mxu_units(plan, n: int, edges: int):
    """The one-hot kernel's units built tile by tile from ``plan.ptr``."""
    ptr = plan.ptr.numpy()
    out, records = [], 0
    for b in range(plan.nb):
        for r0 in range(0, plan.bin_n, MXU_TILE):
            r1 = min(r0 + MXU_TILE, plan.bin_n)
            rows = min(r1, n - b * plan.bin_n) - r0
            if rows <= 0:
                continue
            lo, hi = int(ptr[b, r0]), int(ptr[b, r1])
            nu = max(1, -(-(hi - lo) // edges))
            rec0 = records if nu > 1 else -1
            records += nu if nu > 1 else 0
            for k in range(nu):
                out.append((b, r0, rows, lo + k * edges,
                            min(lo + (k + 1) * edges, hi), k, nu, rec0))
    return np.array(out, dtype=np.int64).reshape(-1, 8), records


@pytest.mark.parametrize("block_e", (64, 300, 4096))
@pytest.mark.parametrize("bin_n", (8, 100, 256))
@pytest.mark.parametrize("case", ("union", "star"))
def test_mxu_units_match_direct_construction(push_graphs, case, bin_n,
                                             block_e):
    """Tiles of 64 destinations per bin (a ragged last tile, none past
    n), each tile's slots cut into units of ``mxu_unit_edges(block_e)``
    (256 at least, so the star's hub tile is cut into several), records
    only for split tiles; together the units cover every real slot of
    every bin once, and each slot's destination lies in its tile."""
    if case == "star":
        tg = star(3000, device="cpu")
    else:
        tg = push_graphs["union"][1]
    plan = build_push_plan(tg.coo_src, tg.coo_dst, tg.coo_w, tg.n, bin_n)
    units = mxu_units(plan, tg.n, block_e)
    e = mxu_unit_edges(block_e)
    want, records = direct_mxu_units(plan, tg.n, e)
    assert units.edges == e and units.records == records
    np.testing.assert_array_equal(units.table.numpy(), want)
    assert units.counters.shape == (max(records, 1),)
    assert not units.counters.any()
    assert mxu_units(plan, tg.n, block_e) is units          # cached
    covered = np.zeros((plan.nb, plan.cap), dtype=np.int64)
    dst = plan.dst.numpy()
    for b, r0, rows, lo, hi, _, _, _ in want:
        covered[b, lo:hi] += 1
        v0 = b * bin_n + r0
        assert ((dst[b, lo:hi] >= v0) & (dst[b, lo:hi] < v0 + rows)).all()
    edges = plan.ptr[:, -1].numpy()
    real = np.arange(plan.cap)[None, :] < edges[:, None]
    np.testing.assert_array_equal(covered, real.astype(np.int64))
    if case == "star" and e < plan.max_run:                 # a split hub
        assert records > 0 and units.table[:, 6].max() > 1
