"""The port's frontier ELL pull against the JAX package's
``ell_pull_frontier_pallas``, with the harness, graphs and tolerances of
``test_torch_kernels.py``: the port's plain version on the CPU, the
reference kernel in Pallas interpret mode, over combine × dtype × msg ×
payload rank, over whole rows and over ``row_len = in_deg`` (the
backend's call; an ELL row holds its real slots first), on the union and
edgeless graphs and on the hub graph (a row of 12,293 in-edges, longer
than one piece at every width). The scattered ``_full`` form must equal
the masked full scan. The kernel's work plan (lane groups by ``d_ell``,
pieces of a row) is checked directly, and its decomposition (pieces
walked by slot lanes, combined in piece order) is emulated in numpy
against the plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ell_pull_frontier import (
    ell_pull_frontier_pallas, frontier_rows as ref_frontier_rows)
from repro_torch.core.primitives import mask_untouched
from repro_torch.kernels.ell_pull_frontier import (ell_pull_frontier,
                                                   ell_pull_frontier_full,
                                                   ell_pull_frontier_plain,
                                                   frontier_plan,
                                                   frontier_rows)
from repro_torch.kernels.ell_spmv import CHUNK, ell_spmv
from test_torch_kernels import (GRID, GRID_IDS, ROWS, SPLIT_CELLS,
                                _acc_dtype, _combine_acc, _identity,
                                _messages, assert_same, msg_dtype, payload)
from test_torch_kernels import graphs, hub  # noqa: F401  (module fixtures)


@pytest.mark.parametrize("combine,dtype,msg,batch", GRID, ids=GRID_IDS)
def test_ell_pull_frontier_matches_pallas(graphs, combine, dtype, msg,
                                          batch):
    touched = np.random.default_rng(3).random(graphs["union"][0].n) < 0.25
    for g, tg in graphs.values():
        x = payload(g.n + 1, dtype, batch)
        x[-1] = 0
        rows = ref_frontier_rows(jnp.asarray(touched), ROWS)
        trows = frontier_rows(torch.from_numpy(touched), ROWS)
        np.testing.assert_array_equal(trows.numpy(), np.asarray(rows))
        want = ell_pull_frontier_pallas(jnp.asarray(x), g.ell_idx, g.ell_w,
                                        rows, combine=combine, msg=msg,
                                        block_r=16, interpret=True)
        xt = torch.from_numpy(x)
        got = ell_pull_frontier(xt, tg.ell_idx, tg.ell_w, trows,
                                combine=combine, msg=msg)
        assert_same(got, want, combine)
        # the scattered form equals the masked full scan
        full = ell_pull_frontier_full(xt, tg.ell_idx, tg.ell_w, trows,
                                      combine=combine, msg=msg)
        masked = mask_untouched(
            ell_spmv(xt, tg.ell_idx, tg.ell_w, combine=combine, msg=msg),
            torch.from_numpy(touched), combine)
        assert_same(full, masked.numpy(), combine)


@pytest.mark.parametrize("combine,dtype,msg,batch", GRID, ids=GRID_IDS)
def test_ell_pull_frontier_row_len_matches_pallas(graphs, combine, dtype,
                                                  msg, batch):
    """Reading only each listed row's first in_deg slots gives the
    reference's full-row result."""
    touched = np.random.default_rng(5).random(graphs["union"][0].n) < 0.4
    for g, tg in graphs.values():
        x = payload(g.n + 1, dtype, batch, seed=13)
        x[-1] = 0
        rows = ref_frontier_rows(jnp.asarray(touched), ROWS)
        want = ell_pull_frontier_pallas(jnp.asarray(x), g.ell_idx, g.ell_w,
                                        rows, combine=combine, msg=msg,
                                        block_r=16, interpret=True)
        got = ell_pull_frontier(torch.from_numpy(x), tg.ell_idx, tg.ell_w,
                                frontier_rows(torch.from_numpy(touched),
                                              ROWS),
                                combine=combine, msg=msg, row_len=tg.in_deg)
        assert_same(got, want, combine)


def hub_list(n: int) -> np.ndarray:
    """The hub (row 0), the 600- and 40-slot rows, short and empty rows
    and sentinels, in no order."""
    return np.array([0, n, 9, 5, 12, 0, 45, n, 63, 20], np.int32)


@pytest.mark.parametrize("width", (None, 3, 33), ids=lambda b: f"b{b}")
@pytest.mark.parametrize("combine,dtype,msg", SPLIT_CELLS,
                         ids=["-".join(c) for c in SPLIT_CELLS])
def test_ell_pull_frontier_hub_rows_match_pallas(hub, combine, dtype, msg,
                                                 width):
    """Rows longer than one piece (the hub's 12,293 slots are 13 pieces
    at width 1, 385 at 33 columns), with and without row_len."""
    g, tg = hub
    x = payload(g.n + 1, dtype, width, seed=17)
    x[-1] = 0
    rows = hub_list(g.n)
    want = ell_pull_frontier_pallas(jnp.asarray(x), g.ell_idx, g.ell_w,
                                    jnp.asarray(rows), combine=combine,
                                    msg=msg, block_r=8, interpret=True)
    for row_len in (None, tg.in_deg):
        got = ell_pull_frontier(torch.from_numpy(x), tg.ell_idx, tg.ell_w,
                                torch.from_numpy(rows), combine=combine,
                                msg=msg, row_len=row_len)
        assert_same(got, want, combine)


@pytest.mark.parametrize("d_ell,width,group,piece,pieces", [
    (8, 1, 2, 1024, 1),            # a road graph: 16 rows a warp
    (8, 3, 8, 256, 1),             # 4 column lanes x 2 slot lanes
    (16, 1, 4, 1024, 1), (32, 1, 8, 1024, 1), (32, 8, 32, 128, 1),
    (33, 1, 32, 1024, 1),          # a warp from 33 slots on
    (9816, 1, 32, 1024, 10),       # Kronecker scale 16: 10 pieces
    (9816, 32, 32, 32, 307), (9816, 33, 32, 32, 307),
    (12293, 16, 32, 64, 193), (1, 1, 2, 1024, 1)])
def test_frontier_plan(d_ell, width, group, piece, pieces):
    plan = frontier_plan(d_ell, width)
    assert (plan.group, plan.piece, plan.pieces) == (group, piece, pieces)
    assert plan.group % plan.col_lanes == 0 and 32 % plan.group == 0
    # a row is split only where it gets a whole warp
    assert plan.pieces == 1 or plan.group == 32


def emulate_frontier(x, tg, rows, combine, msg, width):
    """The kernel's decomposition in numpy: each list entry's row is cut
    into the plan's pieces; a piece is walked by the group's slot lanes
    (lane l takes the CHUNK-slot chunks l, l + S, ... of the piece), the
    lanes combine by an xor butterfly, and the pieces of a split row are
    combined in piece order."""
    plan = frontier_plan(tg.d_ell, width)
    n, d = tg.ell_idx.shape
    idx, ew = tg.ell_idx.numpy(), tg.ell_w.numpy()
    lens = np.clip(tg.in_deg.numpy(), 0, d)
    mdt = msg_dtype(x.dtype, msg)
    adt = _acc_dtype(np.dtype(mdt), combine)
    odt = np.int64 if (combine == "sum" and mdt == np.int32) else mdt
    ident = _identity(combine, adt)
    x2 = x.reshape(x.shape[0], -1)
    lanes = plan.group // plan.col_lanes
    out = np.empty((rows.shape[0], x2.shape[1]), odt)
    for r, v in enumerate(rows):
        ln = lens[v] if 0 <= v < n else 0
        parts = []
        for p in range(max(1, -(-ln // plan.piece))):
            lo, hi = p * plan.piece, min((p + 1) * plan.piece, ln)
            acc = np.full((lanes, x2.shape[1]), ident, adt)
            for lane in range(lanes):
                for q in range(lo + CHUNK * lane, hi, CHUNK * lanes):
                    for j in range(q, min(q + CHUNK, hi)):
                        m = _messages(x2[idx[v, j]:idx[v, j] + 1],
                                      ew[v, j:j + 1], msg, mdt)
                        acc[lane] = _combine_acc(combine, acc[lane],
                                                 m[0].astype(adt))
            off = lanes // 2
            while off >= 1:
                acc = _combine_acc(combine, acc,
                                   acc[np.arange(lanes) ^ off])
                off //= 2
            parts.append(acc[0])
        res = parts[0]
        if len(parts) > 1:
            res = np.full(x2.shape[1], ident, adt)
            for part in parts:
                res = _combine_acc(combine, res, part)
        out[r] = res.astype(odt)
    return out if x.ndim == 2 else out[:, 0]


@pytest.mark.parametrize("width", (None, 3, 33), ids=lambda b: f"b{b}")
@pytest.mark.parametrize("combine,dtype,msg", SPLIT_CELLS,
                         ids=["-".join(c) for c in SPLIT_CELLS])
def test_frontier_emulation_matches_plain(hub, combine, dtype, msg, width):
    """The plan's decomposition, reduced piece by piece and combined in
    the kernel's order, equals the plain version over row_len."""
    g, tg = hub
    x = payload(g.n + 1, dtype, width, seed=19)
    x[-1] = 0
    rows = hub_list(g.n)
    got = emulate_frontier(x, tg, rows, combine, msg, width or 1)
    want = ell_pull_frontier_plain(torch.from_numpy(x), tg.ell_idx,
                                   tg.ell_w, torch.from_numpy(rows),
                                   combine, msg, row_len=tg.in_deg)
    assert_same(torch.from_numpy(np.ascontiguousarray(got)), want.numpy(),
                combine)
