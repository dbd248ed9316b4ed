"""The port's ELL pull kernels against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; the
reference kernels run in Pallas interpret mode. Both get the same numpy
payloads over combine × dtype × msg × payload rank, on two graphs:

  * ``union`` — the disjoint union of ``graph_strategies``' ragged (hub),
    empty-rows, self-loop and duplicate-edge cases, so one ELL shape
    carries every adversarial row kind and the interpreter compiles once
    per cell;
  * ``edgeless`` — m = 0 on the same [n, d_ell] shape.

The full-scan pull also runs with ``row_len=in_deg`` (slots past a row's
in-degree unread) over the same grid, and its row plan (classes, hub
pieces) is emulated in plain numpy on a graph with a hub of more than
3 × 4,096 in-edges, at payload widths whose column lanes change the
class bounds and the piece size.

Tolerances: integer results and every min/max bit for bit; float sums
rtol = atol = 1e-5 (the port sums in float64, the reference in the
payload's type). Output dtypes must be equal, including the int32 → int64
widening of pull sums.

The CUDA kernels themselves are held against these plain versions on
the card by ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_strategies import CASES, build_case
from repro.graphs.structure import build_graph as ref_build_graph
from repro.kernels.ell_spmv import ell_spmv_pallas
from repro_torch.graphs import GRAPH_ARRAYS, graph_from_arrays
from repro_torch.graphs.structure import pad_values
from repro_torch.kernels import _build
from repro_torch.kernels.ell_pull_frontier import (default_pull_cap,
                                                   ell_pull_frontier)
from repro_torch.kernels.ell_spmv import (CHUNK, PULL_THREADS, SHORT_LANES,
                                          col_lanes, ell_row_plan, ell_spmv,
                                          ell_spmv_plain, row_class_bounds)

COMBINES = ("sum", "min", "max")
DTYPES = ("float32", "float64", "int32", "int64")
MSGS = ("copy", "mul", "add")
RANKS = (None, 3)
GRID = [(c, d, m, b) for c in COMBINES for d in DTYPES for m in MSGS
        for b in RANKS]
GRID_IDS = [f"{c}-{d}-{m}-{'b' + str(b) if b else 'vec'}"
            for c, d, m, b in GRID]
ROWS = 32          # static compacted-row capacity of the frontier tests


def union_graph():
    """Disjoint union of the four non-empty adversarial cases (n=24
    each), built by the reference."""
    parts = [build_case(c, 0) for c in CASES if c != "edgeless"]
    src, dst, w, off = [], [], [], 0
    for g in parts:
        src.append(np.asarray(g.coo_src) + off)
        dst.append(np.asarray(g.coo_dst) + off)
        w.append(np.asarray(g.coo_w))
        off += g.n
    return ref_build_graph(np.concatenate(src), np.concatenate(dst), n=off,
                           weights=np.concatenate(w))


@pytest.fixture(scope="module")
def graphs():
    u = union_graph()
    e = ref_build_graph(np.zeros(0, np.int64), np.zeros(0, np.int64),
                        n=u.n, d_ell=u.d_ell)
    out = {}
    for name, g in (("union", u), ("edgeless", e)):
        tg = graph_from_arrays({f: np.asarray(getattr(g, f))
                                for f in GRAPH_ARRAYS},
                               n=g.n, m=g.m, d_ell=g.d_ell, device="cpu")
        out[name] = (g, tg)
    return out


def payload(n: int, dtype: str, batch, seed: int = 7) -> np.ndarray:
    rng = np.random.default_rng(seed)
    shape = (n,) if batch is None else (n, batch)
    if dtype.startswith("float"):
        return rng.normal(size=shape).astype(dtype)
    return rng.integers(-50, 50, size=shape).astype(dtype)


def assert_same(got: torch.Tensor, want, combine: str):
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    if combine == "sum" and got.dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("combine,dtype,msg,batch", GRID, ids=GRID_IDS)
def test_ell_spmv_matches_pallas(graphs, combine, dtype, msg, batch):
    for g, tg in graphs.values():
        x = payload(g.n + 1, dtype, batch)
        x[-1] = 0                                  # the sentinel row
        want = ell_spmv_pallas(jnp.asarray(x), g.ell_idx, g.ell_w,
                               combine=combine, msg=msg, block_n=32,
                               interpret=True)
        got = ell_spmv(torch.from_numpy(x), tg.ell_idx, tg.ell_w,
                       combine=combine, msg=msg)
        assert_same(got, want, combine)


def test_num_sources_masks_indices_anywhere_in_a_row(graphs):
    """An index ≥ num_sources is the identity wherever it sits, not only
    in the padded tail (reference ``ell_spmv.py`` masks the whole row)."""
    g, tg = graphs["union"]
    x = payload(g.n + 1, "int64", None)
    ns = g.n // 2
    want = ell_spmv_pallas(jnp.asarray(x), g.ell_idx, g.ell_w,
                           combine="min", msg="copy", block_n=32,
                           interpret=True, num_sources=ns)
    got = ell_spmv(torch.from_numpy(x), tg.ell_idx, tg.ell_w,
                   combine="min", msg="copy", num_sources=ns)
    assert_same(got, want, "min")


def test_default_pull_cap_and_sentinel_rows():
    from repro.kernels.ell_pull_frontier import default_pull_cap as ref_cap
    for n, m, d in ((24, 96, 56), (1 << 16, 1_818_572, 9816),
                    (1_960_000, 8_030_000, 8), (5, 0, 8)):
        assert default_pull_cap(n, m, d) == ref_cap(n, m, d)
    # all-sentinel rows give the identity row
    x = torch.arange(5, dtype=torch.float32)
    idx = torch.zeros((4, 8), dtype=torch.int32)
    w = torch.ones((4, 8), dtype=torch.float32)
    rows = torch.full((3,), 4, dtype=torch.int32)
    out = ell_pull_frontier(x, idx, w, rows, combine="min", msg="copy")
    assert torch.isinf(out).all() and (out > 0).all()


def test_wrappers_take_the_plain_version_only_on_cpu(graphs):
    """A CPU tensor runs the plain version and launches nothing; a
    device the kernels do not serve raises instead of falling back."""
    _, tg = graphs["union"]
    before = _build.launch_counts()
    x = pad_values(torch.ones(tg.n))
    got = ell_spmv(x, tg.ell_idx, tg.ell_w, combine="sum", msg="mul")
    torch.testing.assert_close(got, ell_spmv_plain(x, tg.ell_idx, tg.ell_w,
                                                   "sum", "mul"))
    assert _build.launch_counts() == before
    with pytest.raises(ValueError, match="cuda or cpu"):
        ell_spmv(x.to("meta"), tg.ell_idx.to("meta"), tg.ell_w.to("meta"))



@pytest.mark.parametrize("combine,dtype,msg,batch", GRID, ids=GRID_IDS)
def test_ell_spmv_row_len_matches_pallas(graphs, combine, dtype, msg,
                                         batch):
    """Reading only each row's first in_deg slots gives the reference's
    full-row result (an ELL row holds its real slots first)."""
    for g, tg in graphs.values():
        x = payload(g.n + 1, dtype, batch, seed=11)
        x[-1] = 0
        want = ell_spmv_pallas(jnp.asarray(x), g.ell_idx, g.ell_w,
                               combine=combine, msg=msg, block_n=32,
                               interpret=True)
        got = ell_spmv(torch.from_numpy(x), tg.ell_idx, tg.ell_w,
                       combine=combine, msg=msg, row_len=tg.in_deg)
        assert_same(got, want, combine)


HUB_N = 64
HUB_DEG = 3 * 4096 + 5       # a hub split into pieces at every width


def hub_edges(seed: int = 0):
    """A hub of HUB_DEG in-edges (duplicate sources), a medium row of
    600, a row of 40, short rows of 1-6 and empty rows, on HUB_N
    vertices."""
    rng = np.random.default_rng(seed)
    dst = [np.zeros(HUB_DEG, np.int64), np.full(600, 5), np.full(40, 9)]
    for v in range(10, 40):
        dst.append(np.full(int(rng.integers(1, 7)), v))
    dst = np.concatenate(dst)
    src = rng.integers(0, HUB_N, size=dst.shape[0])
    w = rng.uniform(0.5, 2.0, size=dst.shape[0]).astype(np.float32)
    return src, dst, w


@pytest.fixture(scope="module")
def hub():
    src, dst, w = hub_edges()
    g = ref_build_graph(src, dst, n=HUB_N, weights=w)
    tg = graph_from_arrays({f: np.asarray(getattr(g, f))
                            for f in GRAPH_ARRAYS},
                           n=g.n, m=g.m, d_ell=g.d_ell, device="cpu")
    return g, tg


@pytest.mark.parametrize("width", (1, 3, 16, 33))
@pytest.mark.parametrize("case", ("union", "hub"))
def test_ell_row_plan_covers_every_row_once(graphs, hub, case, width):
    _, tg = hub if case == "hub" else graphs["union"]
    plan = ell_row_plan(tg.in_deg, tg.n, tg.d_ell, width)
    bounds, piece = row_class_bounds(width)
    assert plan.piece == piece and plan.col_lanes == col_lanes(width)
    rows = plan.rows.numpy()
    np.testing.assert_array_equal(np.sort(rows), np.arange(tg.n))
    lens = tg.in_deg.numpy()
    off = plan.class_off
    assert off[0] == 0 and off[-1] == tg.n and len(off) == len(bounds) + 2
    for k in range(len(bounds) + 1):
        part = rows[off[k]:off[k + 1]]
        assert (np.diff(part) > 0).all()          # ascending row ids
        want = np.searchsorted(bounds, lens[part], side="left")
        np.testing.assert_array_equal(want, k)
    hubs = rows[off[-2]:]
    first = plan.hub_first.numpy()
    np.testing.assert_array_equal(np.diff(first), -(-lens[hubs] // piece))
    np.testing.assert_array_equal(
        plan.piece_hub.numpy(), np.repeat(np.arange(hubs.size),
                                          np.diff(first)))
    assert plan.pieces == first[-1] and not plan.counters.any()
    if case == "hub":
        assert hubs.size >= 1 and first[-1] > hubs.size   # a split hub


def _np_combine(combine, a, b):
    if combine == "sum":
        return a + b
    return np.minimum(a, b) if combine == "min" else np.maximum(a, b)


def _acc_dtype(mdt: np.dtype, combine: str) -> np.dtype:
    if combine != "sum":
        return mdt
    return np.dtype(np.float64 if mdt.kind == "f" else np.int64)


def _identity(combine, dt):
    dt = np.dtype(dt)
    if combine == "sum":
        return dt.type(0)
    big = np.inf if dt.kind == "f" else np.iinfo(dt).max
    small = -np.inf if dt.kind == "f" else np.iinfo(dt).min
    return dt.type(big if combine == "min" else small)


def msg_dtype(x_dtype, msg: str) -> np.dtype:
    """The kernels' message type: the payload's for a copy, else its
    promotion with the float32 weight as torch promotes (float32 for
    every integer type)."""
    if msg == "copy":
        return np.dtype(x_dtype)
    return np.dtype(np.float64 if x_dtype == np.float64 else np.float32)


def _messages(xs, ws, msg, mdt):
    xs = xs.astype(mdt)
    if msg == "copy":
        return xs
    ws = ws.astype(mdt)
    ws = ws[:, None] if xs.ndim == 2 else ws
    return xs * ws if msg == "mul" else xs + ws


def emulate_ell_spmv(x, tg, plan, combine, msg):
    """The kernel's decomposition in numpy: a row of a short or medium
    class is walked by S slot lanes (lane l takes the CHUNK-slot chunks
    l, l + S, ... in order) and the lanes combine by an xor butterfly; a
    hub piece by 256 / C slot lanes, a butterfly inside each warp, then
    the warps in order, then the pieces of the hub in order."""
    n, d = tg.ell_idx.shape
    idx, ew = tg.ell_idx.numpy(), tg.ell_w.numpy()
    lens = np.clip(tg.in_deg.numpy(), 0, d)
    width = 1 if x.ndim == 1 else x.shape[1]
    c = plan.col_lanes
    mdt = msg_dtype(x.dtype, msg)
    adt = _acc_dtype(np.dtype(mdt), combine)
    odt = np.int64 if (combine == "sum" and mdt == np.int32) else mdt
    ident = _identity(combine, adt)
    x2 = x.reshape(x.shape[0], width)

    def lane_sums(v, lo, hi, lanes):
        acc = np.full((lanes, width), ident, adt)
        for lane in range(lanes):
            for q in range(lo + CHUNK * lane, hi, CHUNK * lanes):
                for j in range(q, min(q + CHUNK, hi)):
                    s = idx[v, j]
                    if 0 <= s < n:
                        m = _messages(x2[s:s + 1], ew[v, j:j + 1], msg, mdt)
                        acc[lane] = _combine_acc(combine, acc[lane],
                                                 m[0].astype(adt))
        return acc

    def butterfly(acc):
        acc = acc.copy()
        off = acc.shape[0] // 2
        while off >= 1:
            acc = _combine_acc(combine, acc, acc[np.arange(acc.shape[0])
                                                 ^ off])
            off //= 2
        return acc[0]

    out = np.empty((n, width), odt)
    off = plan.class_off
    rows = plan.rows.numpy()
    for k, g in enumerate(SHORT_LANES + (32,)):
        s = min(32, g * c) // c
        for v in rows[off[k]:off[k + 1]]:
            out[v] = butterfly(lane_sums(v, 0, lens[v], s)).astype(odt)
    first = plan.hub_first.numpy()
    warp_lanes = 32 // c
    for h, v in enumerate(rows[off[-2]:]):
        parts = []
        for q in range(first[h + 1] - first[h]):
            lo = q * plan.piece
            acc = lane_sums(v, lo, min(lo + plan.piece, lens[v]),
                            PULL_THREADS // c)
            warps = [butterfly(acc[w * warp_lanes:(w + 1) * warp_lanes])
                     for w in range(PULL_THREADS // 32)]
            r = warps[0]
            for wv in warps[1:]:
                r = _combine_acc(combine, r, wv)
            parts.append(r)
        r = parts[0]
        if len(parts) > 1:
            r = np.full(width, ident, adt)
            for part in parts:
                r = _combine_acc(combine, r, part)
        out[v] = r.astype(odt)
    return out if x.ndim == 2 else out[:, 0]


def _combine_acc(combine, a, b):
    with np.errstate(over="ignore"):
        return _np_combine(combine, a, b)


SPLIT_CELLS = [("sum", "float32", "mul"), ("sum", "int32", "copy"),
               ("min", "float64", "add"), ("max", "int64", "add")]


@pytest.mark.parametrize("width", (None, 3, 33), ids=lambda b: f"b{b}")
@pytest.mark.parametrize("combine,dtype,msg", SPLIT_CELLS,
                         ids=["-".join(c) for c in SPLIT_CELLS])
def test_ell_split_emulation_matches_plain_and_pallas(hub, combine, dtype,
                                                      msg, width):
    """The plan's decomposition, reduced piece by piece and combined in
    the kernel's order, equals the plain version and the Pallas kernel
    on the hub graph (hub pieces of 8,192, 2,048 and 256 slots)."""
    g, tg = hub
    x = payload(g.n + 1, dtype, width, seed=3)
    x[-1] = 0
    plan = ell_row_plan(tg.in_deg, tg.n, tg.d_ell, width or 1)
    got = emulate_ell_spmv(x, tg, plan, combine, msg)
    plain = ell_spmv_plain(torch.from_numpy(x), tg.ell_idx, tg.ell_w,
                           combine, msg, row_len=tg.in_deg)
    assert_same(torch.from_numpy(np.ascontiguousarray(got)), plain.numpy(),
                combine)
    want = ell_spmv_pallas(jnp.asarray(x), g.ell_idx, g.ell_w,
                           combine=combine, msg=msg, block_n=32,
                           interpret=True)
    assert_same(torch.from_numpy(np.ascontiguousarray(got)), want, combine)
