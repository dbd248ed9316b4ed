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
rtol = atol = 1e-5; on a payload that cancels within a chunk, float sums
agree to float32 rounding of their terms (both sides round in float32).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graphs.structure import build_graph as ref_build_graph
from repro.kernels.coo_push import build_push_plan as ref_build_push_plan
from repro.kernels.coo_push import coo_push_pallas
from repro_torch.kernels import _build
from repro_torch.graphs import GRAPH_ARRAYS, graph_from_arrays, star
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


@pytest.mark.parametrize("msg", ("copy", "mul"))
def test_signed_cancelling_sums_are_the_reference_numerics(msg):
    """The float32 plain version sums a bin as the reference does, on a
    payload that cancels within a chunk: vertex 0 takes 128 in-edges
    (two 64-slot chunks) from sources 1..128 whose messages are +2^14,
    a term of ~1e-2, -2^14 (the same weight as its +2^14), another small
    term, and so on, beside a few ordinary bins. Both sides round in
    float32, so they agree to float32 rounding of the terms they add
    (≤ 2 (k + 1) 2^-24 Σ|term| over a destination's k terms), not to
    1e-5 of the result; each side's gap to the float64 sum is printed.
    """
    rng = np.random.default_rng(29)
    n, hub_deg = 160, 128
    src = np.concatenate([np.arange(1, hub_deg + 1),
                          rng.integers(0, n, size=300)])
    dst = np.concatenate([np.zeros(hub_deg, np.int64),
                          rng.integers(1, n, size=300)])
    w = rng.uniform(0.5, 2.0, size=src.shape[0]).astype(np.float32)
    ids = np.arange(n)
    x = rng.normal(scale=1e-2, size=n)
    x[ids % 4 == 1] = 2.0 ** 14
    x[ids % 4 == 3] = -2.0 ** 14
    x = x.astype(np.float32)
    neg = np.flatnonzero((src % 4 == 3) & (np.arange(src.size) < hub_deg))
    w[neg] = w[neg - 2]                   # each ±2^14 pair cancels
    g = ref_build_graph(src, dst, n=n, weights=w)
    tg = graph_from_arrays({f: np.asarray(getattr(g, f))
                            for f in GRAPH_ARRAYS},
                           n=g.n, m=g.m, d_ell=g.d_ell, device="cpu")
    active = np.ones(n, dtype=bool)
    want = np.asarray(coo_push_pallas(
        jnp.asarray(x), jnp.asarray(active), g.coo_src, g.coo_dst,
        g.coo_w, g.n, combine="sum", msg=msg, block_e=BLOCK_E,
        block_n=BIN_N, interpret=True, strategy="mxu",
        plan=ref_build_push_plan(g.coo_src, g.coo_dst, g.coo_w, g.n,
                                 BIN_N)))
    plan = build_push_plan(tg.coo_src, tg.coo_dst, tg.coo_w, tg.n, BIN_N)
    got = coo_push_mxu_plain(torch.from_numpy(x),
                             torch.from_numpy(active), plan, n, "sum", msg,
                             BLOCK_E).numpy()
    # the exact sum and the terms' magnitudes, per destination
    terms = x[src].astype(np.float64) * (w if msg == "mul" else 1.0)
    exact = np.bincount(dst, weights=terms, minlength=n)
    mass = np.bincount(dst, weights=np.abs(terms), minlength=n)
    k = np.bincount(dst, minlength=n)
    bound = 2.0 * (k + 1) * 2.0 ** -24 * mass
    gap = np.abs(got.astype(np.float64) - want)
    print(f"msg {msg}: hub sum {exact[0]:.6g} (terms up to 2^14): "
          f"reference {abs(want[0] - exact[0]):.3g} from the float64 sum, "
          f"plain {abs(got[0] - exact[0]):.3g}; plain to reference "
          f"{gap.max():.3g}, bound {bound[0]:.3g}")
    assert abs(exact[0]) < 1.0 < mass[0]   # the hub's large terms cancel
    assert (gap <= bound).all(), np.flatnonzero(gap > bound)


def scale_exp(mag) -> np.ndarray:
    """numpy emulation of the one-hot kernel's ``scale_exp``
    (``csrc/coo_push_mxu.cu``): from float32 magnitudes, the least e with
    ``mag < 2^e`` (-126 for a subnormal or zero magnitude)."""
    biased = (np.asarray(mag, np.float32).view(np.uint32) >> 23).astype(
        np.int64)
    return np.where(biased == 0, -126, biased - 126)


def scaled(m: np.ndarray, e: np.ndarray) -> np.ndarray:
    """float32 ``m`` times 2^-e in the kernel's two float32 steps."""
    ne = -np.asarray(e, np.int64)
    half = np.fix(ne / 2).astype(np.int64)
    return (m.astype(np.float32) * np.exp2(half).astype(np.float32)
            * np.exp2(ne - half).astype(np.float32)).astype(np.float32)


def split4(m: np.ndarray) -> np.ndarray:
    """numpy emulation of the kernel's four-part split of float32
    messages scaled below 1 in magnitude: part j the remainder rounded
    to the nearest multiple of 2^(-11 (j + 1)) by adding and taking away
    1.5 x 2^23 quanta. [4, ...] float32 parts."""
    r = m.astype(np.float32)
    parts = []
    for j in range(4):
        mag = np.float32(1.5 * 2.0 ** (12 - 11 * j))
        v = (r + mag) - mag
        parts.append(v)
        r = r - v
    return np.stack(parts)


def chunk_sums(m: np.ndarray, rows: np.ndarray, nrows: int, rng,
               row_scale: bool = True) -> np.ndarray:
    """numpy emulation of one staged chunk of the one-hot kernel's float
    sums: each row's messages scaled by 2^-e, e from the row's largest
    |message| (``row_scale``; else one e for the whole chunk, as a
    column-wide scale would), split in four, each part summed per row in
    float32 in a random order (the tensor cores' order is theirs), the
    four part sums added in float64 and scaled back. Asserts that every
    part sum is exact; returns float64 [nrows]."""
    mag = np.abs(m.astype(np.float32))
    if row_scale:
        top = np.zeros(nrows, np.float32)
        np.maximum.at(top, rows, mag)
        row_e = scale_exp(top)
    else:
        row_e = np.full(nrows, int(scale_exp(mag.max())))
    parts = split4(scaled(m, row_e[rows]))
    out = np.zeros(nrows)
    for j in range(4):
        acc = np.zeros(nrows, np.float32)
        for i in rng.permutation(m.size):
            acc[rows[i]] = np.float32(acc[rows[i]] + parts[j][i])
        exact = np.zeros(nrows)
        np.add.at(exact, rows, parts[j].astype(np.float64))
        assert (acc.astype(np.float64) == exact).all(), j
        out += acc.astype(np.float64)
    return out * np.exp2(row_e.astype(np.float64))


def chunk_messages(case: str, rng, k: int = 512, nrows: int = 64):
    """A staged chunk's float32 messages and their tile rows (sorted, as
    the dst-sorted plan gives them). ``cancelling``: ±2^14 pairs and
    small terms in every row; ``normal``; ``spread``: each row's
    magnitude drawn from 2^-60 .. 2^60 and each term's from 2^-15 ..
    2^15 of it, so the column spans about 2^150 and each row 2^30."""
    rows = np.sort(rng.integers(0, nrows, size=k))
    if case == "cancelling":
        m = rng.normal(scale=1e-2, size=k)
        m[0::4], m[2::4] = 2.0 ** 14, -2.0 ** 14
    elif case == "normal":
        m = rng.normal(size=k)
    else:
        row_mag = np.exp2(rng.integers(-60, 60, size=nrows))
        m = (rng.normal(size=k) * row_mag[rows]
             * np.exp2(rng.integers(-15, 16, size=k)))
    return m.astype(np.float32), rows


@pytest.mark.parametrize("case", ("cancelling", "normal", "spread"))
def test_scaled_parts_sum_exactly_in_float32(case):
    """The one-hot kernel's float32 sums (emulated): each message scaled
    by its row's 2^-e and split into four parts has at most 11
    significant bits a part (exact in TF32), and a part's sum over a
    chunk of 512 terms is exact in float32 in any order (asserted in
    :func:`chunk_sums`). So each destination's float32 result is within
    2 · 2^-24 · Σ|terms| of the float64 sum (one rounding at the end
    and a loss below 2^-45 of the row's scale a term), however the terms
    cancel or spread, where a split relative to each message's own
    exponent, summed in float32, is not."""
    rng = np.random.default_rng(3)
    m, rows = chunk_messages(case, rng)
    top = np.zeros(64, np.float32)
    np.maximum.at(top, rows, np.abs(m))
    parts = split4(scaled(m, scale_exp(top)[rows]))
    assert (np.abs(parts.astype(np.float64).sum(0)
                   - scaled(m, scale_exp(top)[rows])) <= 2.0 ** -45).all()
    for j in range(4):
        # at most 11 significant bits: the part times 2^(11 (j + 1)) is
        # an integer of at most 2^11 in magnitude
        q = parts[j].astype(np.float64) * 2.0 ** (11 * (j + 1))
        assert (q == np.rint(q)).all() and (np.abs(q) <= 2 ** 11).all()
    got = chunk_sums(m, rows, 64, rng).astype(np.float32)
    exact = np.zeros(64)
    np.add.at(exact, rows, m.astype(np.float64))
    mass = np.zeros(64)
    np.add.at(mass, rows, np.abs(m.astype(np.float64)))
    gap = np.abs(got.astype(np.float64) - exact)
    assert (gap <= 2.0 * 2.0 ** -24 * mass).all(), gap / mass


def test_scale_exp_bounds_every_magnitude():
    """``scale_exp`` gives the least power of two above each magnitude
    (for normal ones), and 2^-126 above subnormals and zero, within
    [-126, 128]; scaling by 2^-e in two float32 steps is exact and
    leaves the magnitude below 1."""
    rng = np.random.default_rng(4)
    mags = np.concatenate([
        np.abs(rng.normal(size=200)) * np.exp2(rng.integers(-126, 127,
                                                            size=200)),
        [0.0, 1e-45, 2.0 ** -130, 2.0 ** -126, 1.0, 2.0 ** 100,
         np.finfo(np.float32).max]]).astype(np.float32)
    e = scale_exp(mags)
    assert e.min() >= -126 and e.max() <= 128
    wide = mags.astype(np.float64)
    assert (wide < np.exp2(e.astype(np.float64))).all()
    normal = wide >= 2.0 ** -126
    assert (np.exp2(e[normal] - 1.0) <= wide[normal]).all()
    for sign in (1, -1):
        s = scaled(sign * mags, e)
        assert (s.astype(np.float64) == sign * wide
                * np.exp2(-e.astype(np.float64))).all()
        assert (np.abs(s) < 1).all()


def test_row_scales_keep_each_destination_relative():
    """Rows of one tile whose magnitudes lie 2^100 apart: with a scale
    per row each destination holds 2 · 2^-24 · Σ|terms|; with one scale
    for the whole column (the design the row scales replaced) the small
    rows lose every bit."""
    rng = np.random.default_rng(5)
    rows = np.repeat(np.arange(4), 64)
    m = (rng.normal(size=256) * np.exp2(np.repeat([50, 0, -20, -50], 64))
         ).astype(np.float32)
    exact = np.zeros(4)
    np.add.at(exact, rows, m.astype(np.float64))
    mass = np.zeros(4)
    np.add.at(mass, rows, np.abs(m.astype(np.float64)))
    bound = 2.0 * 2.0 ** -24 * mass
    got = chunk_sums(m, rows, 4, rng).astype(np.float32)
    assert (np.abs(got - exact) <= bound).all()
    column = chunk_sums(m, rows, 4, rng, row_scale=False).astype(np.float32)
    assert (np.abs(column - exact) > bound)[1:].all()
    assert column[3] == 0.0


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
