"""The port's binned push against the JAX package's ``coo_push_pallas``.

Same harness as ``test_torch_kernels.py``: the port's plain version on
the CPU against the reference kernel in Pallas interpret mode (strategy
"scan"), over combine × dtype × msg × payload rank, on the disjoint
union of the adversarial graph cases and on an edgeless graph (the
``[n, 3]`` payload cells are in ``test_torch_push_batched.py``, so that
each file stays well under a minute on one worker). The push
output keeps the message dtype (no int32 widening, unlike pull). The
port's bin plan must hold the same per-bin edges and pointers as the
reference's ``build_push_plan``.

The scan kernel's edge-parallel split (``push_units``: units of
``block_e`` edges per CTA, pieces of a unit per column-lane group) must
cover every real edge once, and a numpy emulation of the kernel — each
piece walks its slice, runs cut by piece or unit boundaries are combined
from their owners in the kernel's order — must equal the plain version
and the Pallas kernel, on a graph with a hub of more than 3 × 4,096
in-edges, with bins of 8 destinations and one bin of all n.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graphs.structure import build_graph as ref_build_graph
from repro.kernels.coo_push import build_push_plan as ref_build_push_plan
from repro.kernels.coo_push import coo_push_pallas
from repro.kernels.coo_push import default_bin_cap as ref_default_bin_cap
from repro_torch.graphs import GRAPH_ARRAYS, graph_from_arrays
from repro_torch.kernels.coo_push import (SCAN_THREADS, build_push_plan,
                                          coo_push, coo_push_plain,
                                          default_bin_cap, push_units,
                                          scan_unit_edges)
from repro_torch.kernels.ell_spmv import col_lanes
from test_torch_kernels import (GRID, GRID_IDS, SPLIT_CELLS, _acc_dtype,
                                _combine_acc, _identity, _messages,
                                assert_same, hub, msg_dtype,  # noqa: F401
                                payload, union_graph)

BIN_N = 8          # several bins on the 96-vertex union graph
ALIGN = 128        # one plan capacity for every case


@pytest.fixture(scope="module")
def push_graphs():
    u = union_graph()
    e = ref_build_graph(np.zeros(0, np.int64), np.zeros(0, np.int64),
                        n=u.n, d_ell=u.d_ell)
    out = {}
    for name, g in (("union", u), ("edgeless", e)):
        tg = graph_from_arrays({f: np.asarray(getattr(g, f))
                                for f in GRAPH_ARRAYS},
                               n=g.n, m=g.m, d_ell=g.d_ell, device="cpu")
        ref_plan = (ref_build_push_plan(g.coo_src, g.coo_dst, g.coo_w, g.n,
                                        BIN_N, align=ALIGN) if g.m else None)
        plan = build_push_plan(tg.coo_src, tg.coo_dst, tg.coo_w, tg.n,
                               BIN_N, align=ALIGN)
        out[name] = (g, tg, ref_plan, plan)
    return out


def test_plan_matches_reference(push_graphs):
    g, tg, ref, plan = push_graphs["union"]
    assert (plan.bin_n, plan.cap, plan.nb, plan.max_run) == \
        (ref.bin_n, ref.cap, ref.nb, ref.max_run)
    for f in ("src", "dst", "w", "ptr"):
        np.testing.assert_array_equal(getattr(plan, f).numpy(),
                                      np.asarray(getattr(ref, f)))
    # every bin is the contiguous in_ptr slice of the dst-sorted edges
    in_ptr = tg.in_ptr.numpy()
    for b in range(plan.nb):
        lo = in_ptr[min(b * BIN_N, tg.n)]
        hi = in_ptr[min((b + 1) * BIN_N, tg.n)]
        np.testing.assert_array_equal(plan.src[b, :hi - lo].numpy(),
                                      tg.coo_src[lo:hi].numpy())


def test_default_bin_cap_matches_reference():
    for args in ((96, 400, 56, 8, 128), (1 << 16, 1_818_572, 9816, 256, 128),
                 (1_960_000, 8_030_000, 8, 256, 128), (10, 0, 8, 256, 1)):
        assert default_bin_cap(*args) == ref_default_bin_cap(*args)


def check_push_cell(push_graphs, combine, dtype, msg, batch):
    """One grid cell: the port's binned push against the reference's on
    every push graph."""
    active = np.random.default_rng(5).random(push_graphs["union"][0].n) < 0.5
    for g, tg, ref_plan, plan in push_graphs.values():
        x = payload(g.n, dtype, batch)
        want = coo_push_pallas(jnp.asarray(x), jnp.asarray(active),
                               g.coo_src, g.coo_dst, g.coo_w, g.n,
                               combine=combine, msg=msg, block_e=ALIGN,
                               block_n=BIN_N, interpret=True,
                               plan=ref_plan, strategy="scan")
        got = coo_push(torch.from_numpy(x), torch.from_numpy(active),
                       tg.coo_src, tg.coo_dst, tg.coo_w, tg.n,
                       combine=combine, msg=msg, plan=plan)
        assert_same(got, want, combine)


VEC_CELLS = [(cell, i) for cell, i in zip(GRID, GRID_IDS)
             if cell[3] is None]


@pytest.mark.parametrize("combine,dtype,msg,batch", [c for c, _ in VEC_CELLS],
                         ids=[i for _, i in VEC_CELLS])
def test_coo_push_matches_pallas(push_graphs, combine, dtype, msg, batch):
    check_push_cell(push_graphs, combine, dtype, msg, batch)



def _graph(push_graphs, hub, case):  # noqa: F811
    return hub if case == "hub" else push_graphs["union"][:2]


@pytest.mark.parametrize("width", (1, 33))
@pytest.mark.parametrize("block_e", (64, 1024, 1 << 20))
@pytest.mark.parametrize("bins", ("8", "n"))
@pytest.mark.parametrize("case", ("union", "hub"))
def test_push_units_cover_every_edge_once(push_graphs, hub, case,  # noqa: F811
                                          bins, block_e, width):
    g, tg = _graph(push_graphs, hub, case)
    bin_n = 8 if bins == "8" else tg.n
    plan = build_push_plan(tg.coo_src, tg.coo_dst, tg.coo_w, tg.n, bin_n)
    units = push_units(plan, block_e, width)
    assert push_units(plan, block_e, width) is units   # cached per size
    e = scan_unit_edges(block_e, width)
    assert e == max(256, min(max(block_e, 256), 32768) // col_lanes(width))
    table = units.table.numpy()
    ub, lo = table[:, 0], table[:, 1]
    first = units.bin_first.numpy()
    seen = np.zeros(tg.m, np.int64)
    starts = plan.ptr.numpy()[:, 0]
    for b in range(plan.nb):
        eb = int(plan.ptr[b, -1])
        assert eb == plan.bin_edges[b]
        for u in range(first[b], first[b + 1]):
            assert ub[u] == b and lo[u] < eb
            assert tuple(table[u, 2:]) == (eb, first[b + 1] - first[b])
            hi = min(lo[u] + e, eb)
            base = int(tg.in_ptr[min(b * bin_n, tg.n)]) + starts[b]
            seen[base + lo[u]:base + hi] += 1
        assert first[b + 1] - first[b] == -(-eb // e)
    np.testing.assert_array_equal(seen, 1)
    np.testing.assert_array_equal(
        plan.empty.numpy(), np.flatnonzero(tg.in_deg.numpy() == 0))
    assert units.split == bool((np.diff(first) > 1).any())
    if case == "hub" and e < 4096:
        assert units.split


def emulate_scan_push(x, active, plan, n, combine, msg, block_e):
    """The scan kernel in numpy: each unit's pieces (warps) walk their
    slices, write runs they hold whole and keep head and tail partials of
    cut runs; the CTA walks each cut run from its owner through the heads
    in piece order, and the last unit of a bin walks the runs cut by
    units in unit order. Inside a piece the emulation combines in edge
    order, where the kernel's scan combines a sub-step's edges as a tree
    (float sums: both in float64)."""
    width = 1 if x.ndim == 1 else x.shape[1]
    pieces = SCAN_THREADS // 32          # a piece is a warp
    units = push_units(plan, block_e, width)
    mdt = msg_dtype(x.dtype, msg)
    adt = _acc_dtype(mdt, combine)
    ident = np.full(width, _identity(combine, adt), adt)
    src, dst = plan.src.numpy(), plan.dst.numpy()
    w = plan.w.numpy()
    x2 = x.reshape(n, width)
    out = np.full((n, width), _identity(combine, mdt), mdt)

    def val(b, e):
        u = src[b, e]
        if not (0 <= u < n and active[u]):
            return ident
        return _messages(x2[u:u + 1], w[b, e:e + 1], msg, mdt)[0].astype(adt)

    def put(k, v):
        out[k] = v.astype(mdt)

    ub, ulo = units.table[:, 0].numpy(), units.table[:, 1].numpy()
    first = units.bin_first.numpy()
    recs = {}
    for u in range(units.count):
        b, lo = int(ub[u]), int(ulo[u])
        eb = int(plan.bin_edges[b])
        hi = min(lo + units.edges, eb)
        per = -(-(-(-(hi - lo) // pieces)) // 32) * 32   # whole steps
        live = -(-(hi - lo) // per)
        rec = []                       # (h_open, mid, t_open, key, head, tail)
        for p in range(live):
            plo, phi = lo + p * per, min(lo + (p + 1) * per, hi)
            hk = dst[b, plo]
            h_open = plo > 0 and dst[b, plo - 1] == hk
            ck, acc, head, tail = hk, ident, None, None
            for e in range(plo, phi):
                if dst[b, e] != ck:
                    if h_open and ck == hk:
                        head = acc
                    else:
                        put(ck, acc)
                    ck, acc = dst[b, e], ident
                acc = _combine_acc(combine, acc, val(b, e))
            t_open = phi < eb and dst[b, phi] == ck
            mid = False
            if not t_open:
                if h_open and ck == hk:
                    head = acc
                else:
                    put(ck, acc)
            elif h_open and ck == hk:
                head, mid = acc, True
            else:
                tail = acc
            rec.append((h_open, mid, t_open, ck, head, tail))
        scope = [False, False, False, None, None, None]
        for p, (h_open, mid, t_open, key, head, tail) in enumerate(rec):
            if not t_open or mid:
                continue
            v, q = tail, p + 1
            while q < live:
                v = _combine_acc(combine, v, rec[q][4])
                if not rec[q][1]:
                    break
                q += 1
            if q < live:
                put(key, v)
            else:
                scope[2], scope[3], scope[5] = True, key, v
        if rec[0][0]:
            v, q = rec[0][4], 0
            while rec[q][1] and q + 1 < live:
                q += 1
                v = _combine_acc(combine, v, rec[q][4])
            scope[0], scope[4] = True, v
            if rec[q][1]:
                scope[1] = scope[2] = True
        recs[u] = scope
    for b in range(plan.nb):
        for u in range(first[b], first[b + 1]):
            h_open, mid, t_open, key, head, tail = recs[u]
            if not t_open or mid:
                continue
            v = tail
            for q in range(u + 1, first[b + 1]):
                v = _combine_acc(combine, v, recs[q][4])
                if not recs[q][1]:
                    break
            put(key, v)
    return out if x.ndim == 2 else out[:, 0]


@pytest.mark.parametrize("width", (None, 3, 33), ids=lambda b: f"b{b}")
@pytest.mark.parametrize("bins", ("8", "n"))
@pytest.mark.parametrize("combine,dtype,msg", SPLIT_CELLS,
                         ids=["-".join(c) for c in SPLIT_CELLS])
def test_scan_split_emulation_matches_plain_and_pallas(
        hub, combine, dtype, msg, bins, width):  # noqa: F811
    """block_e 1,024: units of 1,024 edges at width 1 (the hub's run
    crosses 12 units and 8 warp pieces of 128 edges in each) and of 256
    at width 3 (C = 4) and width 33 (8 pieces of 32 edges)."""
    g, tg = hub
    bin_n = 8 if bins == "8" else tg.n
    active = np.random.default_rng(2).random(tg.n) < 0.7
    x = payload(tg.n, dtype, width, seed=4)
    plan = build_push_plan(tg.coo_src, tg.coo_dst, tg.coo_w, tg.n, bin_n)
    got = emulate_scan_push(x, active, plan, tg.n, combine, msg, 1024)
    got = torch.from_numpy(np.ascontiguousarray(got))
    plain = coo_push_plain(torch.from_numpy(x), torch.from_numpy(active),
                           plan, tg.n, combine, msg)
    assert_same(got, plain.numpy(), combine)
    ref_plan = ref_build_push_plan(g.coo_src, g.coo_dst, g.coo_w, g.n,
                                   bin_n, align=ALIGN)
    want = coo_push_pallas(jnp.asarray(x), jnp.asarray(active), g.coo_src,
                           g.coo_dst, g.coo_w, g.n, combine=combine,
                           msg=msg, block_e=ALIGN, block_n=bin_n,
                           interpret=True, plan=ref_plan, strategy="scan")
    assert_same(got, want, combine)
