"""Binned, contention-free push relaxation.

Port of ``repro.kernels.coo_push.coo_push_pallas`` (both strategies,
"scan" and "mxu"), with its phase-1 binning:

**Phase 1 — binning** (:func:`build_push_plan`, host, once per graph).
Bin ``b`` owns destinations ``[b·bin_n, (b+1)·bin_n)``. The COO edges are
dst-sorted, so bin ``b`` is the contiguous slice
``in_ptr[b·bin_n] : in_ptr[min((b+1)·bin_n, n)]`` of the edge list; the
plan packs it into row ``b`` of ``[nb, cap]`` arrays (sentinel ``n`` /
weight 0 beyond the bin's edges) beside a within-bin CSR pointer
``ptr[nb, bin_n+1]``. This is the layout the JAX package builds through
``pa_regroup_by_dst`` and gathers in-trace in ``bin_plan_traced``.

**Phase 2 — per-bin reduce** (:func:`coo_push`). Every destination
combines ``msg(x[src], w)`` over its in-edges whose source is active,
by one of two strategies (``PUSH_STRATEGIES``, the tuner's choice):

  * ``"scan"`` — ``csrc/coo_push.cu``: edge-parallel. Each bin's real
    edges are cut into units of ``block_e`` edges (:func:`push_units`),
    one CTA each; each warp walks a contiguous slice 32 edges a step and
    combines each destination's run by a segmented shuffle scan, and
    runs cut by a warp or unit boundary are combined in a fixed order
    (no atomics on results).
    Float sums accumulate in float64 and round once. Plain version:
    :func:`coo_push_plain`.
  * ``"mxu"`` — ``csrc/coo_push_mxu.cu``: float32 sums as one-hot
    products on the tensor cores (wgmma), each destination tile of 64
    rows multiplying only its own edges; min, max, integer and float64
    sums as a window reduce over the same tiles. Each tile's edge range
    is cut into units of ``block_e`` edges (:func:`mxu_units`), one CTA
    each, and a tile cut across units is combined in unit order by its
    last CTA. Float32 sums scale each message by its destination's
    largest term of the chunk and split it into four parts, so that each
    part's sum is exact on the tensor cores. Plain version:
    :func:`coo_push_mxu_plain`, which keeps the JAX package's numerics
    (each ``block_e`` chunk reduced in the message dtype, then chunks
    combined). Bins are at most 256 destinations wide, and payloads at
    most 256 columns, on the card.

On a CUDA tensor :func:`coo_push` launches the strategy's kernel; on a
CPU tensor it runs the plain version. Destinations with no active
in-edge hold the identity. The output dtype is the message promotion,
with no int widening.

``block_e`` is the edges of a work unit (for the scan, the edges of a
CTA at width 1: clamped to 256–32,768 and divided by the column lanes
of wider payloads, :func:`scan_unit_edges`; for the one-hot kernel the
edges of a tile's unit, clamped to 256–1,024, :func:`mxu_unit_edges`,
which it stages in chunks of at most 512 for the tensor cores and 1,024
for the window reduce). The plan's capacity stays aligned to 128
whatever ``block_e`` is; the kernels mask the ragged last chunk. (The
JAX package aligns the capacity to ``block_e``, which for the tuner's
whole-edge-list rung would make a ``[nb, m]`` plan.)
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..graphs.structure import resolve_device
from ..sparse.segment import reduce_identity
from ._build import check_status, load
from .ell_spmv import (_PLAIN_CHUNK, COMBINE_CODES, DTYPE_CODES, MSG_CODES,
                       _msg_dtype, _stream, apply_msg, col_lanes)

__all__ = ["PushBinPlan", "PushUnits", "build_push_plan", "push_units",
           "scan_unit_edges", "MxuUnits", "mxu_units", "mxu_unit_edges",
           "default_bin_cap",
           "coo_push", "coo_push_plain", "coo_push_mxu_plain",
           "DEFAULT_BIN_N", "DEFAULT_BLOCK_E", "MXU_MAX_BIN", "MXU_MAX_WIDTH",
           "MXU_TILE", "SCAN_THREADS", "PUSH_STRATEGIES"]

PUSH_STRATEGIES = ("scan", "mxu")
# destinations per bin unless the caller (the tuner) says otherwise
DEFAULT_BIN_N = 256
# edge chunk per staging pass (the JAX package's default block_e)
DEFAULT_BLOCK_E = 512
# widest bin the one-hot kernel takes (the tuner's one-hot grid)
MXU_MAX_BIN = 256
# destinations of a one-hot tile (wgmma's 64 rows) and the widest
# payload (the window reduce keeps a tile's 64 x B accumulators in
# shared memory)
MXU_TILE = 64
MXU_MAX_WIDTH = 256
# edges of one work unit (a CTA) of the scan kernel: block_e, clamped;
# the CTA's threads, whose warps each walk one slice of the unit
SCAN_UNIT_MIN, SCAN_UNIT_MAX = 256, 32768
SCAN_THREADS = 256


def _round_up(x: int, q: int) -> int:
    return -(-x // q) * q


@dataclasses.dataclass(frozen=True, eq=False)
class PushBinPlan:
    """Phase-1 output: ``src/dst/w`` are ``[nb, cap]`` (row ``b`` holds
    bin ``b``'s dst-sorted edges, then padding); ``ptr`` is int32
    ``[nb, bin_n+1]`` (destination ``b·bin_n + j`` owns slots
    ``ptr[b, j]:ptr[b, j+1]`` of row ``b``). ``max_run`` is the longest
    single-destination run. ``empty`` lists the destinations with no
    in-edge and ``bin_edges`` (host) each bin's edge count; ``units``
    caches the scan kernel's :func:`push_units` by unit size and the
    one-hot kernel's :func:`mxu_units` by ``("mxu", unit size)``."""
    src: torch.Tensor
    dst: torch.Tensor
    w: torch.Tensor
    ptr: torch.Tensor
    bin_n: int
    cap: int
    nb: int
    max_run: int
    empty: torch.Tensor
    bin_edges: np.ndarray = dataclasses.field(repr=False)
    units: dict = dataclasses.field(default_factory=dict, repr=False)


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def build_push_plan(src, dst, w, n: int, bin_n: int = DEFAULT_BIN_N,
                    align: int = 128, device=None) -> PushBinPlan:
    """Host-side binning of dst-sorted edges (``src/dst/w`` of length m,
    tensors or arrays). Each bin is a contiguous slice of the edge list;
    ``cap`` is the largest bin rounded up to ``align``. The plan lands on
    ``device`` (default: ``src``'s device if it is a tensor, else the
    card)."""
    if device is None and isinstance(src, torch.Tensor):
        dev = src.device
    else:
        dev = resolve_device(device)
    src, dst = _host(src).astype(np.int32), _host(dst).astype(np.int32)
    w = _host(w).astype(np.float32)
    m = int(src.shape[0])
    nb = max(1, _round_up(n, bin_n) // bin_n)
    in_ptr = np.searchsorted(dst, np.arange(n + 1)).astype(np.int64)
    starts = np.minimum(np.arange(nb + 1, dtype=np.int64) * bin_n, n)
    off = in_ptr[starts]
    counts = np.diff(off)
    cap = max(1, _round_up(int(counts.max()) if m else 0, align))
    slot = np.arange(cap, dtype=np.int64)
    in_bin = slot[None, :] < counts[:, None]
    pos = np.where(in_bin, off[:-1, None] + slot[None, :], 0)
    take = (lambda a, fill: np.where(in_bin, a[pos], fill)  # noqa: E731
            if m else np.full((nb, cap), fill, a.dtype))
    ridx = np.minimum(starts[:-1, None]
                      + np.arange(bin_n + 1, dtype=np.int64)[None, :], n)
    ptr = (in_ptr[ridx] - off[:-1, None]).astype(np.int32)
    runs = np.diff(ptr, axis=1)
    max_run = int(runs.max()) if runs.size else 1

    def dev_(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return PushBinPlan(src=dev_(take(src, n).astype(np.int32)),
                       dst=dev_(take(dst, n).astype(np.int32)),
                       w=dev_(take(w, 0).astype(np.float32)),
                       ptr=dev_(ptr), bin_n=int(bin_n), cap=int(cap),
                       nb=int(nb), max_run=max(max_run, 1),
                       empty=dev_(np.flatnonzero(np.diff(in_ptr) == 0)
                                  .astype(np.int32)),
                       bin_edges=counts)


def scan_unit_edges(block_e: int, width: int = 1) -> int:
    """Edges one CTA of the scan kernel walks for ``block_e`` and
    payloads of ``width`` columns: ``block_e`` clamped to 256–32,768 at
    width 1; C column lanes (:func:`col_lanes`) load C values per edge,
    so a CTA takes 1/C of that, but never fewer than 256 edges."""
    e = min(max(int(block_e), SCAN_UNIT_MIN), SCAN_UNIT_MAX)
    return int(max(SCAN_UNIT_MIN, e // col_lanes(width)))


@dataclasses.dataclass(frozen=True, eq=False)
class PushUnits:
    """The scan kernel's work units over a plan: unit ``u`` walks edges
    ``lo : lo + edges`` (cut at the bin's end) of its bin, where
    ``table[u] = (bin, lo, the bin's edge count, the bin's unit count)``
    (int32, one 16-byte load); bin ``b`` owns units
    ``bin_first[b]:bin_first[b+1]`` (none when it has no edge).
    ``counters`` (one per bin, zero between launches) let the last unit
    of a bin find itself; ``split`` says whether any bin has more than
    one unit."""
    edges: int
    table: torch.Tensor
    bin_first: torch.Tensor
    counters: torch.Tensor
    split: bool

    @property
    def count(self) -> int:
        return int(self.table.shape[0])


def push_units(plan: PushBinPlan, block_e: int,
               width: int = 1) -> PushUnits:
    """The units of ``scan_unit_edges(block_e, width)`` edges over
    ``plan``, built on the host once per unit size and cached on the
    plan."""
    e = scan_unit_edges(block_e, width)
    hit = plan.units.get(e)
    if hit is not None:
        return hit
    edges = plan.bin_edges.astype(np.int64)
    per_bin = -(-edges // e)
    first = np.zeros(plan.nb + 1, dtype=np.int64)
    np.cumsum(per_bin, out=first[1:])
    unit_bin = np.repeat(np.arange(plan.nb, dtype=np.int64), per_bin)
    table = np.stack([unit_bin,
                      (np.arange(first[-1], dtype=np.int64)
                       - first[unit_bin]) * e,
                      edges[unit_bin], per_bin[unit_bin]], axis=1)
    dev = plan.ptr.device

    def dev_(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    units = PushUnits(edges=e, table=dev_(table), bin_first=dev_(first),
                      counters=torch.zeros(plan.nb, dtype=torch.int32,
                                           device=dev),
                      split=bool((per_bin > 1).any()))
    plan.units[e] = units
    return units


# edges of a unit of the one-hot kernel: a tile's range is cut into
# units of at most MXU_UNIT_MAX edges, so that a hub tile spreads over
# many CTAs (longer units leave one CTA walking a hub alone)
MXU_UNIT_MIN, MXU_UNIT_MAX = 256, 1024


def mxu_unit_edges(block_e: int) -> int:
    """Edges of a unit of the one-hot kernel: ``block_e`` clamped to
    256–1,024."""
    return int(min(max(int(block_e), MXU_UNIT_MIN), MXU_UNIT_MAX))


@dataclasses.dataclass(frozen=True, eq=False)
class MxuUnits:
    """The one-hot kernel's work units over a plan. Bin ``b``'s tile of
    destinations ``r0 : r0 + rows`` (bin-relative, ``rows`` at most
    :data:`MXU_TILE`, tiles past ``n`` left out) owns the plan slots
    ``ptr[b, r0] : ptr[b, r0 + 64]`` (clipped to the bin), cut into units
    of ``edges`` slots; a tile with no edge has one empty unit.
    ``table[u] = (b, r0, rows, lo, hi, k, nu, rec0)`` (int32, two 16-byte
    loads): unit ``u`` reduces slots ``lo : hi``, the ``k``-th of its
    tile's ``nu`` units. A tile of ``nu > 1`` units writes its partials
    to records ``rec0 : rec0 + nu`` and counts arrivals in
    ``counters[rec0]`` (zero between launches); ``rec0 = -1`` otherwise.
    ``records`` is the number of records."""
    edges: int
    table: torch.Tensor
    counters: torch.Tensor
    records: int

    @property
    def count(self) -> int:
        return int(self.table.shape[0])


def mxu_units(plan: PushBinPlan, n: int, block_e: int) -> MxuUnits:
    """The units of ``mxu_unit_edges(block_e)`` edges over ``plan`` (of
    ``n`` destinations), built on the host once per unit size and cached
    on the plan."""
    e = mxu_unit_edges(block_e)
    key = ("mxu", e)
    hit = plan.units.get(key)
    if hit is not None:
        return hit
    ptr = plan.ptr.cpu().numpy().astype(np.int64)
    tiles = -(-plan.bin_n // MXU_TILE)
    b = np.repeat(np.arange(plan.nb, dtype=np.int64), tiles)
    r0 = np.tile(np.arange(tiles, dtype=np.int64) * MXU_TILE, plan.nb)
    r1 = np.minimum(r0 + MXU_TILE, plan.bin_n)
    rows = np.minimum(r1, n - b * plan.bin_n) - r0
    keep = rows > 0
    b, r0, r1, rows = b[keep], r0[keep], r1[keep], rows[keep]
    lo, hi = ptr[b, r0], ptr[b, r1]
    nu = np.maximum(1, -(-(hi - lo) // e))
    tile = np.repeat(np.arange(b.shape[0], dtype=np.int64), nu)
    first = np.zeros(b.shape[0] + 1, dtype=np.int64)
    np.cumsum(nu, out=first[1:])
    k = np.arange(first[-1], dtype=np.int64) - first[tile]
    ulo = lo[tile] + k * e
    uhi = np.minimum(ulo + e, hi[tile])
    split = nu > 1
    rec0 = np.full(b.shape[0], -1, dtype=np.int64)
    rec0[split] = np.concatenate([[0], np.cumsum(nu[split])[:-1]])
    records = int(nu[split].sum())
    table = np.stack([b[tile], r0[tile], rows[tile], ulo, uhi, k, nu[tile],
                      rec0[tile]], axis=1)
    dev = plan.ptr.device
    units = MxuUnits(
        edges=e,
        table=torch.from_numpy(np.ascontiguousarray(table, np.int32)).to(dev),
        counters=torch.zeros(max(records, 1), dtype=torch.int32, device=dev),
        records=records)
    plan.units[key] = units
    return units


def default_bin_cap(n: int, m: int, d_ell: int, bin_n: int,
                    align: int) -> int:
    """Static bin capacity of the JAX package's traced binning pass:
    twice the mean bin load with at least one full max-degree row, never
    more than the whole edge list."""
    nb = max(1, _round_up(n, bin_n) // bin_n)
    mean = -(-max(m, 1) // nb)
    return _round_up(min(max(m, 1), max(d_ell, 2 * mean)), max(align, 1))


def coo_push_plain(x: torch.Tensor, active: torch.Tensor,
                   plan: PushBinPlan, n: int, combine: str = "sum",
                   msg: str = "mul") -> torch.Tensor:
    """Plain PyTorch version of the binned reduce over ``plan``."""
    mdt = _msg_dtype(x.dtype, plan.w.dtype, msg)
    slot = torch.arange(plan.cap, device=x.device)
    edges = plan.ptr[:, -1:].to(torch.int64)
    src = plan.src.to(torch.int64)
    ok = (slot[None, :] < edges) & (src >= 0) & (src < n)
    safe = torch.where(ok, src, 0)
    ok = (ok & active[safe]).flatten()
    msgs = apply_msg(x[safe.flatten()], plan.w.flatten(), msg, mdt)
    dst = torch.where(ok, plan.dst.flatten().to(torch.int64), n)
    if ok.ndim < msgs.ndim:
        ok = ok[:, None]
    shape = (n + 1,) + tuple(x.shape[1:])
    if combine == "sum":
        acc = torch.float64 if mdt.is_floating_point else torch.int64
        out = torch.zeros(shape, dtype=acc, device=x.device)
        out.index_add_(0, dst, torch.where(ok, msgs.to(acc), 0))
    else:
        out = torch.full(shape, reduce_identity(combine, mdt), dtype=mdt,
                         device=x.device)
        idx = dst.reshape((-1,) + (1,) * (msgs.ndim - 1)).expand_as(msgs)
        out.scatter_reduce_(0, idx, msgs,
                            reduce="amin" if combine == "min" else "amax",
                            include_self=True)
    return out[:n].to(mdt)


def coo_push_mxu_plain(x: torch.Tensor, active: torch.Tensor,
                       plan: PushBinPlan, n: int, combine: str = "sum",
                       msg: str = "mul",
                       block_e: int = DEFAULT_BLOCK_E) -> torch.Tensor:
    """Plain PyTorch version of the one-hot strategy, with the JAX
    package's numerics: each ``block_e`` chunk of a bin is reduced in the
    message dtype — ``onehot[bin_n, block_e] @ msgs`` for float sums, a
    masked window reduce for min, max and integer sums — and the chunks
    are combined in order. A float32 chunk's product is formed exactly
    (in float64) and rounded once: how a float32 product rounds inside a
    chunk is the device's choice (on a 12,293-term hub the card's float32
    matmul left 1e-5 of the kernel's sums, which held 1e-5 of the
    float64 sum), and the exactly rounded chunk is the one the float32
    sum defines. Inactive and padded slots carry the identity."""
    mdt = _msg_dtype(x.dtype, plan.w.dtype, msg)
    nb, cap, bin_n = plan.nb, plan.cap, plan.bin_n
    ident = reduce_identity(combine, mdt)
    slot = torch.arange(cap, device=x.device)
    src, dst = plan.src.to(torch.int64), plan.dst.to(torch.int64)
    valid = ((slot[None, :] < plan.ptr[:, -1:].to(torch.int64))
             & (dst >= 0) & (dst < n) & (src >= 0) & (src < n))
    safe = torch.where(valid, src, 0)
    ok = valid & active[safe]
    msgs = apply_msg(x[safe], plan.w, msg, mdt)          # [nb, cap(, B)]
    if msgs.ndim == 2:
        msgs = msgs[..., None]
    msgs = torch.where(ok[..., None], msgs, ident)
    base = torch.arange(nb, device=x.device)[:, None] * bin_n
    rel = torch.where(valid, dst - base, bin_n)         # [nb, cap]
    width = msgs.shape[-1]
    be = max(1, min(block_e, cap))
    rows = torch.arange(bin_n, device=x.device)[None, :, None]
    float_sum = combine == "sum" and mdt.is_floating_point
    acc = torch.full((nb, bin_n, width), ident, dtype=mdt, device=x.device)
    # bins per group bounds the expanded [g, bin_n, be, B] window
    group = max(1, _PLAIN_CHUNK // (bin_n * be * width))
    for b0 in range(0, nb, group):
        part = acc[b0:b0 + group]
        for e0 in range(0, cap, be):
            sel = rel[b0:b0 + group, None, e0:e0 + be] == rows
            m = msgs[b0:b0 + group, e0:e0 + be]       # [g, be, B]
            if float_sum:
                local = torch.matmul(sel.to(torch.float64),
                                     m.to(torch.float64)).to(mdt)
            else:
                expanded = torch.where(sel[..., None], m[:, None], ident)
                if combine == "sum":
                    local = expanded.sum(dim=2).to(mdt)   # wraps like JAX
                elif combine == "max":
                    local = expanded.amax(dim=2)
                else:
                    local = expanded.amin(dim=2)
            if combine == "sum":
                part += local
            elif combine == "max":
                torch.maximum(part, local, out=part)
            else:
                torch.minimum(part, local, out=part)
    out = acc.reshape(nb * bin_n, width)[:n]
    return out if x.ndim == 2 else out[:, 0]


def coo_push(x: torch.Tensor, active: torch.Tensor, src: torch.Tensor,
             dst: torch.Tensor, w: torch.Tensor, n: int,
             combine: str = "sum", msg: str = "mul",
             plan: Optional[PushBinPlan] = None, strategy: str = "scan",
             block_e: int = DEFAULT_BLOCK_E,
             bin_n: int = DEFAULT_BIN_N) -> torch.Tensor:
    """Two-phase push-combine over dst-sorted COO edges.

    x: [n] or [n, B] source payloads; active: bool[n] frontier; src/dst:
    int32 [m] (sorted by dst); w: float32 [m]. Returns [n] or [n, B];
    destinations with no active in-edge hold the combine identity.
    ``plan`` is the cached phase-1 layout (built here with ``bin_n``
    destinations per bin when absent; a given plan's own bin width
    rules). ``strategy`` picks the reduce ("scan" | "mxu") and
    ``block_e`` the edges of a work unit.
    """
    if strategy not in PUSH_STRATEGIES:
        raise ValueError(f"strategy={strategy!r} not in {PUSH_STRATEGIES}")
    if combine not in COMBINE_CODES or msg not in MSG_CODES:
        raise ValueError(f"unsupported combine={combine!r} / msg={msg!r}")
    if x.dtype not in DTYPE_CODES or x.ndim not in (1, 2):
        raise ValueError(f"payload {x.dtype} rank {x.ndim} not in "
                         "f32/f64/i32/i64 × rank 1/2")
    if active.dtype != torch.bool or active.shape != (n,) \
            or x.shape[0] != n:
        raise ValueError("x must have n rows and active be bool [n]")
    odt = _msg_dtype(x.dtype, w.dtype, msg)
    if src.shape[0] == 0:
        # edgeless graph: every destination holds the combine identity
        return torch.full((n,) + tuple(x.shape[1:]),
                          reduce_identity(combine, odt), dtype=odt,
                          device=x.device)
    if plan is None:
        plan = build_push_plan(src, dst, w, n, bin_n)
    if x.device.type == "cpu":
        if strategy == "mxu":
            return coo_push_mxu_plain(x, active, plan, n, combine, msg,
                                      block_e)
        return coo_push_plain(x, active, plan, n, combine, msg)
    if x.device.type != "cuda":
        raise ValueError(f"coo_push runs on cuda or cpu, not {x.device}")
    devs = {t.device for t in (x, active, plan.src, plan.w, plan.ptr)}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {devs}")
    width = 1 if x.ndim == 1 else x.shape[1]
    if strategy == "mxu" and (plan.bin_n > MXU_MAX_BIN
                              or width > MXU_MAX_WIDTH):
        raise ValueError(f"the one-hot push kernel takes bins of at most "
                         f"{MXU_MAX_BIN} destinations and payloads of at "
                         f"most {MXU_MAX_WIDTH} columns, not {plan.bin_n} "
                         f"and {width}")
    x, active = x.contiguous(), active.contiguous()
    out = torch.empty((n,) + tuple(x.shape[1:]), dtype=odt, device=x.device)
    if strategy == "mxu":
        units = mxu_units(plan, n, block_e)
        # records of split tiles: 8 bytes a value (the f64, u64 or
        # message-typed partials)
        rec = torch.empty(units.records * MXU_TILE * width,
                          dtype=torch.float64, device=x.device)
        fn = load("coo_push_mxu")
        rc = fn(x.data_ptr(), DTYPE_CODES[x.dtype], active.data_ptr(),
                plan.src.data_ptr(), plan.dst.data_ptr(), plan.w.data_ptr(),
                plan.ptr.data_ptr(), out.data_ptr(), n, plan.bin_n,
                plan.cap, width, COMBINE_CODES[combine], MSG_CODES[msg],
                units.count, units.table.data_ptr(),
                units.counters.data_ptr(), rec.data_ptr(), _stream())
        check_status(rc, "coo_push_mxu")
        return out
    units = push_units(plan, block_e, width)
    rec = units.count if units.split else 0
    rec_flags = torch.empty((2, rec), dtype=torch.int32, device=x.device)
    rec_vals = torch.empty((2, rec * width), dtype=torch.float64,
                           device=x.device)
    fn = load("coo_push")
    rc = fn(x.data_ptr(), DTYPE_CODES[x.dtype], active.data_ptr(),
            plan.src.data_ptr(), plan.dst.data_ptr(), plan.w.data_ptr(),
            out.data_ptr(), n, plan.cap, width, COMBINE_CODES[combine],
            MSG_CODES[msg], units.count, units.edges,
            units.table.data_ptr(), units.counters.data_ptr(),
            plan.empty.data_ptr(), int(plan.empty.shape[0]),
            rec_flags[0].data_ptr(), rec_flags[1].data_ptr(),
            rec_vals[0].data_ptr(), rec_vals[1].data_ptr(), _stream())
    check_status(rc, "coo_push")
    return out
