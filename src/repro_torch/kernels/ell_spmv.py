"""ELL-format pull relaxation: the full-scan gather-combine kernel.

    out[v] = combine_{j < d_ell} msg(x[ell_idx[v, j]], ell_w[v, j])

Port of ``repro.kernels.ell_spmv.ell_spmv_pallas``. On a CUDA tensor
:func:`ell_spmv` launches the hand-written kernel in ``csrc/ell_spmv.cu``;
on a CPU tensor it runs :func:`ell_spmv_plain`, the plain PyTorch version
of the same function, which is also what the kernel is checked against
on the card.

``row_len`` (int32 [n], optional; the graph's ``in_deg``) bounds each
row's real slots: slots ``j >= row_len[v]`` are not read. An ELL row
holds its real slots first and sentinels after, so with the in-degree
the result is the same and the padding costs nothing. With ``row_ptr``
(int32 [n+1]) the rows are the graph's row layout instead: ``ell_idx``
and ``ell_w`` are the CSR's [m] arrays (``coo_src``, ``coo_w``), row v
their slots ``[row_ptr[v], row_ptr[v+1])``, and ``d_ell`` (the longest
row, rounded up to 8; read from ``row_ptr`` when not given) the width
of the dense layout it stands for. Either layout gives the same result:
the plain version packs each chunk of rows into that dense shape. The kernel runs
over a row plan (:func:`ell_row_plan`, built once per graph and payload
width) that sorts rows into length classes: short rows get 2, 4 or 8
lanes, medium rows a warp, and hub rows are split across CTAs whose
partials are combined in piece order.

Surface: combine ∈ {sum, max, min}; payloads [n+1] or [n+1, B] (sentinel
row at index n); float32/float64/int32/int64; msg ∈ {copy, mul, add};
any index ≥ ``num_sources`` is masked to the combine identity, so empty
rows hold the identity. The output dtype follows :func:`_out_dtype`: the
message promotion, and an int32 sum widens to int64. Float sums
accumulate in float64 and round once.

:func:`ell_spmv_ppr_step` is the same launch with one personalized
PageRank power step as its epilogue (float32, copy, sum, at most
``PPR_STEP_MAX_WIDTH`` columns): it returns the updated ranks and
residuals of :func:`ppr_update` without writing the messages.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..sparse.segment import reduce_identity
from ._build import check_status, load

__all__ = ["ell_spmv", "ell_spmv_plain", "ell_spmv_ppr_step",
           "ell_spmv_ppr_step_plain", "ppr_update", "ell_row_plan",
           "layout_shape",
           "EllRowPlan", "row_class_bounds", "col_lanes", "DTYPE_CODES",
           "COMBINE_CODES", "MSG_CODES", "DEFAULT_BLOCK_ROWS",
           "PPR_STEP_MAX_WIDTH"]

DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.int32: 2,
               torch.int64: 3}
COMBINE_CODES = {"sum": 0, "min": 1, "max": 2}
MSG_CODES = {"copy": 0, "mul": 1, "add": 2}

# rows one CTA of the ELL kernels walks unless the caller (the tuner)
# says otherwise: one per warp in the frontier kernel, one pass in the
# full scan
DEFAULT_BLOCK_ROWS = 8

# the row classes of the full-scan kernel: the longest row each short
# class holds, and the lanes (before column lanes) such a row gets; a
# lane loads CHUNK slots at a time
SHORT_MAX = (8, 16, 32)
SHORT_LANES = (2, 4, 8)
CHUNK = 4
# the longest medium row (a warp) and the slots of a hub piece (a CTA of
# PULL_THREADS) at one column lane; with C column lanes a warp has 32 / C
# slot lanes, so both shrink by C
WARP_SLOTS = 1024
HUB_SLOTS = 8192
PULL_THREADS = 256

# bound on gathered slots per chunk of the plain version (memory, not speed)
_PLAIN_CHUNK = 1 << 25

# the widest payload of the fused PPR step: two column tiles, whose
# running maxima each thread holds in two registers
PPR_STEP_MAX_WIDTH = 64
# rows of the fused step's [slots, B] maxima: CTA b adds into row b % 1024
PPR_STEP_SLOTS = 1024


def _msg_dtype(x_dtype: torch.dtype, w_dtype: torch.dtype, msg: str):
    return x_dtype if msg == "copy" else torch.promote_types(x_dtype,
                                                             w_dtype)


def _out_dtype(x_dtype, w_dtype, msg: str, combine: str) -> torch.dtype:
    """The message promotion, plus ``jnp.sum``'s widening of an int32
    sum to int64 (what the JAX package's ``pull_relax_ell`` returns)."""
    d = _msg_dtype(x_dtype, w_dtype, msg)
    if combine == "sum" and d == torch.int32:
        d = torch.int64
    return d


def apply_msg(x: torch.Tensor, w: torch.Tensor, msg: str,
              dtype: torch.dtype) -> torch.Tensor:
    """msg(x, w) computed in ``dtype`` (the promoted message type); ``w``
    broadcasts over a trailing payload column axis of ``x``."""
    x = x.to(dtype)
    if msg == "copy":
        return x
    w = w.to(dtype)
    if x.ndim == w.ndim + 1:
        w = w[..., None]
    return x * w if msg == "mul" else x + w


def reduce_rows(msgs: torch.Tensor, valid: torch.Tensor, combine: str,
                out_dtype: torch.dtype) -> torch.Tensor:
    """Combine ``msgs`` [r, d(, B)] along axis 1 where ``valid`` [r, d];
    sums in float64 (floats) or int64 (ints), min/max in their type."""
    if valid.ndim < msgs.ndim:
        valid = valid[..., None]
    if combine == "sum":
        acc = torch.float64 if msgs.dtype.is_floating_point else torch.int64
        return torch.where(valid, msgs.to(acc), 0).sum(dim=1).to(out_dtype)
    masked = torch.where(valid, msgs, reduce_identity(combine, msgs.dtype))
    red = masked.amin(dim=1) if combine == "min" else masked.amax(dim=1)
    return red.to(out_dtype)


def _packed_rows(ell_idx, ell_w, safe, row_ptr, d_ell: int):
    """Rows ``safe`` of the row layout packed into the dense ELL's
    ``[r, d_ell]`` shape: sentinel ``n`` and weight 0 past each row."""
    start = row_ptr[safe].to(torch.int64)
    length = row_ptr[safe + 1].to(torch.int64) - start
    slot = torch.arange(d_ell, device=ell_idx.device)
    inrow = slot[None, :] < length[:, None]
    n = row_ptr.shape[0] - 1
    if ell_idx.numel() == 0:                 # no edges: every row empty
        return (torch.full(inrow.shape, n, dtype=ell_idx.dtype,
                           device=ell_idx.device),
                torch.zeros(inrow.shape, dtype=ell_w.dtype,
                            device=ell_w.device))
    at = torch.where(inrow, start[:, None] + slot, 0)
    return (torch.where(inrow, ell_idx[at], n),
            torch.where(inrow, ell_w[at], 0.0))


def gather_rows_plain(x_padded, ell_idx, ell_w, rows, combine: str,
                      msg: str, num_sources: int, row_limit: int,
                      row_len=None, row_ptr=None, d_ell=None):
    """Plain version of the row body of the ELL kernels: one output row
    per entry of ``rows`` (int64 row ids; ids outside ``[0, row_limit)``
    give the identity row). With ``row_len``, slots ``j >= row_len[v]``
    of row v are not read. With ``row_ptr`` the rows are the row
    layout's, packed a chunk at a time into ``[r, d_ell]``, so both
    layouts reduce the same matrices."""
    if row_ptr is None:
        d_ell = ell_idx.shape[1]
    mdt = _msg_dtype(x_padded.dtype, ell_w.dtype, msg)
    odt = _out_dtype(x_padded.dtype, ell_w.dtype, msg, combine)
    out = torch.empty((rows.shape[0],) + tuple(x_padded.shape[1:]),
                      dtype=odt, device=x_padded.device)
    width = 1 if x_padded.ndim == 1 else x_padded.shape[1]
    step = max(1, _PLAIN_CHUNK // max(1, d_ell * width))
    slot = torch.arange(d_ell, device=ell_idx.device)
    for lo in range(0, rows.shape[0], step):
        r = rows[lo:lo + step]
        live = (r >= 0) & (r < row_limit)
        safe = torch.where(live, r, 0)
        if row_ptr is None:
            idx, w = ell_idx[safe], ell_w[safe]
        else:
            idx, w = _packed_rows(ell_idx, ell_w, safe, row_ptr, d_ell)
        valid = live[:, None] & (idx >= 0) & (idx < num_sources)
        if row_len is not None:
            valid &= slot[None, :] < row_len[safe][:, None]
        gathered = x_padded[torch.where(valid, idx, 0).to(torch.int64)]
        msgs = apply_msg(gathered, w, msg, mdt)
        out[lo:lo + step] = reduce_rows(msgs, valid, combine, odt)
    return out


def col_lanes(width: int) -> int:
    """Column lanes of a row group for ``width`` payload columns: the
    power of two ≥ width, at most a warp."""
    c = 1
    while c < width and c < 32:
        c *= 2
    return c


def row_class_bounds(width: int = 1) -> tuple[tuple[int, ...], int]:
    """``(bounds, piece)`` of the row plan for ``width`` payload columns:
    a row of length ``len`` is in class k, the first with ``len <=
    bounds[k]`` (short rows of 2, 4 and 8 lanes, then a warp), else a
    hub cut into pieces of ``piece`` slots, one CTA each."""
    c = col_lanes(width)
    warp_max = max(SHORT_MAX[-1], WARP_SLOTS // c)
    return SHORT_MAX + (warp_max,), HUB_SLOTS // c


@dataclasses.dataclass(frozen=True, eq=False)
class EllRowPlan:
    """Rows of one ELL layout sorted into length classes for one payload
    width (:func:`ell_row_plan`). ``rows[class_off[k]:class_off[k+1]]``
    holds class k (ascending row ids), k = 0..3 the short and medium
    classes and k = 4 the hubs; hub h (the h-th row of class 4) is cut
    into pieces ``hub_first[h]:hub_first[h+1]`` of ``piece`` slots, and
    ``piece_hub`` names each piece's hub. ``counters`` (one per hub,
    zero between launches) let the last piece of a hub find itself.
    ``hub_slots`` counts the hub rows' slots. The plan is the same for
    both layouts: it reads only the row lengths."""
    rows: torch.Tensor
    class_off: tuple
    piece: int
    piece_hub: torch.Tensor
    hub_first: torch.Tensor
    counters: torch.Tensor
    row_len: Optional[torch.Tensor]
    n: int
    d_ell: int
    col_lanes: int
    hub_slots: int         # slots of the hub rows: a full scan's in pieces

    @property
    def pieces(self) -> int:
        return int(self.piece_hub.shape[0])


def ell_row_plan(row_len: Optional[torch.Tensor], n: int, d_ell: int,
                 width: int = 1, device=None) -> EllRowPlan:
    """The row plan of an [n, d_ell] ELL layout whose row v holds
    ``row_len[v]`` real slots (None: all d_ell), for payloads of
    ``width`` columns. Built with tensor operations on ``row_len``'s
    device (or ``device``); reads three counts back to the host."""
    dev = row_len.device if row_len is not None else torch.device(
        device or "cpu")
    if row_len is None:
        lens = torch.full((n,), d_ell, dtype=torch.int64, device=dev)
    else:
        if row_len.shape != (n,):
            raise ValueError(f"row_len must be [{n}], not "
                             f"{tuple(row_len.shape)}")
        lens = row_len.to(torch.int64).clamp(0, d_ell)
    bounds, piece = row_class_bounds(width)
    cls = torch.bucketize(lens, torch.tensor(bounds, device=dev))
    order = torch.argsort(cls, stable=True)
    counts = torch.bincount(cls, minlength=len(bounds) + 1)
    hub_len = lens[order[n - int(counts[-1]):]] if n else lens
    per_hub = (hub_len + piece - 1) // piece
    hub_first = torch.zeros(per_hub.shape[0] + 1, dtype=torch.int64,
                            device=dev)
    torch.cumsum(per_hub, 0, out=hub_first[1:])
    piece_hub = torch.repeat_interleave(
        torch.arange(per_hub.shape[0], device=dev), per_hub)
    off = [0]
    for c in counts.tolist():
        off.append(off[-1] + c)
    return EllRowPlan(rows=order.to(torch.int32), class_off=tuple(off),
                      piece=int(piece),
                      piece_hub=piece_hub.to(torch.int32),
                      hub_first=hub_first.to(torch.int32),
                      counters=torch.zeros(per_hub.shape[0],
                                           dtype=torch.int32, device=dev),
                      row_len=row_len, n=int(n), d_ell=int(d_ell),
                      col_lanes=col_lanes(width),
                      hub_slots=int(hub_len.sum()))


def layout_shape(ell_idx: torch.Tensor, row_ptr: Optional[torch.Tensor],
                 d_ell: Optional[int] = None) -> tuple[int, int]:
    """``(n, d_ell)`` of a pull layout: the dense ELL's shape, or for the
    row layout its row count and ``d_ell`` (given, or the longest row
    rounded up to 8, read from ``row_ptr``)."""
    if row_ptr is None:
        return tuple(ell_idx.shape)
    n = row_ptr.shape[0] - 1
    if d_ell is None:
        longest = int(_lengths(row_ptr).max()) if n else 0
        d_ell = max(8, -(-longest // 8) * 8)
    return n, int(d_ell)


def _check(x_padded, ell_idx, ell_w, combine, msg, num_sources,
           row_ptr=None):
    if combine not in COMBINE_CODES or msg not in MSG_CODES:
        raise ValueError(f"unsupported combine={combine!r} / msg={msg!r}")
    if x_padded.dtype not in DTYPE_CODES or x_padded.ndim not in (1, 2):
        raise ValueError(f"payload {x_padded.dtype} rank {x_padded.ndim} "
                         "not in f32/f64/i32/i64 × rank 1/2")
    rank = 2 if row_ptr is None else 1
    if ell_idx.dtype != torch.int32 or ell_w.dtype != torch.float32 \
            or ell_idx.ndim != rank or ell_w.shape != ell_idx.shape:
        raise ValueError("ell_idx must be int32 [n, d_ell] (with row_ptr: "
                         "[m]) and ell_w float32 of the same shape")
    if row_ptr is not None and (row_ptr.dtype != torch.int32
                                or row_ptr.ndim != 1
                                or row_ptr.shape[0] < 1):
        raise ValueError("row_ptr must be int32 [n + 1]")
    if x_padded.shape[0] < num_sources:
        raise ValueError(f"payload has {x_padded.shape[0]} rows, fewer "
                         f"than num_sources={num_sources}")
    tensors = (x_padded, ell_idx, ell_w) + (() if row_ptr is None
                                            else (row_ptr,))
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {devs}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _ptr(t: Optional[torch.Tensor]):
    return t.data_ptr() if t is not None else None


def _lengths(row_ptr: torch.Tensor) -> torch.Tensor:
    """int32 row lengths of the row layout's offsets."""
    return (row_ptr[1:] - row_ptr[:-1]).to(torch.int32)


def ell_spmv_plain(x_padded: torch.Tensor, ell_idx: torch.Tensor,
                   ell_w: torch.Tensor, combine: str = "sum",
                   msg: str = "mul", num_sources: Optional[int] = None,
                   row_len: Optional[torch.Tensor] = None,
                   row_ptr: Optional[torch.Tensor] = None,
                   d_ell: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`ell_spmv`."""
    n, d_ell = layout_shape(ell_idx, row_ptr, d_ell)
    ns = n if num_sources is None else num_sources
    rows = torch.arange(n, device=ell_idx.device)
    return gather_rows_plain(x_padded, ell_idx, ell_w, rows, combine, msg,
                             ns, n, row_len, row_ptr, d_ell)


def ell_spmv(x_padded: torch.Tensor, ell_idx: torch.Tensor,
             ell_w: torch.Tensor, combine: str = "sum", msg: str = "mul",
             num_sources: Optional[int] = None,
             block_n: int = DEFAULT_BLOCK_ROWS,
             row_len: Optional[torch.Tensor] = None,
             plan: Optional[EllRowPlan] = None,
             row_ptr: Optional[torch.Tensor] = None,
             d_ell: Optional[int] = None) -> torch.Tensor:
    """Pull k-relaxation over the ELL layout.

    x_padded: [n+1] or [n+1, B] payloads (sentinel row at index n);
    ell_idx: int32 [n, d_ell]; ell_w: float32 [n, d_ell]. Returns [n] or
    [n, B]; empty rows hold the combine identity. ``num_sources`` is the
    index validity bound (default n). ``row_len`` (int32 [n]) bounds each
    row's slots read. ``plan`` is the cached :func:`ell_row_plan` of this
    layout and width (built here when absent; it carries its own
    ``row_len``, which a given ``row_len`` must be). ``block_n`` is the
    tuner's tile, rows per CTA of the 2-lane class at width 1: each CTA
    of a short or medium class makes ``block_n // 128`` passes (at least
    one, and fewer where the class would fill fewer than four CTAs per
    SM), each giving every lane group a row. No effect on the result.
    With ``row_ptr`` the rows are the row layout's (ell_idx, ell_w [m]),
    their lengths its offsets', and ``d_ell`` the plan's where one is
    given.
    """
    if plan is not None and row_ptr is not None and d_ell is None:
        d_ell = plan.d_ell
    n, d_ell = layout_shape(ell_idx, row_ptr, d_ell)
    ns = n if num_sources is None else int(num_sources)
    _check(x_padded, ell_idx, ell_w, combine, msg, ns, row_ptr)
    width = 1 if x_padded.ndim == 1 else x_padded.shape[1]
    if plan is not None:
        if row_len is not None and row_len is not plan.row_len:
            raise ValueError("ell_spmv: plan was built for another row_len")
        if (plan.n, plan.d_ell, plan.col_lanes) != (n, d_ell,
                                                    col_lanes(width)):
            raise ValueError(
                f"ell_spmv: plan for [{plan.n}, {plan.d_ell}] with "
                f"{plan.col_lanes} column lanes, called on [{n}, {d_ell}] "
                f"with {col_lanes(width)}")
        row_len = plan.row_len
    if row_len is not None and (row_len.dtype != torch.int32
                                or row_len.shape != (n,)
                                or row_len.device != ell_idx.device):
        raise ValueError(f"row_len must be int32 [{n}] on {ell_idx.device}")
    if x_padded.device.type == "cpu":
        return ell_spmv_plain(x_padded, ell_idx, ell_w, combine, msg, ns,
                              row_len, row_ptr, d_ell)
    if x_padded.device.type != "cuda":
        raise ValueError(f"ell_spmv runs on cuda or cpu, not "
                         f"{x_padded.device}")
    x_padded = x_padded.contiguous()
    ell_idx, ell_w = ell_idx.contiguous(), ell_w.contiguous()
    if row_ptr is not None:
        row_ptr = row_ptr.contiguous()
    odt = _out_dtype(x_padded.dtype, ell_w.dtype, msg, combine)
    out = torch.empty((n,) + tuple(x_padded.shape[1:]), dtype=odt,
                      device=x_padded.device)
    if n == 0:
        return out
    if plan is None:
        plan = ell_row_plan(row_len if row_ptr is None else _lengths(row_ptr),
                            n, d_ell, width, x_padded.device)
    # partial accumulators (8 bytes each) of hubs cut into several pieces
    split = plan.pieces > plan.counters.shape[0]
    partial = torch.empty((plan.pieces * width if split else 0,),
                          dtype=torch.float64, device=x_padded.device)
    off = plan.class_off
    fn = load("ell_spmv")
    rc = fn(x_padded.data_ptr(), DTYPE_CODES[x_padded.dtype],
            ell_idx.data_ptr(), ell_w.data_ptr(), out.data_ptr(), n, d_ell,
            ns, width, int(block_n), COMBINE_CODES[combine], MSG_CODES[msg],
            row_len.data_ptr() if row_len is not None else None,
            plan.rows.data_ptr(), off[1], off[2], off[3], off[4],
            plan.pieces, plan.piece, plan.piece_hub.data_ptr(),
            plan.hub_first.data_ptr(), plan.counters.data_ptr(),
            partial.data_ptr(), _ptr(row_ptr), _stream())
    check_status(rc, "ell_spmv")
    return out


def ppr_update(base: torch.Tensor, rank: torch.Tensor, resid: torch.Tensor,
               msgs: torch.Tensor, damp: float, tol: float):
    """One personalized-PageRank power step on [n, B] ranks from the
    pulled messages ``msgs``: ``base + damp · msgs`` in each column whose
    residual ``resid`` [B] is at least ``tol``, the old rank in the
    others; and each such column's new residual, the largest change of
    its ranks (the others keep theirs). ``damp`` is taken in the ranks'
    dtype. Returns ``(rank, resid)``."""
    active = resid >= tol
    new = torch.where(active[None, :], base + damp * msgs, rank)
    return new, torch.where(active, (new - rank).abs().amax(dim=0), resid)


def ell_spmv_ppr_step_plain(x: torch.Tensor, ell_idx: torch.Tensor,
                            ell_w: torch.Tensor, base: torch.Tensor,
                            rank: torch.Tensor, resid: torch.Tensor, *,
                            damp: float, tol: float,
                            row_len: Optional[torch.Tensor] = None,
                            row_ptr: Optional[torch.Tensor] = None,
                            d_ell: Optional[int] = None):
    """Plain PyTorch version of :func:`ell_spmv_ppr_step`: the full-scan
    sum of copied payloads, then :func:`ppr_update`."""
    msgs = ell_spmv_plain(x, ell_idx, ell_w, "sum", "copy", x.shape[0],
                          row_len, row_ptr, d_ell)
    return ppr_update(base, rank, resid, msgs, damp, tol)


def ell_spmv_ppr_step(x: torch.Tensor, ell_idx: torch.Tensor,
                      ell_w: torch.Tensor, base: torch.Tensor,
                      rank: torch.Tensor, resid: torch.Tensor, *,
                      damp: float, tol: float,
                      block_n: int = DEFAULT_BLOCK_ROWS,
                      plan: Optional[EllRowPlan] = None,
                      row_ptr: Optional[torch.Tensor] = None):
    """One PPR power step fused into the full-scan pull: the messages
    ``ell_spmv(x, ..., "sum", "copy")`` of the float32 payload ``x``
    [n, B] (unpadded: ``num_sources = n``; B ≤ ``PPR_STEP_MAX_WIDTH``)
    go straight into :func:`ppr_update` with ``base``, ``rank`` [n, B]
    and ``resid`` [B], each finished row in the kernel's epilogue, so
    the [n, B] messages are never written. ``damp`` and ``tol`` are
    taken in float32. Returns ``(rank, resid)``, bit for bit those of
    ``ell_spmv`` followed by :func:`ppr_update`. ``plan`` (with its
    ``row_len``), ``block_n`` and ``row_ptr`` (the row layout, whose
    ``d_ell`` is the plan's) are :func:`ell_spmv`'s. On a CPU tensor it
    runs :func:`ell_spmv_ppr_step_plain`."""
    n, d_ell = layout_shape(ell_idx, row_ptr,
                            plan.d_ell if plan is not None else None)
    if x.dtype != torch.float32 or x.ndim != 2 or x.shape[0] != n \
            or not 1 <= x.shape[1] <= PPR_STEP_MAX_WIDTH:
        raise ValueError(f"ell_spmv_ppr_step takes a float32 [{n}, B] "
                         f"payload, B <= {PPR_STEP_MAX_WIDTH}, not "
                         f"{x.dtype} {tuple(x.shape)}")
    width = x.shape[1]
    if base.shape != x.shape or rank.shape != x.shape \
            or resid.shape != (width,) or any(
                t.dtype != torch.float32 for t in (base, rank, resid)):
        raise ValueError("base and rank must be float32 like x, resid "
                         f"float32 [{width}]")
    _check(x, ell_idx, ell_w, "sum", "copy", n, row_ptr)
    if plan is None:
        plan = ell_row_plan(None if row_ptr is None else _lengths(row_ptr),
                            n, d_ell, width, x.device)
    if (plan.n, plan.d_ell, plan.col_lanes) != (n, d_ell, col_lanes(width)):
        raise ValueError(f"ell_spmv_ppr_step: plan for [{plan.n}, "
                         f"{plan.d_ell}] with {plan.col_lanes} column "
                         f"lanes, called on [{n}, {d_ell}] with "
                         f"{col_lanes(width)}")
    rl = plan.row_len
    if x.device.type == "cpu":
        return ell_spmv_ppr_step_plain(x, ell_idx, ell_w, base, rank, resid,
                                       damp=damp, tol=tol, row_len=rl,
                                       row_ptr=row_ptr, d_ell=d_ell)
    if x.device.type != "cuda":
        raise ValueError(f"ell_spmv_ppr_step runs on cuda or cpu, not "
                         f"{x.device}")
    x, base, rank = x.contiguous(), base.contiguous(), rank.contiguous()
    resid = resid.contiguous()
    ell_idx, ell_w = ell_idx.contiguous(), ell_w.contiguous()
    if row_ptr is not None:
        row_ptr = row_ptr.contiguous()
    rank_out = torch.empty_like(rank)
    # each CTA's largest changes (float bits) by atomicMax into a slot
    slots = torch.zeros((PPR_STEP_SLOTS, width), dtype=torch.float32,
                        device=x.device)
    split = plan.pieces > plan.counters.shape[0]
    partial = torch.empty((plan.pieces * width if split else 0,),
                          dtype=torch.float64, device=x.device)
    off = plan.class_off
    if n:
        fn = load("ell_spmv_ppr")
        rc = fn(x.data_ptr(), ell_idx.data_ptr(), ell_w.data_ptr(), n,
                d_ell, width, int(block_n),
                rl.data_ptr() if rl is not None else None,
                plan.rows.data_ptr(), off[1], off[2], off[3], off[4],
                plan.pieces, plan.piece, plan.piece_hub.data_ptr(),
                plan.hub_first.data_ptr(), plan.counters.data_ptr(),
                partial.data_ptr(), base.data_ptr(), rank.data_ptr(),
                resid.data_ptr(), rank_out.data_ptr(), slots.data_ptr(),
                PPR_STEP_SLOTS, float(damp), float(tol), _ptr(row_ptr),
                _stream())
        check_status(rc, "ell_spmv_ppr")
    return rank_out, torch.where(resid >= tol, slots.amax(dim=0), resid)
