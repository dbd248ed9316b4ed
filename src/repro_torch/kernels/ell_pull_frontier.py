"""Frontier-aware pull over the ELL in-edge layout.

    out[r] = combine_{j < len(v)} msg(x[ell_idx[v, j]], ell_w[v, j]),
    v = rows[r]

Port of ``repro.kernels.ell_pull_frontier.ell_pull_frontier_pallas``.
``rows`` is the compacted touched-destination id list, padded with the
sentinel ``n`` (:func:`frontier_rows`); ``len(v)`` is ``row_len[v]``
(optional, the graph's ``in_deg``, as in ``ell_spmv``) or ``d_ell``.
Sentinel rows give the combine identity, so
:func:`ell_pull_frontier_full` equals
``mask_untouched(ell_spmv(...), touched)``.
With ``row_ptr`` the rows are the graph's row layout (``ell_idx``,
``ell_w`` the CSR's [m] arrays, ``d_ell`` the dense width it stands for),
as in ``ell_spmv``.

On a CUDA tensor :func:`ell_pull_frontier` launches
``csrc/ell_pull_frontier.cu`` over the work plan of
:func:`frontier_plan` (lanes per row, pieces per row: known from
``d_ell`` and the payload width, with no read of the list); on a CPU
tensor it runs :func:`ell_pull_frontier_plain`. The compaction and the
scatter of ``_full`` are plain tensor ops, as they sit outside the
Pallas kernel in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..sparse.segment import reduce_identity
from ._build import check_status, load, zeroed_counters
from .ell_spmv import (COMBINE_CODES, DEFAULT_BLOCK_ROWS, DTYPE_CODES,
                       MSG_CODES, SHORT_LANES, SHORT_MAX, WARP_SLOTS,
                       _check, _out_dtype, _ptr, _stream, col_lanes,
                       gather_rows_plain, layout_shape)

__all__ = ["ell_pull_frontier", "ell_pull_frontier_plain",
           "ell_pull_frontier_full", "frontier_rows", "default_pull_cap",
           "frontier_plan", "FrontierPlan"]


def _round_up(x: int, q: int) -> int:
    return -(-x // q) * q


def default_pull_cap(n: int, m: int, d_ell: int) -> int:
    """Row capacity up to which the restricted gather is guaranteed
    cheaper than the full scan (``cap × d_ell ≤ m/2``)."""
    cap = min(n, m // (2 * max(d_ell, 1)))
    return max(8, _round_up(cap, 8))


@dataclasses.dataclass(frozen=True)
class FrontierPlan:
    """How the kernel spreads a list of rows of ``d_ell`` slots over the
    card: each row's lane group is ``group`` lanes (``col_lanes`` column
    lanes times slot lanes, at most a warp), and each row is cut into
    ``pieces`` units of at most ``piece`` slots, one lane group each. A
    unit past its row's length does nothing; the pieces of a row longer
    than one piece are combined in piece order by the last to finish."""
    group: int
    col_lanes: int
    piece: int
    pieces: int


def frontier_plan(d_ell: int, width: int = 1) -> FrontierPlan:
    """The frontier pull's work plan for rows of ``d_ell`` slots and
    payloads of ``width`` columns: the full scan's lane classes
    (``ell_spmv``: 2, 4 or 8 slot lanes for rows of at most 8, 16 or 32
    slots, else a warp) chosen by ``d_ell``, the longest a listed row may
    be, and pieces of the full scan's medium row (``WARP_SLOTS`` slots at
    one column lane, a C-th of that at C)."""
    c = col_lanes(width)
    lanes = next((ln for mx, ln in zip(SHORT_MAX, SHORT_LANES)
                  if d_ell <= mx), 32)
    group = min(32, lanes * c)
    piece = max(SHORT_MAX[-1], WARP_SLOTS // c)
    return FrontierPlan(group=group, col_lanes=c, piece=piece,
                        pieces=max(1, -(-d_ell // piece)))


def frontier_rows(touched: torch.Tensor, size: int) -> torch.Tensor:
    """Compact a bool[n] mask into int32 row ids, padded with the
    sentinel ``n`` to ``size``; rows beyond ``size`` are dropped."""
    n = touched.shape[0]
    ids = torch.nonzero(touched).flatten()[:size].to(torch.int32)
    pad = torch.full((size - ids.shape[0],), n, dtype=torch.int32,
                     device=touched.device)
    return torch.cat([ids, pad])


def ell_pull_frontier_plain(x_padded, ell_idx, ell_w, rows,
                            combine: str = "sum", msg: str = "mul",
                            num_sources: Optional[int] = None,
                            row_len: Optional[torch.Tensor] = None,
                            row_ptr: Optional[torch.Tensor] = None,
                            d_ell: Optional[int] = None):
    """Plain PyTorch version of :func:`ell_pull_frontier`."""
    n, d_ell = layout_shape(ell_idx, row_ptr, d_ell)
    ns = n if num_sources is None else num_sources
    return gather_rows_plain(x_padded, ell_idx, ell_w, rows.to(torch.int64),
                             combine, msg, ns, min(n, ns), row_len, row_ptr,
                             d_ell)


def ell_pull_frontier(x_padded: torch.Tensor, ell_idx: torch.Tensor,
                      ell_w: torch.Tensor, rows: torch.Tensor,
                      combine: str = "sum", msg: str = "mul",
                      num_sources: Optional[int] = None,
                      block_r: int = DEFAULT_BLOCK_ROWS,
                      row_len: Optional[torch.Tensor] = None,
                      row_ptr: Optional[torch.Tensor] = None,
                      d_ell: Optional[int] = None) -> torch.Tensor:
    """Frontier-restricted pull: combined messages for ``rows`` only,
    [R] or [R, B] aligned with ``rows``; sentinel slots hold the
    identity. ``row_len`` (int32 [n], the graph's ``in_deg``) bounds the
    slots read of each row. ``block_r`` is the tuner's tile: each CTA
    makes ``block_r // 128`` passes over the units of the plan (at least
    one, and fewer where the list would fill fewer than four CTAs per
    SM), each giving every lane group one unit. No effect on the
    result. ``row_ptr`` and ``d_ell``: the row layout, as in
    ``ell_spmv``; the plan is ``d_ell``'s either way."""
    n, d_ell = layout_shape(ell_idx, row_ptr, d_ell)
    ns = n if num_sources is None else int(num_sources)
    _check(x_padded, ell_idx, ell_w, combine, msg, ns, row_ptr)
    if rows.dtype != torch.int32 or rows.ndim != 1 \
            or rows.device != x_padded.device:
        raise ValueError("rows must be int32 [R] on the payload's device")
    if row_len is not None and (row_len.dtype != torch.int32
                                or row_len.shape != (n,)
                                or row_len.device != ell_idx.device):
        raise ValueError(f"row_len must be int32 [{n}] on {ell_idx.device}")
    if x_padded.device.type == "cpu":
        return ell_pull_frontier_plain(x_padded, ell_idx, ell_w, rows,
                                       combine, msg, ns, row_len, row_ptr,
                                       d_ell)
    if x_padded.device.type != "cuda":
        raise ValueError(f"ell_pull_frontier runs on cuda or cpu, not "
                         f"{x_padded.device}")
    x_padded, rows = x_padded.contiguous(), rows.contiguous()
    ell_idx, ell_w = ell_idx.contiguous(), ell_w.contiguous()
    if row_ptr is not None:
        row_ptr = row_ptr.contiguous()
    odt = _out_dtype(x_padded.dtype, ell_w.dtype, msg, combine)
    r = rows.shape[0]
    out = torch.empty((r,) + tuple(x_padded.shape[1:]), dtype=odt,
                      device=x_padded.device)
    if r == 0:
        return out
    width = 1 if x_padded.ndim == 1 else x_padded.shape[1]
    plan = frontier_plan(d_ell, width)
    # partial accumulators (8 bytes each) of rows cut into several pieces
    partial = torch.empty((r * plan.pieces * width if plan.pieces > 1
                           else 0,), dtype=torch.float64,
                          device=x_padded.device)
    fn = load("ell_pull_frontier")
    rc = fn(x_padded.data_ptr(), DTYPE_CODES[x_padded.dtype],
            ell_idx.data_ptr(), ell_w.data_ptr(),
            row_len.data_ptr() if row_len is not None else None,
            rows.data_ptr(), out.data_ptr(), r, d_ell, ns, min(n, ns), width,
            int(block_r), COMBINE_CODES[combine], MSG_CODES[msg],
            plan.group, plan.col_lanes, plan.piece, plan.pieces,
            zeroed_counters("ell_pull_frontier", x_padded.device,
                            r).data_ptr(), partial.data_ptr(),
            _ptr(row_ptr), _stream())
    check_status(rc, "ell_pull_frontier")
    return out


def ell_pull_frontier_full(x_padded: torch.Tensor, ell_idx: torch.Tensor,
                           ell_w: torch.Tensor, rows: torch.Tensor,
                           combine: str = "sum", msg: str = "mul",
                           block_r: int = DEFAULT_BLOCK_ROWS,
                           row_len: Optional[torch.Tensor] = None,
                           row_ptr: Optional[torch.Tensor] = None,
                           d_ell: Optional[int] = None) -> torch.Tensor:
    """Frontier pull scattered back to the full vertex range: touched
    rows carry their combined messages, every other row the identity.
    ``row_ptr`` and ``d_ell``: the row layout, as in ``ell_spmv``."""
    n = ell_idx.shape[0] if row_ptr is None else row_ptr.shape[0] - 1
    compact = ell_pull_frontier(x_padded, ell_idx, ell_w, rows,
                                combine=combine, msg=msg, block_r=block_r,
                                row_len=row_len, row_ptr=row_ptr,
                                d_ell=d_ell)
    odt = _out_dtype(x_padded.dtype, ell_w.dtype, msg, combine)
    # one spill row past the end takes the sentinel slots, then is dropped
    base = torch.full((n + 1,) + tuple(compact.shape[1:]),
                      reduce_identity(combine, odt), dtype=odt,
                      device=compact.device)
    live = (rows >= 0) & (rows < n)
    base[torch.where(live, rows, n).to(torch.int64)] = compact
    return base[:n]
