"""Frontier-aware pull over the ELL in-edge layout.

    out[r] = combine_{j < d_ell} msg(x[ell_idx[rows[r], j]],
                                     ell_w[rows[r], j])

Port of ``repro.kernels.ell_pull_frontier.ell_pull_frontier_pallas``.
``rows`` is the compacted touched-destination id list, padded with the
sentinel ``n`` (:func:`frontier_rows`); work is ``R × d_ell`` instead of
the full scan's ``n × d_ell``. Sentinel rows give the combine identity,
so :func:`ell_pull_frontier_full` equals
``mask_untouched(ell_spmv(...), touched)``.

On a CUDA tensor :func:`ell_pull_frontier` launches
``csrc/ell_pull_frontier.cu``; on a CPU tensor it runs
:func:`ell_pull_frontier_plain`. The compaction and the scatter of
``_full`` are plain tensor ops, as they sit outside the Pallas kernel in
the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..sparse.segment import reduce_identity
from ._build import check_status, load
from .ell_spmv import (COMBINE_CODES, DEFAULT_BLOCK_ROWS, DTYPE_CODES,
                       MSG_CODES, _check, _out_dtype, _stream,
                       gather_rows_plain)

__all__ = ["ell_pull_frontier", "ell_pull_frontier_plain",
           "ell_pull_frontier_full", "frontier_rows", "default_pull_cap"]


def _round_up(x: int, q: int) -> int:
    return -(-x // q) * q


def default_pull_cap(n: int, m: int, d_ell: int) -> int:
    """Row capacity up to which the restricted gather is guaranteed
    cheaper than the full scan (``cap × d_ell ≤ m/2``)."""
    cap = min(n, m // (2 * max(d_ell, 1)))
    return max(8, _round_up(cap, 8))


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
                            num_sources: Optional[int] = None):
    """Plain PyTorch version of :func:`ell_pull_frontier`."""
    n = ell_idx.shape[0]
    ns = n if num_sources is None else num_sources
    return gather_rows_plain(x_padded, ell_idx, ell_w, rows.to(torch.int64),
                             combine, msg, ns, min(n, ns))


def ell_pull_frontier(x_padded: torch.Tensor, ell_idx: torch.Tensor,
                      ell_w: torch.Tensor, rows: torch.Tensor,
                      combine: str = "sum", msg: str = "mul",
                      num_sources: Optional[int] = None,
                      block_r: int = DEFAULT_BLOCK_ROWS) -> torch.Tensor:
    """Frontier-restricted pull: combined messages for ``rows`` only,
    [R] or [R, B] aligned with ``rows``; sentinel slots hold the
    identity. ``block_r`` is the number of list entries one CTA walks."""
    n, d_ell = ell_idx.shape
    ns = n if num_sources is None else int(num_sources)
    _check(x_padded, ell_idx, ell_w, combine, msg, ns)
    if rows.dtype != torch.int32 or rows.ndim != 1 \
            or rows.device != x_padded.device:
        raise ValueError("rows must be int32 [R] on the payload's device")
    if x_padded.device.type == "cpu":
        return ell_pull_frontier_plain(x_padded, ell_idx, ell_w, rows,
                                       combine, msg, ns)
    if x_padded.device.type != "cuda":
        raise ValueError(f"ell_pull_frontier runs on cuda or cpu, not "
                         f"{x_padded.device}")
    x_padded, rows = x_padded.contiguous(), rows.contiguous()
    ell_idx, ell_w = ell_idx.contiguous(), ell_w.contiguous()
    odt = _out_dtype(x_padded.dtype, ell_w.dtype, msg, combine)
    r = rows.shape[0]
    out = torch.empty((r,) + tuple(x_padded.shape[1:]), dtype=odt,
                      device=x_padded.device)
    if r == 0:
        return out
    width = 1 if x_padded.ndim == 1 else x_padded.shape[1]
    fn = load("ell_pull_frontier")
    rc = fn(x_padded.data_ptr(), DTYPE_CODES[x_padded.dtype],
            ell_idx.data_ptr(), ell_w.data_ptr(), rows.data_ptr(),
            out.data_ptr(), r, d_ell, ns, min(n, ns), width, int(block_r),
            COMBINE_CODES[combine], MSG_CODES[msg], _stream())
    check_status(rc, "ell_pull_frontier")
    return out


def ell_pull_frontier_full(x_padded: torch.Tensor, ell_idx: torch.Tensor,
                           ell_w: torch.Tensor, rows: torch.Tensor,
                           combine: str = "sum", msg: str = "mul",
                           block_r: int = DEFAULT_BLOCK_ROWS) -> torch.Tensor:
    """Frontier pull scattered back to the full vertex range: touched
    rows carry their combined messages, every other row the identity."""
    n = ell_idx.shape[0]
    compact = ell_pull_frontier(x_padded, ell_idx, ell_w, rows,
                                combine=combine, msg=msg, block_r=block_r)
    odt = _out_dtype(x_padded.dtype, ell_w.dtype, msg, combine)
    # one spill row past the end takes the sentinel slots, then is dropped
    base = torch.full((n + 1,) + tuple(compact.shape[1:]),
                      reduce_identity(combine, odt), dtype=odt,
                      device=compact.device)
    live = (rows >= 0) & (rows < n)
    base[torch.where(live, rows, n).to(torch.int64)] = compact
    return base[:n]
