"""ELL-format pull relaxation: the full-scan gather-combine kernel.

    out[v] = combine_{j < d_ell} msg(x[ell_idx[v, j]], ell_w[v, j])

Port of ``repro.kernels.ell_spmv.ell_spmv_pallas``. On a CUDA tensor
:func:`ell_spmv` launches the hand-written kernel in ``csrc/ell_spmv.cu``
(one warp per row, ``block_n`` rows per CTA); on a CPU tensor it runs
:func:`ell_spmv_plain`, the plain PyTorch version of the same function,
which is also what the kernel is checked against on the card.

Surface: combine ∈ {sum, max, min}; payloads [n+1] or [n+1, B] (sentinel
row at index n); float32/float64/int32/int64; msg ∈ {copy, mul, add};
any index ≥ ``num_sources`` is masked to the combine identity, so empty
rows hold the identity. The output dtype follows :func:`_out_dtype`: the
message promotion, and an int32 sum widens to int64. Float sums
accumulate in float64 and round once.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..sparse.segment import reduce_identity
from ._build import check_status, load

__all__ = ["ell_spmv", "ell_spmv_plain", "DTYPE_CODES", "COMBINE_CODES",
           "MSG_CODES", "DEFAULT_BLOCK_ROWS"]

DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.int32: 2,
               torch.int64: 3}
COMBINE_CODES = {"sum": 0, "min": 1, "max": 2}
MSG_CODES = {"copy": 0, "mul": 1, "add": 2}

# rows one CTA of the ELL kernels walks unless the caller (the tuner)
# says otherwise: one per warp
DEFAULT_BLOCK_ROWS = 8

# bound on gathered slots per chunk of the plain version (memory, not speed)
_PLAIN_CHUNK = 1 << 25


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


def gather_rows_plain(x_padded, ell_idx, ell_w, rows, combine: str,
                      msg: str, num_sources: int, row_limit: int):
    """Plain version of the warp-per-row body both ELL kernels share:
    one output row per entry of ``rows`` (int64 row ids; ids outside
    ``[0, row_limit)`` give the identity row)."""
    d_ell = ell_idx.shape[1]
    mdt = _msg_dtype(x_padded.dtype, ell_w.dtype, msg)
    odt = _out_dtype(x_padded.dtype, ell_w.dtype, msg, combine)
    out = torch.empty((rows.shape[0],) + tuple(x_padded.shape[1:]),
                      dtype=odt, device=x_padded.device)
    width = 1 if x_padded.ndim == 1 else x_padded.shape[1]
    step = max(1, _PLAIN_CHUNK // max(1, d_ell * width))
    for lo in range(0, rows.shape[0], step):
        r = rows[lo:lo + step]
        live = (r >= 0) & (r < row_limit)
        safe = torch.where(live, r, 0)
        idx = ell_idx[safe]
        valid = live[:, None] & (idx >= 0) & (idx < num_sources)
        gathered = x_padded[torch.where(valid, idx, 0).to(torch.int64)]
        msgs = apply_msg(gathered, ell_w[safe], msg, mdt)
        out[lo:lo + step] = reduce_rows(msgs, valid, combine, odt)
    return out


def _check(x_padded, ell_idx, ell_w, combine, msg, num_sources):
    if combine not in COMBINE_CODES or msg not in MSG_CODES:
        raise ValueError(f"unsupported combine={combine!r} / msg={msg!r}")
    if x_padded.dtype not in DTYPE_CODES or x_padded.ndim not in (1, 2):
        raise ValueError(f"payload {x_padded.dtype} rank {x_padded.ndim} "
                         "not in f32/f64/i32/i64 × rank 1/2")
    if ell_idx.dtype != torch.int32 or ell_w.dtype != torch.float32 \
            or ell_idx.ndim != 2 or ell_w.shape != ell_idx.shape:
        raise ValueError("ell_idx must be int32 [n, d_ell] and ell_w "
                         "float32 of the same shape")
    if x_padded.shape[0] < num_sources:
        raise ValueError(f"payload has {x_padded.shape[0]} rows, fewer "
                         f"than num_sources={num_sources}")
    devs = {t.device for t in (x_padded, ell_idx, ell_w)}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {devs}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def ell_spmv_plain(x_padded: torch.Tensor, ell_idx: torch.Tensor,
                   ell_w: torch.Tensor, combine: str = "sum",
                   msg: str = "mul",
                   num_sources: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`ell_spmv`."""
    n = ell_idx.shape[0]
    ns = n if num_sources is None else num_sources
    rows = torch.arange(n, device=ell_idx.device)
    return gather_rows_plain(x_padded, ell_idx, ell_w, rows, combine, msg,
                             ns, n)


def ell_spmv(x_padded: torch.Tensor, ell_idx: torch.Tensor,
             ell_w: torch.Tensor, combine: str = "sum", msg: str = "mul",
             num_sources: Optional[int] = None,
             block_n: int = DEFAULT_BLOCK_ROWS) -> torch.Tensor:
    """Pull k-relaxation over the ELL layout.

    x_padded: [n+1] or [n+1, B] payloads (sentinel row at index n);
    ell_idx: int32 [n, d_ell]; ell_w: float32 [n, d_ell]. Returns [n] or
    [n, B]; empty rows hold the combine identity. ``num_sources`` is the
    index validity bound (default n). ``block_n`` is the number of rows
    one CTA walks (the tuner's tile; no effect on the result).
    """
    n, d_ell = ell_idx.shape
    ns = n if num_sources is None else int(num_sources)
    _check(x_padded, ell_idx, ell_w, combine, msg, ns)
    if x_padded.device.type == "cpu":
        return ell_spmv_plain(x_padded, ell_idx, ell_w, combine, msg, ns)
    if x_padded.device.type != "cuda":
        raise ValueError(f"ell_spmv runs on cuda or cpu, not "
                         f"{x_padded.device}")
    x_padded = x_padded.contiguous()
    ell_idx, ell_w = ell_idx.contiguous(), ell_w.contiguous()
    odt = _out_dtype(x_padded.dtype, ell_w.dtype, msg, combine)
    out = torch.empty((n,) + tuple(x_padded.shape[1:]), dtype=odt,
                      device=x_padded.device)
    if n == 0:
        return out
    width = 1 if x_padded.ndim == 1 else x_padded.shape[1]
    fn = load("ell_spmv")
    rc = fn(x_padded.data_ptr(), DTYPE_CODES[x_padded.dtype],
            ell_idx.data_ptr(), ell_w.data_ptr(), out.data_ptr(), n, d_ell,
            ns, width, int(block_n), COMBINE_CODES[combine], MSG_CODES[msg],
            _stream())
    check_status(rc, "ell_spmv")
    return out
