"""Segment ops — the CRCW-CB combining primitive (paper §2.1, §2.3).
PyTorch port of ``repro.sparse.segment`` (sum, min, max).

An empty segment holds the combine identity: 0 for sums, +inf/-inf for
float min/max and the integer bounds for integer min/max. Sums keep the
data's dtype (no int32 widening), like ``jax.ops.segment_sum``. Segment
ids outside ``[0, num_segments)`` are dropped.

On the card a float32 sum accumulates in float64 and rounds once to
float32, as the kernels do: ``index_add_``'s float32 atomics flush
subnormal terms and sums to zero (two 2^-130 terms would sum to 0),
float64 atomics keep them. On the CPU ``index_add_`` sums in float32,
which does not flush, and matches ``jax.ops.segment_sum`` exactly.
"""

from __future__ import annotations

import torch

__all__ = ["segment_sum", "segment_min", "segment_max", "reduce_identity"]


def reduce_identity(combine: str, dtype: torch.dtype):
    """Python scalar identity of ``combine`` over ``dtype``."""
    if combine == "sum":
        return 0
    if dtype.is_floating_point:
        return float("inf") if combine == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if combine == "min" else info.min


def _segment(data: torch.Tensor, segment_ids: torch.Tensor,
             num_segments: int, combine: str) -> torch.Tensor:
    # one spill row past the end takes the out-of-range ids
    ids = segment_ids.to(torch.int64)
    ids = torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)
    shape = (num_segments + 1,) + tuple(data.shape[1:])
    if combine == "sum" and data.is_cuda and data.dtype == torch.float32:
        acc = torch.zeros(shape, dtype=torch.float64, device=data.device)
        acc.index_add_(0, ids, data.to(torch.float64))
        return acc[:num_segments].to(torch.float32)
    out = torch.full(shape, reduce_identity(combine, data.dtype),
                     dtype=data.dtype, device=data.device)
    if combine == "sum":
        out.index_add_(0, ids, data)
    else:
        ids = ids.reshape((-1,) + (1,) * (data.ndim - 1)).expand_as(data)
        out.scatter_reduce_(0, ids, data,
                            reduce="amin" if combine == "min" else "amax",
                            include_self=True)
    return out[:num_segments]


def segment_sum(data, segment_ids, num_segments: int) -> torch.Tensor:
    return _segment(data, segment_ids, num_segments, "sum")


def segment_min(data, segment_ids, num_segments: int) -> torch.Tensor:
    return _segment(data, segment_ids, num_segments, "min")


def segment_max(data, segment_ids, num_segments: int) -> torch.Tensor:
    return _segment(data, segment_ids, num_segments, "max")
