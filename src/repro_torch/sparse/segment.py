"""Segment ops — the CRCW-CB combining primitive (paper §2.1, §2.3).
PyTorch port of ``repro.sparse.segment``.

An empty segment holds the combine identity: 0 for sums, +inf/-inf for
float min/max and the integer bounds for integer min/max. Sums keep the
data's dtype (no int32 widening), like ``jax.ops.segment_sum``. Segment
ids outside ``[0, num_segments)`` are dropped by the reductions; where
:func:`segment_logsumexp` and :func:`segment_softmax` read a per-segment
value back at each id, they index as ``jnp`` does (a negative id counts
from the end, then every id is clamped into range).

On the card a float32 sum accumulates in float64 and rounds once to
float32, as the kernels do: ``index_add_``'s float32 atomics flush
subnormal terms and sums to zero (two 2^-130 terms would sum to 0),
float64 atomics keep them. The float64 copy of the data is made
``SUM_CHUNK_BYTES`` at a time, so a sum over tens of millions of edge
messages needs one float64 accumulator of ``[num_segments + 1, ...]``
and no float64 copy of the whole input; the gradient is the output's
gradient gathered at each id, in float32. On the CPU ``index_add_``
sums in float32, which does not flush, and matches
``jax.ops.segment_sum`` exactly. On ``meta`` (the dry run) a sum takes
the card's path, so the dry run sees its float64 buffers.
"""

from __future__ import annotations

import torch

__all__ = ["segment_sum", "segment_min", "segment_max", "segment_mean",
           "segment_softmax", "segment_logsumexp", "count_segments",
           "reduce_identity", "SUM_CHUNK_BYTES"]

# the float64 copy of one chunk of a float32 sum on the card
SUM_CHUNK_BYTES = 1 << 30


def reduce_identity(combine: str, dtype: torch.dtype):
    """Python scalar identity of ``combine`` over ``dtype``."""
    if combine == "sum":
        return 0
    if dtype.is_floating_point:
        return float("inf") if combine == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if combine == "min" else info.min


def _spill_ids(segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """int64 ids, out-of-range ones sent to the spill row
    ``num_segments``."""
    ids = segment_ids.to(torch.int64)
    return torch.where((ids >= 0) & (ids < num_segments), ids, num_segments)


class _Float64Sum(torch.autograd.Function):
    """float32 segment sum accumulated in float64, one chunk of rows at a
    time; its gradient is the output's gathered at each id (0 at the
    spill row)."""

    @staticmethod
    def forward(ctx, data, ids, num_segments):
        acc = torch.zeros((num_segments + 1,) + tuple(data.shape[1:]),
                          dtype=torch.float64, device=data.device)
        width = max(1, data[:1].numel())
        rows = max(1, SUM_CHUNK_BYTES // (8 * width))
        for lo in range(0, data.shape[0], rows):
            acc.index_add_(0, ids[lo:lo + rows],
                           data[lo:lo + rows].to(torch.float64))
        ctx.save_for_backward(ids)
        return acc[:num_segments].to(torch.float32)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        padded = torch.cat([grad, grad.new_zeros((1,) + grad.shape[1:])])
        return padded[ids], None, None


def _segment(data: torch.Tensor, segment_ids: torch.Tensor,
             num_segments: int, combine: str) -> torch.Tensor:
    # one spill row past the end takes the out-of-range ids
    ids = _spill_ids(segment_ids, num_segments)
    if (combine == "sum" and data.device.type in ("cuda", "meta")
            and data.dtype == torch.float32):
        return _Float64Sum.apply(data, ids, num_segments)
    shape = (num_segments + 1,) + tuple(data.shape[1:])
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


def count_segments(segment_ids, num_segments: int) -> torch.Tensor:
    """int32 number of ids in each segment."""
    ones = torch.ones(segment_ids.shape[:1], dtype=torch.int32,
                      device=segment_ids.device)
    return segment_sum(ones, segment_ids, num_segments)


def segment_mean(data, segment_ids, num_segments: int) -> torch.Tensor:
    """Sum over count, the count floored at 1 (an empty segment is 0)."""
    s = segment_sum(data, segment_ids, num_segments)
    c = torch.clamp(count_segments(segment_ids, num_segments), min=1)
    return s / c.to(s.dtype).reshape((-1,) + (1,) * (s.ndim - 1))


def _take(values: torch.Tensor, segment_ids: torch.Tensor) -> torch.Tensor:
    """``values[segment_ids]`` with ``jnp``'s gather rules: a negative id
    counts from the end, then ids clamp into range."""
    n = values.shape[0]
    ids = segment_ids.to(torch.int64)
    ids = torch.clamp(torch.where(ids < 0, ids + n, ids), 0, n - 1)
    return values[ids]


def _finite_max(data, segment_ids, num_segments: int) -> torch.Tensor:
    """Per-segment max, 0 where it is not finite (an empty segment)."""
    mx = segment_max(data, segment_ids, num_segments)
    return torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))


def segment_logsumexp(data, segment_ids, num_segments: int) -> torch.Tensor:
    mx = _finite_max(data, segment_ids, num_segments)
    s = segment_sum(torch.exp(data - _take(mx, segment_ids)), segment_ids,
                    num_segments)
    return torch.log(torch.clamp(s, min=1e-30)) + mx


def segment_softmax(data, segment_ids, num_segments: int) -> torch.Tensor:
    """Softmax within each segment (GAT edge-softmax primitive)."""
    mx = _finite_max(data, segment_ids, num_segments)
    e = torch.exp(data - _take(mx, segment_ids))
    z = segment_sum(e, segment_ids, num_segments)
    return e / _take(torch.clamp(z, min=1e-30), segment_ids)
