"""EmbeddingBag (port of ``repro.sparse.embedding``).

The lookup is a pull: each bag gathers the rows it needs and combines
them privately. Out-of-range ids (outside ``[0, V)``) contribute zeros,
the padding convention of the reference.
"""

from __future__ import annotations

from typing import Optional

import torch

from .segment import segment_max, segment_sum

__all__ = ["embedding_bag", "one_hot_matmul_lookup"]

COMBINERS = ("sum", "mean", "max")


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  bag_ids: torch.Tensor, num_bags: int,
                  weights: Optional[torch.Tensor] = None,
                  combiner: str = "sum") -> torch.Tensor:
    """Gather ``table[ids]`` and combine per bag.

    table: float [V, d]; ids, bag_ids: int [k] (bags in any order);
    returns [num_bags, d]. ``weights`` [k] scale the rows; ``combiner``:
    sum, mean (over the bag's ids, in-range or not) or max (an empty bag,
    or one of out-of-range ids only, gives 0).
    """
    if combiner not in COMBINERS:
        raise ValueError(f"combiner {combiner!r} not in {COMBINERS}")
    V = table.shape[0]
    ok = (ids >= 0) & (ids < V)
    rows = table[torch.clamp(ids, 0, V - 1).long()]
    rows = torch.where(ok[:, None], rows, torch.zeros((), dtype=rows.dtype,
                                                      device=rows.device))
    if weights is not None:
        rows = rows * weights[:, None]
    if combiner == "sum":
        return segment_sum(rows, bag_ids, num_bags)
    if combiner == "mean":
        s = segment_sum(rows, bag_ids, num_bags)
        count = segment_sum(torch.ones_like(bag_ids, dtype=torch.int64),
                            bag_ids, num_bags)
        return s / torch.clamp(count, min=1).to(s.dtype)[:, None]
    out = segment_max(torch.where(ok[:, None], rows, float("-inf")),
                      bag_ids, num_bags)
    return torch.where(torch.isfinite(out), out, 0.0).to(rows.dtype)


def one_hot_matmul_lookup(table: torch.Tensor,
                          ids: torch.Tensor) -> torch.Tensor:
    """Lookup as onehot(ids) @ table (an out-of-range id gives a zero
    row)."""
    vocab = torch.arange(table.shape[0], device=ids.device)
    return (ids[:, None] == vocab[None, :]).to(table.dtype) @ table
