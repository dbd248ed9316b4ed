"""Algebraic (semiring) formulation — paper §7.1. PyTorch port of
``repro.core.linalg``.

  pull  ≡ CSR SpMV: each output row privately reduces A's row — great for
          dense x, cannot exploit x's sparsity;
  push  ≡ CSC SpMSpV: iterate only the columns where x is nonzero,
          scatter-combine into y — exploits x's sparsity, needs combining
          writes.

:class:`Semiring` carries (⊕, ⊗, 0̄): plus-times gives PageRank, min-plus
SSSP relaxation, or-and BFS reachability. Both products return the same
vector; they differ in layout, access order and Cost.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from ..graphs.structure import Graph
from ..sparse.segment import segment_max, segment_min, segment_sum
from .cost_model import Cost, counter
from .primitives import frontier_out_edges, take_fill

__all__ = ["Semiring", "PLUS_TIMES", "MIN_PLUS", "OR_AND",
           "spmv_pull", "spmspv_push"]


@dataclasses.dataclass(frozen=True)
class Semiring:
    name: str
    combine: str                      # 'sum' | 'min' | 'max' segment reduce
    mul: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    zero: float

    def segment_reduce(self, vals, ids, n):
        fn = {"sum": segment_sum, "min": segment_min, "max": segment_max}[
            self.combine]
        return fn(vals, ids, n)


PLUS_TIMES = Semiring("plus_times", "sum", lambda x, w: x * w, 0.0)
MIN_PLUS = Semiring("min_plus", "min", lambda x, w: x + w, float("inf"))
OR_AND = Semiring("or_and", "max", lambda x, w: x, 0.0)


def _finite_or_zero(y: torch.Tensor, sr: Semiring) -> torch.Tensor:
    """Empty min/max rows hold ±inf after the reduce: map them to 0̄."""
    if sr.combine in ("min", "max") and y.dtype.is_floating_point:
        y = torch.where(torch.isfinite(y), y, sr.zero)
    return y


def spmv_pull(g: Graph, x: torch.Tensor, sr: Semiring = PLUS_TIMES,
              cost: Optional[Cost] = None) -> tuple[torch.Tensor, Cost]:
    """y = A ⊗ x in CSR (pull) order: y[v] = ⊕_{u in N_in(v)} x[u] ⊗ w."""
    cost = Cost.zeros(x.device) if cost is None else cost
    vals = sr.mul(take_fill(x, g.coo_src, sr.zero), g.coo_w)
    y = _finite_or_zero(sr.segment_reduce(vals, g.coo_dst, g.n), sr)
    cost = cost.charge(reads=counter(g.m, x.device),
                       writes=counter(g.n, x.device))
    return y, cost


def spmspv_push(g: Graph, x: torch.Tensor, nonzero: torch.Tensor,
                sr: Semiring = PLUS_TIMES, cost: Optional[Cost] = None
                ) -> tuple[torch.Tensor, Cost]:
    """y = A ⊗ x in CSC (push) order, exploiting x's sparsity mask.

    Only columns with ``nonzero[u]`` contribute; combining writes are
    charged per touched edge (int payload -> atomics, float -> locks).
    """
    cost = Cost.zeros(x.device) if cost is None else cost
    xe = take_fill(x, g.push_src, sr.zero)
    active = take_fill(nonzero, g.push_src, False)
    vals = sr.mul(xe, g.push_w)
    vals = torch.where(active, vals, vals.new_full((), sr.zero))
    if sr.combine == "min":
        vals = torch.where(active, vals, vals.new_full((), float("inf")))
    y = _finite_or_zero(sr.segment_reduce(vals, g.push_dst, g.n), sr)
    k = frontier_out_edges(g, nonzero)
    cost = cost.charge(reads=k).charge_combining_writes(
        k, float_data=x.dtype.is_floating_point)
    return y, cost
