"""k-relaxation / k-filter on tensors (paper §4 'Cost Derivations').
PyTorch port of ``repro.core.primitives``.

Both directions are dense-frontier tensor ops with identical results and
different memory-access structure; each returns ``(value, Cost)`` with
the counts the paper's Table 1 charges:

  push: reads = Σ out_deg(frontier); combining writes = same (atomics for
        int payloads, locks for float payloads).
  pull: reads = Σ in_deg(touched dst) (all m when dst set is dense);
        writes = |touched dst|, zero atomics/locks.

These are the plain versions every kernel is checked against.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..graphs.structure import Graph, pad_values
from ..sparse.segment import (reduce_identity, segment_max, segment_min,
                              segment_sum)
from .cost_model import COUNTER, Cost, counter

__all__ = [
    "push_relax", "pull_relax", "pull_relax_ell", "k_filter",
    "frontier_out_edges", "frontier_in_edges", "COMBINE_FNS",
    "combine_identity", "mask_untouched", "take_fill",
]

COMBINE_FNS = {
    "sum": segment_sum,
    "max": segment_max,
    "min": segment_min,
}


def combine_identity(combine: str, dtype: torch.dtype):
    """Reduce identity (a python scalar): what an edge contributes when
    masked out, and what an empty segment holds after the reduce."""
    return reduce_identity(combine, dtype)


def mask_untouched(out: torch.Tensor, touched: torch.Tensor,
                   combine: str) -> torch.Tensor:
    """Set untouched destinations to the reduce identity; broadcasts a
    bool[n] mask over [n] or [n, d] outputs."""
    tb = touched.reshape((-1,) + (1,) * (out.ndim - 1))
    return torch.where(tb, out, combine_identity(combine, out.dtype))


def take_fill(values: torch.Tensor, idx: torch.Tensor,
              fill=0) -> torch.Tensor:
    """``values[idx]`` along axis 0, with ``fill`` where ``idx`` is out of
    range (``jnp.take(..., mode="fill")``)."""
    ok = (idx >= 0) & (idx < values.shape[0])
    got = values[torch.where(ok, idx, 0).to(torch.int64)]
    okb = ok.reshape(ok.shape + (1,) * (got.ndim - ok.ndim))
    return torch.where(okb, got, fill)


def frontier_out_edges(g: Graph, frontier: torch.Tensor) -> torch.Tensor:
    """Count of frontier-incident out-edges = push work (int64)."""
    return torch.where(frontier, g.out_deg, 0).to(COUNTER).sum()


def frontier_in_edges(g: Graph, touched: torch.Tensor) -> torch.Tensor:
    """Count of in-edges of touched destinations = pull work (int64)."""
    return torch.where(touched, g.in_deg, 0).to(COUNTER).sum()


def _edge_messages(values, src, w, msg_fn: Optional[Callable]):
    """Per-edge message = msg_fn(value[src], w); default value."""
    x = take_fill(values, src, 0)
    if msg_fn is None:
        return x
    return msg_fn(x, w)


def _width(values: torch.Tensor) -> int:
    return 1 if values.ndim == 1 else int(values.shape[-1])


def push_relax(g: Graph, values: torch.Tensor, frontier: torch.Tensor,
               combine: str = "sum", msg_fn: Optional[Callable] = None,
               cost: Optional[Cost] = None) -> tuple[torch.Tensor, Cost]:
    """Push k-relaxation over the push-major (CSC) edge order: only edges
    whose source is in ``frontier`` contribute. [n] or [n, d]."""
    cost = Cost.zeros(values.device) if cost is None else cost
    active_e = take_fill(frontier, g.push_src, False)
    msgs = _edge_messages(values, g.push_src, g.push_w, msg_fn)
    if msgs.ndim > 1:
        active_e = active_e.reshape((-1,) + (1,) * (msgs.ndim - 1))
    msgs = torch.where(active_e, msgs, combine_identity(combine, msgs.dtype))
    out = COMBINE_FNS[combine](msgs, g.push_dst, g.n)
    k = frontier_out_edges(g, frontier)
    width = _width(values)
    cost = cost.charge(reads=k * width).charge_combining_writes(
        k * width, float_data=values.dtype.is_floating_point)
    return out, cost


def pull_relax(g: Graph, values: torch.Tensor,
               touched: Optional[torch.Tensor] = None, combine: str = "sum",
               msg_fn: Optional[Callable] = None,
               cost: Optional[Cost] = None) -> tuple[torch.Tensor, Cost]:
    """Pull k-relaxation over the pull-major (CSR) edge order; ``touched``
    restricts which destinations are updated."""
    cost = Cost.zeros(values.device) if cost is None else cost
    msgs = _edge_messages(values, g.coo_src, g.coo_w, msg_fn)
    out = COMBINE_FNS[combine](msgs, g.coo_dst, g.n)
    if touched is None:
        k = counter(g.m, values.device)
        wr = counter(g.n, values.device)
    else:
        out = mask_untouched(out, touched, combine)
        k = frontier_in_edges(g, touched)
        wr = touched.to(COUNTER).sum()
    width = _width(values)
    return out, cost.charge(reads=k * width, writes=wr * width)


def pull_relax_ell(g: Graph, values: torch.Tensor, combine: str = "sum",
                   msg_fn: Optional[Callable] = None,
                   cost: Optional[Cost] = None
                   ) -> tuple[torch.Tensor, Cost]:
    """Pull relaxation in the ELL layout — dense [n, d_ell] gather and
    reduce; equals ``pull_relax`` with ``touched=None``. An int32 sum
    widens to int64, as ``jnp.sum`` does."""
    cost = Cost.zeros(values.device) if cost is None else cost
    gathered = pad_values(values)[g.ell_idx.to(torch.int64)]
    if msg_fn is not None:
        w = g.ell_w
        if gathered.ndim == 3:
            w = w[..., None]
        gathered = msg_fn(gathered, w)
    valid = g.ell_idx < g.n
    if gathered.ndim == 3:
        valid = valid[..., None]
    gathered = torch.where(valid, gathered,
                           combine_identity(combine, gathered.dtype))
    if combine == "sum":
        out = gathered.sum(dim=1)
    elif combine == "max":
        out = gathered.amax(dim=1)
    else:
        out = gathered.amin(dim=1)
    width = _width(values)
    return out, cost.charge(reads=counter(g.m, values.device) * width,
                            writes=counter(g.n, values.device) * width)


def k_filter(updated: torch.Tensor,
             cost: Cost) -> tuple[torch.Tensor, Cost]:
    """k-filter: the updated-vertex set (identity on the mask), charged
    the paper's prefix-sum cost (push only)."""
    k = updated.to(COUNTER).sum()
    return updated, cost.charge(reads=k, writes=k, barriers=1)
