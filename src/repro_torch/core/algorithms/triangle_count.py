"""Triangle Counting — paper §3.2 / §4.2 / Algorithm 2 (NodeIterator).
PyTorch port of ``repro.core.algorithms.triangle_count``.

For every edge (v,u) intersect N(v) ∩ N(u). Each triangle {v,u,w} is
seen once per ordered pair of its other two vertices at v, so per-vertex
counts halve at the end:

  pull: t[v] accumulates |N(v) ∩ N(u)| into tc(v) — private accumulation
        (0 atomics; O(m·d̂) reads);
  push: the intersection size is credited to the *other* endpoint —
        combining integer writes (FAA; O(m·d̂) atomics, Table 1).

The engine's *one-shot edge map*: one ``local_fn`` step per block of
``edge_block`` edges, no fixed point — the step bound is the block
count. Counts are identical across directions (the edge list is
symmetric); only the Cost differs.

The intersection compares two gathered ELL rows all-pairs, a
``[edge_block, d_ell, d_ell]`` mask per step: O(m·d_ell²) work, fine on
bounded-degree graphs and out of reach where d_ell is a power-law hub's
degree (in the JAX package as here).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...graphs.structure import Graph
from ...sparse.segment import segment_sum
from ..backend import DenseBackend, EllBackend, require_backend
from ..cost_model import COUNTER, Cost
from ..direction import Direction, Fixed
from ..engine import VertexProgram

__all__ = ["triangle_count", "TriangleCountResult", "triangle_program",
           "triangle_init", "triangle_finalize"]


class TriangleCountResult(NamedTuple):
    per_vertex: torch.Tensor   # int32[n] triangles through each vertex
    total: torch.Tensor        # int64 total triangle count
    cost: Cost


def triangle_program(g: Graph, edge_block: int = 4096, policy=None,
                     backend=None) -> tuple[VertexProgram, int]:
    """NodeIterator TC as a one-shot blocked edge map (no fixed point)."""
    require_backend("triangle_count", backend, DenseBackend, EllBackend)
    n, d_ell = g.n, g.d_ell
    num_blocks = -(-g.m // edge_block)

    def local_fn(g_, state, frontier, step, do_push, cost):
        # the padded edge list lives in the carry (built once in init)
        lo = step * edge_block
        s = state["src"][lo:lo + edge_block]
        d = state["dst"][lo:lo + edge_block]
        s_c = s.clamp(max=n - 1).to(torch.int64)
        d_c = d.clamp(max=n - 1).to(torch.int64)
        nv = g_.ell_idx[s_c]                         # [B, d_ell]
        nu = g_.ell_idx[d_c]                         # [B, d_ell]
        # all-pairs equality; ELL's own sentinel (=n) never matches a
        # real id, and pad edges (s or d == n) are zeroed below
        eq = (nv[:, :, None] == nu[:, None, :]) & (nv[:, :, None] < n)
        common = eq.sum(dim=(1, 2)).to(torch.int32)  # |N(v) ∩ N(u)|
        common = torch.where((s < n) & (d < n), common, 0)
        # accumulate into the iterating endpoint; the symmetric edge list
        # makes crediting src (push) and dst (pull) the same total
        new_state = dict(state, tc=state["tc"] + segment_sum(common, d_c,
                                                             n))
        if do_push:
            cost = cost.charge(reads=2 * edge_block * d_ell
                               ).charge_combining_writes(
                common.to(COUNTER).sum(), float_data=False)
        else:
            cost = cost.charge(reads=2 * edge_block * d_ell,
                               writes=edge_block)
        return new_state, frontier, step + 1 >= num_blocks, cost

    return VertexProgram(local_fn=local_fn), num_blocks


def triangle_init(g: Graph, edge_block: int = 4096, **_):
    num_blocks = -(-g.m // edge_block)
    m_pad = num_blocks * edge_block

    def padded(t: torch.Tensor) -> torch.Tensor:
        return torch.cat([t, t.new_full((m_pad - g.m,), g.n)])
    state0 = {
        "tc": torch.zeros((g.n,), dtype=torch.int32, device=g.device),
        "src": padded(g.coo_src),
        "dst": padded(g.coo_dst),
    }
    return state0, torch.ones((g.n,), dtype=torch.bool, device=g.device)


def triangle_finalize(g: Graph, state):
    # each triangle at v is counted once per ordered pair of its two other
    # vertices adjacent to v => 2x per vertex
    per_vertex = state["tc"] // 2
    total = per_vertex.to(COUNTER).sum() // 3
    return {"per_vertex": per_vertex, "total": total}


def triangle_count(g: Graph, direction: str = "pull",
                   edge_block: int = 4096) -> TriangleCountResult:
    """Legacy entry point — a thin wrapper over ``api.solve``."""
    from ... import api
    policy = Fixed(Direction.PUSH if direction == "push"
                   else Direction.PULL)
    r = api.solve(g, "triangle_count", policy=policy,
                  edge_block=edge_block)
    return TriangleCountResult(per_vertex=r.state["per_vertex"],
                               total=r.state["total"], cost=r.cost)
