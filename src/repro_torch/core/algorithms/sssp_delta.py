"""Δ-Stepping SSSP — paper §3.4 / §4.4 / Algorithm 4. PyTorch port of
``repro.core.algorithms.sssp_delta`` (program, init, finalize).

Vertices are grouped into distance buckets of width Δ; epoch b settles
all vertices with tentative distance in [bΔ, (b+1)Δ) by repeated
relaxation.

push: active bucket vertices relax their out-edges (float combining
      writes);
pull: every unsettled vertex scans in-edges for sources in the current
      bucket and relaxes privately.

The engine's epoch loop is the bucket loop; one relaxation phase per
epoch is the inner iteration, and its ``enter_fn`` computes the current
bucket's frontier. Bucket bounds are float32 products, as in the JAX
package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...graphs.structure import Graph
from ...shard.backend import ShardedBackend
from ..backend import DenseBackend, EllBackend, require_backend
from ..cost_model import Cost
from ..direction import Direction, Fixed
from ..engine import Phase, PhaseProgram, VertexProgram

__all__ = ["sssp_delta", "SSSPResult", "sssp_delta_program",
           "sssp_delta_init", "sssp_delta_finalize"]

_INF = float("inf")


def _lo(epoch: int, delta: float, device) -> torch.Tensor:
    f32 = torch.float32
    return (torch.tensor(epoch, dtype=f32, device=device)
            * torch.tensor(delta, dtype=f32, device=device))


class SSSPResult(NamedTuple):
    dist: torch.Tensor      # float32[n]
    cost: Cost
    epochs: int             # buckets processed
    inner_iters: int


def _in_bucket(d: torch.Tensor, lo: torch.Tensor,
               delta: float) -> torch.Tensor:
    hi = lo + torch.tensor(delta, dtype=torch.float32, device=lo.device)
    return torch.isfinite(d) & (d >= lo) & (d < hi)


def sssp_delta_program(g: Graph, delta: float = 2.0, max_inner: int = 64,
                       max_epochs: int = 1 << 14, policy=None, backend=None
                       ) -> tuple[PhaseProgram, int]:
    """Δ-stepping as a phase program (bucket epochs × inner relaxations).
    Wire values are the distances of current-bucket sources (∞
    elsewhere); combine=min with msg = d + w. Pull touches the unsettled
    set (d ≥ bΔ)."""
    require_backend("sssp_delta", backend, DenseBackend, EllBackend,
                    ShardedBackend)
    delta = float(delta)

    def enter(g_, state, frontier, epoch):
        lo = _lo(epoch, delta, state["dist"].device)
        return ({"dist": state["dist"], "lo": lo},
                _in_bucket(state["dist"], lo, delta))

    def values_fn(g_, state, frontier):
        return torch.where(frontier, state["dist"], _INF)

    def touched_fn(g_, state, frontier, visited):
        return state["dist"] >= state["lo"]      # unsettled: bucket+beyond

    def update(state, msgs, step):
        d = state["dist"]
        d_new = torch.minimum(d, msgs)
        changed = d_new < d
        frontier = _in_bucket(d_new, state["lo"], delta)
        return ({"dist": d_new, "lo": state["lo"]}, frontier,
                ~changed.any())

    def epoch_cond(g_, state, epoch):
        d = state["dist"]
        lo = _lo(epoch, delta, d.device)
        return (torch.isfinite(d) & (d >= lo)).any()

    prog = VertexProgram(combine="min", msg_fn=lambda x, w: x + w,
                         update_fn=update, values_fn=values_fn,
                         touched_fn=touched_fn,
                         # push compacts the vertices whose distance
                         # actually improved, not the whole bucket
                         k_filter_push=True,
                         k_filter_set_fn=lambda old, new, f:
                             new["dist"] < old["dist"])
    pp = PhaseProgram(phases=(Phase(program=prog, max_steps=max_inner,
                                    name="relax", enter_fn=enter),),
                      epoch_cond=epoch_cond)
    return pp, max_epochs


def sssp_delta_init(g: Graph, source=0, **_):
    d0 = torch.full((g.n,), _INF, dtype=torch.float32, device=g.device)
    d0[int(source)] = 0.0
    state0 = {"dist": d0,
              "lo": torch.zeros((), dtype=torch.float32, device=g.device)}
    # the phase's enter_fn recomputes the bucket frontier every epoch
    return state0, torch.zeros((g.n,), dtype=torch.bool, device=g.device)


def sssp_delta_finalize(g: Graph, state):
    return {"dist": state["dist"]}


def sssp_delta(g: Graph, source: int, delta: float = 2.0,
               direction: str = "push", max_epochs: int = 1 << 14,
               max_inner: int = 64) -> SSSPResult:
    """Legacy entry point — a thin wrapper over ``api.solve``."""
    from ... import api
    policy = Fixed(Direction.PUSH if direction == "push"
                   else Direction.PULL)
    r = api.solve(g, "sssp_delta", policy=policy, source=source,
                  delta=delta, max_inner=max_inner, max_steps=max_epochs)
    return SSSPResult(dist=r.state["dist"], cost=r.cost, epochs=r.epochs,
                      inner_iters=r.steps)
