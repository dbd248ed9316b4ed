"""Weakly Connected Components — min-label propagation. PyTorch port of
``repro.core.algorithms.wcc``.

push: changed vertices push their label to neighbors (combining-min; the
      frontier shrinks as labels settle);
pull: every vertex re-reduces over in-neighbors (no combining writes).
GenericSwitch direction-optimizes like BFS. Registered with
``repro_torch.api`` as ``"wcc"``; :func:`wcc` is the thin legacy wrapper.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...graphs.structure import Graph
from ..cost_model import Cost
from ..direction import Direction, DirectionPolicy, Fixed
from ..engine import VertexProgram

__all__ = ["wcc", "WCCResult", "wcc_program", "wcc_init"]


class WCCResult(NamedTuple):
    labels: torch.Tensor         # int32[n] min vertex id of the component
    num_components: torch.Tensor
    cost: Cost
    steps: int


def wcc_program(g: Graph, max_steps: int = 10_000, policy=None,
                backend=None) -> tuple[VertexProgram, int]:
    def update(state, msgs, step):
        new = torch.minimum(state, msgs)
        frontier = new < state
        return new, frontier, ~frontier.any()

    return VertexProgram(combine="min", update_fn=update), max_steps


def wcc_init(g: Graph, **_):
    return (torch.arange(g.n, dtype=torch.int32, device=g.device),
            torch.ones((g.n,), dtype=torch.bool, device=g.device))


def wcc(g: Graph, policy: DirectionPolicy = Fixed(Direction.PULL),
        max_steps: int = 10_000) -> WCCResult:
    """Legacy entry point — a thin wrapper over ``api.solve``."""
    from ... import api
    r = api.solve(g, "wcc", policy=policy, max_steps=max_steps)
    roots = r.state == torch.arange(g.n, dtype=torch.int32,
                                    device=g.device)
    return WCCResult(labels=r.state,
                     num_components=roots.to(torch.int32).sum(),
                     cost=r.cost, steps=r.steps)
