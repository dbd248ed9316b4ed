"""Data-driven (residual) PageRank — Whang et al. [60], the paper's §3.1
source, in its incremental form. PyTorch port of
``repro.core.algorithms.pr_delta``.

Only vertices with residual above tolerance are active; they distribute
damp·res/d(v) to their neighbors and bank res into their rank. Work per
round ∝ active out-edges.

push: active vertices scatter residual shares (float combining writes on
      the active edge set only);
pull: every vertex gathers the active residual shares (reads all m).

Both converge to the fixpoint of power iteration. The tolerance is
absolute: the initial residual is (1 - damp) / n, so a tolerance above it
converges at step 0. Registered with ``repro_torch.api`` as
``"pr_delta"``; :func:`pagerank_delta` is the thin legacy wrapper.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...graphs.structure import Graph
from ..cost_model import COUNTER, Cost
from ..direction import Direction, Fixed
from ..engine import VertexProgram

__all__ = ["pagerank_delta", "PRDeltaResult", "pr_delta_program",
           "pr_delta_init", "pr_delta_finalize"]


class PRDeltaResult(NamedTuple):
    ranks: torch.Tensor
    cost: Cost
    rounds: int
    max_residual: torch.Tensor


def pr_delta_program(g: Graph, tol: float = 1e-6, damp: float = 0.85,
                     policy=None, backend=None
                     ) -> tuple[VertexProgram, int]:
    def values_fn(g_, state, frontier):
        deg = g_.out_deg.clamp(min=1).to(torch.float32)
        return torch.where(frontier, damp * state["res"] / deg, 0.0)

    def update(state, msgs, step):
        # `active` equals the frontier the engine just relaxed: the
        # residual field is untouched since it was derived
        active = state["res"].abs() > tol
        rank = state["rank"] + torch.where(active, state["res"], 0.0)
        res = torch.where(active, 0.0, state["res"]) + msgs
        nxt = res.abs() > tol
        return {"rank": rank, "res": res}, nxt, ~nxt.any()

    def charge_fn(g_, state, frontier):
        # banking res into rank: one write per active vertex
        return {"writes": frontier.to(COUNTER).sum()}

    prog = VertexProgram(combine="sum", update_fn=update,
                         values_fn=values_fn, charge_fn=charge_fn)
    return prog, 10_000


def pr_delta_init(g: Graph, tol: float = 1e-6, damp: float = 0.85, **_):
    n = g.n
    state0 = {"rank": torch.zeros((n,), dtype=torch.float32,
                                  device=g.device),
              "res": torch.full((n,), (1.0 - damp) / n, dtype=torch.float32,
                                device=g.device)}
    return state0, state0["res"].abs() > tol


def pr_delta_finalize(g, state):
    return {"ranks": state["rank"] + state["res"],
            "max_residual": state["res"].abs().max()}


def pagerank_delta(g: Graph, tol: float = 1e-6, damp: float = 0.85,
                   direction: str = "push", max_rounds: int = 10_000
                   ) -> PRDeltaResult:
    """Legacy entry point — a thin wrapper over ``api.solve``."""
    from ... import api
    policy = Fixed(Direction.PUSH if direction == "push"
                   else Direction.PULL)
    r = api.solve(g, "pr_delta", policy=policy, max_steps=max_rounds,
                  tol=tol, damp=damp)
    return PRDeltaResult(ranks=r.state["ranks"], cost=r.cost,
                         rounds=r.steps,
                         max_residual=r.state["max_residual"])
