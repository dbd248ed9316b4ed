"""Personalized PageRank — the source-parameterized PageRank the service
layer batches. PyTorch port of ``repro.core.algorithms.ppr`` (program,
init, finalize).

    r = (1-f)·e_s + f · Σ_{w∈N(v)} r(w)/d(w)

The exchange is power-iteration PageRank's (every vertex active every
step, wire values are rank/out-degree contributions); the teleport mass
restarts at one source vertex. The iteration stops at a residual fixed
point: ``converged`` once the max rank change drops below ``tol``
(bounded by ``iters`` steps). :func:`personalized_pagerank` is the thin
convenience wrapper around ``api.solve``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...graphs.structure import Graph
from ..backend import DenseBackend, EllBackend, require_backend
from ..cost_model import Cost
from ..engine import VertexProgram

__all__ = ["personalized_pagerank", "PPRResult", "ppr_program", "ppr_init",
           "ppr_finalize"]


class PPRResult(NamedTuple):
    ranks: torch.Tensor     # float32[n]
    cost: Cost
    iterations: int
    residual: torch.Tensor


def ppr_program(g: Graph, iters: int = 100, damp: float = 0.85,
                tol: float = 1e-6, policy=None, backend=None
                ) -> tuple[VertexProgram, int]:
    """Personalized power iteration as a vertex program; the teleport
    vector ``base = (1-damp)·e_source`` lives in the state."""
    require_backend("ppr", backend, DenseBackend, EllBackend)
    n = g.n
    damp_t = torch.tensor(float(damp), dtype=torch.float32)
    tol = float(tol)

    def values_fn(g_, state, frontier):
        deg = g_.out_deg.clamp(min=1).to(torch.float32)
        return state["rank"] / deg

    def update(state, msgs, step):
        rank = state["base"] + damp_t.to(msgs.device) * msgs
        resid = (rank - state["rank"]).abs().max()
        new = {"rank": rank, "base": state["base"], "resid": resid}
        ones = torch.ones((n,), dtype=torch.bool, device=msgs.device)
        return new, ones, resid < tol

    prog = VertexProgram(combine="sum", update_fn=update,
                         values_fn=values_fn,
                         # reading own rank + degree for the contribution
                         step_charges=(("reads", 2 * n),))
    return prog, iters


def ppr_init(g: Graph, source=0, damp: float = 0.85, **_):
    base = torch.zeros((g.n,), dtype=torch.float32, device=g.device)
    base[int(source)] = torch.tensor(1.0 - damp, dtype=torch.float32)
    state0 = {"rank": base, "base": base,
              "resid": torch.tensor(float("inf"), dtype=torch.float32,
                                    device=g.device)}
    return state0, torch.ones((g.n,), dtype=torch.bool, device=g.device)


def ppr_finalize(g: Graph, state):
    return {"ranks": state["rank"], "residual": state["resid"]}


def personalized_pagerank(g: Graph, source: int, iters: int = 100,
                          damp: float = 0.85, tol: float = 1e-6,
                          direction: str = "pull") -> PPRResult:
    """Convenience wrapper over ``api.solve`` (policy = Fixed)."""
    from ... import api
    r = api.solve(g, "ppr", policy=direction, source=source, iters=iters,
                  damp=damp, tol=tol)
    return PPRResult(ranks=r.state["ranks"], cost=r.cost,
                     iterations=r.steps, residual=r.state["residual"])
