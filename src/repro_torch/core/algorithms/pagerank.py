"""PageRank — paper §3.1 / §4.1 / Algorithm 1. PyTorch port of
``repro.core.algorithms.pagerank`` (program and init).

r(v) = (1-f)/n + f * Σ_{w∈N(v)} r(w)/d(w)

push: every vertex scatters r(v)/d(v) into each neighbor (float
      combining writes ⇒ O(Lm) locks, Table 1);
pull: every vertex gathers neighbors' r(w)/d(w) privately.
"""

from __future__ import annotations

import torch

from ...graphs.structure import Graph
from ..engine import VertexProgram

__all__ = ["pagerank_program", "pagerank_init"]


def _contrib(r: torch.Tensor, out_deg: torch.Tensor) -> torch.Tensor:
    return r / out_deg.clamp(min=1).to(r.dtype)


def pagerank_program(g: Graph, iters: int = 20, damp: float = 0.85,
                     policy=None, backend=None
                     ) -> tuple[VertexProgram, int]:
    """Power iteration as a vertex program: every vertex is active every
    step; wire values are rank/out-degree contributions."""
    n = g.n
    base = (1.0 - damp) / n

    def values_fn(g_, state, frontier):
        return _contrib(state, g_.out_deg)

    def update(state, msgs, step):
        ones = torch.ones((n,), dtype=torch.bool, device=msgs.device)
        return base + damp * msgs, ones, torch.tensor(False)

    prog = VertexProgram(combine="sum", update_fn=update,
                         values_fn=values_fn,
                         # reading own rank + degree for the contribution
                         step_charges=(("reads", 2 * n),))
    return prog, iters


def pagerank_init(g: Graph, **_):
    n = g.n
    return (torch.full((n,), 1.0 / n, dtype=torch.float32, device=g.device),
            torch.ones((n,), dtype=torch.bool, device=g.device))
