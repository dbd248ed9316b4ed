"""Betweenness Centrality (Brandes) — paper §3.5 / §4.5 / Algorithm 5.
PyTorch port of ``repro.core.algorithms.betweenness``.

Two phases per source s:
  1. forward: BFS computing level(v) and σ(v) = #shortest s-v paths —
     the paper's generalized BFS with ⊕ = +: push scatters σ into the next
     level (float combining writes), pull gathers σ from the previous
     level's in-neighbors (reads only);
  2. backward: dependency accumulation
        δ(v) = Σ_{w: v ∈ pred(w)} σ(v)/σ(w) · (1 + δ(w)),
     push sends partial centralities to predecessors; pull uses Madduri's
     successor trick — each v pulls from its successors.

The two phases are a forward/backward :class:`~repro_torch.core.engine
.Phase` pair inside one :class:`~repro_torch.core.engine.PhaseProgram`,
one source per epoch; bc(v) = Σ_{s≠v} δ_s(v). σ is float32, as in the
JAX package: on long-diameter graphs path counts overflow it (a grid's
grow like binomial coefficients) and δ turns NaN there, in both
packages alike. Registered with ``repro_torch.api`` as
``"betweenness"``; :func:`betweenness_centrality` is the legacy wrapper.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...graphs.structure import Graph
from ..backend import DenseBackend, EllBackend, require_backend
from ..cost_model import Cost
from ..direction import Direction, Fixed
from ..engine import Phase, PhaseProgram, VertexProgram

__all__ = ["betweenness_centrality", "BCResult", "betweenness_program",
           "betweenness_init", "betweenness_finalize", "UNREACHED"]

UNREACHED = 2147483647


class BCResult(NamedTuple):
    bc: torch.Tensor     # float32[n]
    cost: Cost
    max_level: torch.Tensor


def betweenness_program(g: Graph, num_sources: int = 8,
                        source_offset: int = 0, policy=None, backend=None
                        ) -> tuple[PhaseProgram, int]:
    """Brandes BC as a forward/backward phase pair, one source per epoch
    (source ``(epoch + source_offset) % n``).

    The graph must be symmetric (undirected), so push on the same edge
    list is the reverse-edge scatter."""
    require_backend("betweenness", backend, DenseBackend, EllBackend)
    n = g.n

    # -- phase 1: forward BFS accumulating σ ------------------------------
    def fwd_enter(g_, state, frontier, epoch):
        s = (epoch + source_offset) % n
        dev = state["level"].device
        ids = torch.arange(n, dtype=torch.int32, device=dev)
        at_s = ids == s
        state = dict(state)
        state["src"] = torch.tensor(s, dtype=torch.int32, device=dev)
        state["level"] = torch.where(at_s, 0, UNREACHED).to(torch.int32)
        state["sigma"] = at_s.to(torch.float32)
        state["visited"] = at_s
        state["delta"] = torch.zeros((n,), dtype=torch.float32, device=dev)
        state["lvl"] = torch.zeros((), dtype=torch.int32, device=dev)
        return state, at_s.clone()

    def fwd_values(g_, state, frontier):
        return torch.where(frontier, state["sigma"], 0.0)

    def fwd_update(state, msgs, step):
        visited = state["visited"]
        nxt = (~visited) & (msgs > 0)
        state = dict(state)
        state["sigma"] = torch.where(nxt, msgs, state["sigma"])
        state["level"] = torch.where(nxt, step + 1, state["level"]).to(
            torch.int32)
        state["visited"] = visited | nxt
        return state, nxt, ~nxt.any()

    forward = VertexProgram(combine="sum", update_fn=fwd_update,
                            values_fn=fwd_values, pull_touched="unvisited")

    # -- phase 2: backward dependency accumulation, deepest level first ---
    def bwd_enter(g_, state, frontier, epoch):
        level = state["level"]
        max_level = torch.where(level == UNREACHED, 0, level).max()
        state = dict(state)
        state["lvl"] = max_level
        state["ml"] = torch.maximum(state["ml"], max_level)
        return state, (level == max_level) & (max_level > 0)

    def bwd_values(g_, state, frontier):
        # contribution of each vertex w at the current level to its
        # predecessors: (1 + δ(w)) / σ(w)  (the σ(v) factor lands at v)
        safe_sigma = state["sigma"].clamp(min=1e-30)
        return torch.where(frontier, (1.0 + state["delta"]) / safe_sigma,
                           0.0)

    def bwd_touched(g_, state, frontier, visited):
        # Madduri successor trick: predecessors pull from successors
        return state["level"] == state["lvl"] - 1

    def bwd_update(state, msgs, step):
        lvl = state["lvl"]
        v_mask = state["level"] == lvl - 1
        state = dict(state)
        state["delta"] = state["delta"] + torch.where(
            v_mask, state["sigma"] * msgs, 0.0)
        new_lvl = lvl - 1
        state["lvl"] = new_lvl
        frontier = (state["level"] == new_lvl) & (new_lvl >= 1)
        return state, frontier, ~frontier.any()

    backward = VertexProgram(combine="sum", update_fn=bwd_update,
                             values_fn=bwd_values, touched_fn=bwd_touched)

    # -- per-source epilogue: fold δ_s into bc ----------------------------
    def epoch_exit(g_, state, frontier, epoch):
        ids = torch.arange(n, dtype=torch.int32, device=frontier.device)
        contrib = torch.where(ids == state["src"], 0.0, state["delta"])
        contrib = torch.where(state["level"] == UNREACHED, 0.0, contrib)
        state = dict(state)
        state["bc"] = state["bc"] + contrib
        return state, frontier

    pp = PhaseProgram(
        phases=(Phase(program=forward, max_steps=n + 1, name="forward",
                      enter_fn=fwd_enter),
                Phase(program=backward, max_steps=n + 1, name="backward",
                      enter_fn=bwd_enter)),
        epoch_exit_fn=epoch_exit)
    return pp, num_sources


def betweenness_init(g: Graph, **_):
    n, dev = g.n, g.device

    def scalar():
        return torch.zeros((), dtype=torch.int32, device=dev)
    state0 = {
        "bc": torch.zeros((n,), dtype=torch.float32, device=dev),
        "ml": scalar(),
        "src": scalar(),
        "lvl": scalar(),
        "level": torch.full((n,), UNREACHED, dtype=torch.int32, device=dev),
        "sigma": torch.zeros((n,), dtype=torch.float32, device=dev),
        "visited": torch.zeros((n,), dtype=torch.bool, device=dev),
        "delta": torch.zeros((n,), dtype=torch.float32, device=dev),
    }
    return state0, torch.zeros((n,), dtype=torch.bool, device=dev)


def betweenness_finalize(g: Graph, state):
    return {"bc": state["bc"], "max_level": state["ml"]}


def betweenness_centrality(g: Graph, direction: str = "pull",
                           num_sources: int = 8,
                           source_offset: int = 0) -> BCResult:
    """Legacy entry point — a thin wrapper over ``api.solve``."""
    from ... import api
    policy = Fixed(Direction.PUSH if direction == "push"
                   else Direction.PULL)
    r = api.solve(g, "betweenness", policy=policy,
                  num_sources=num_sources, source_offset=source_offset)
    return BCResult(bc=r.state["bc"], cost=r.cost,
                    max_level=r.state["max_level"])
