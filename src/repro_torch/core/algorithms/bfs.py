"""BFS — paper §3.3 / §4.3 / Algorithm 3, with direction optimization.
PyTorch port of ``repro.core.algorithms.bfs`` (program and init).

push (top-down): frontier vertices mark unvisited out-neighbors;
pull (bottom-up): every unvisited vertex scans in-neighbors for a parent.

Parents are chosen with a combining-min over candidate parent ids, so the
result is deterministic and direction-independent (parent = min-id
neighbor in the previous level). :func:`bfs` is the thin legacy wrapper
around ``api.solve``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...graphs.structure import Graph
from ..cost_model import Cost
from ..direction import Direction, DirectionPolicy, Fixed
from ..engine import VertexProgram

__all__ = ["bfs", "BFSResult", "bfs_program", "bfs_init", "UNREACHED"]

UNREACHED = 2147483647


class BFSResult(NamedTuple):
    dist: torch.Tensor      # int32[n], UNREACHED if unreachable
    parent: torch.Tensor    # int32[n], n for none
    cost: Cost
    levels: int             # number of frontier expansions
    push_steps: int         # how many levels ran in push mode


def bfs_program(g: Graph, policy=None, backend=None
                ) -> tuple[VertexProgram, int]:
    """Level-synchronous BFS as a vertex program: frontier vertices
    advertise their own id, everyone else the sentinel n + 7; pull only
    inspects unvisited destinations."""
    n = g.n

    def values_fn(g_, state, frontier):
        ids = torch.arange(g_.n, dtype=torch.int32, device=frontier.device)
        return torch.where(frontier, ids, g_.n + 7)

    def update(state, msgs, step):
        visited = state["visited"]
        nxt = (~visited) & (msgs < n)
        new = {"dist": torch.where(nxt, step + 1, state["dist"]),
               "parent": torch.where(nxt, msgs.to(torch.int32),
                                     state["parent"]),
               "visited": visited | nxt}
        return new, nxt, ~nxt.any()

    prog = VertexProgram(combine="min", update_fn=update,
                         values_fn=values_fn, pull_touched="unvisited",
                         k_filter_push=True)
    return prog, n + 1


def bfs_init(g: Graph, root=0, **_):
    n, dev = g.n, g.device
    root = int(root)
    frontier0 = torch.zeros((n,), dtype=torch.bool, device=dev)
    frontier0[root] = True
    dist = torch.full((n,), UNREACHED, dtype=torch.int32, device=dev)
    dist[root] = 0
    parent = torch.full((n,), n, dtype=torch.int32, device=dev)
    parent[root] = root
    return {"dist": dist, "parent": parent,
            "visited": frontier0.clone()}, frontier0


def bfs(g: Graph, root: int,
        policy: DirectionPolicy = Fixed(Direction.PUSH)) -> BFSResult:
    """Legacy entry point — a thin wrapper over ``api.solve``."""
    from ... import api
    r = api.solve(g, "bfs", policy=policy, root=root)
    return BFSResult(dist=r.state["dist"], parent=r.state["parent"],
                     cost=r.cost, levels=r.steps, push_steps=r.push_steps)
