"""PageRank — paper §3.1 / §4.1 / Algorithm 1 + §5-PA (Algorithm 8).
PyTorch port of ``repro.core.algorithms.pagerank``.

r(v) = (1-f)/n + f * Σ_{w∈N(v)} r(w)/d(w)

push: every vertex scatters r(v)/d(v) into each neighbor (float
      combining writes ⇒ O(Lm) locks, Table 1);
pull: every vertex gathers neighbors' r(w)/d(w) privately.

Partition-Awareness (push+PA): the adjacency is split into local and
remote halves; phase 1 updates owned neighbors with plain writes, phase
2 pushes across partitions (only those edges are charged as combining
writes), separated by a barrier — Algorithm 8.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...graphs.partition import pa_split, partition_1d
from ...graphs.structure import Graph
from ...sparse.segment import segment_sum
from ..cost_model import Cost
from ..direction import Direction, Fixed
from ..engine import VertexProgram

__all__ = ["pagerank", "pagerank_pa", "pagerank_pa_prepare",
           "PageRankResult", "pagerank_program", "pagerank_init"]


class PageRankResult(NamedTuple):
    ranks: torch.Tensor
    cost: Cost
    iterations: int


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


def pagerank(g: Graph, iters: int = 20, damp: float = 0.85,
             direction: str = "pull", use_ell: bool = False
             ) -> PageRankResult:
    """Power iteration; ``direction`` in {'push', 'pull'}; ``use_ell``
    selects the ELL pull layout. A thin wrapper over ``api.solve``."""
    from ... import api
    from ..backend import DenseBackend, EllBackend
    policy = Fixed(Direction.PUSH if direction == "push"
                   else Direction.PULL)
    backend = EllBackend() if use_ell else DenseBackend()
    r = api.solve(g, "pagerank", policy=policy, backend=backend,
                  iters=iters, damp=damp)
    return PageRankResult(ranks=r.state, cost=r.cost, iterations=iters)


def pagerank_pa_prepare(g: Graph, num_parts: int, iters: int = 20,
                        damp: float = 0.85):
    """Push-based PageRank with Partition-Awareness (Algorithm 8).

    Returns ``(run, stats)``: ``run()`` computes ``(ranks, cost)``; the
    host-side PA split (a representation change paid once per graph) is
    done here, outside the iterations.

    Phase 1 — each partition pushes along its *local* edges (plain
    writes); barrier; phase 2 — pushes along *remote* edges only
    (combining writes). Atomized updates drop from 2m to cut(m).
    """
    part = partition_1d(g.n, num_parts)
    local, remote, stats = pa_split(g, part)
    n = g.n
    cut_w = int(remote.count.sum())
    loc_w = int(local.count.sum())

    # pad ids are n: the source reads the zero row past the end, and
    # the destination is clamped to n - 1 with a zero message
    def ids(t: torch.Tensor) -> tuple:
        flat = t.reshape(-1).to(torch.int64)
        return flat.clamp(max=n), flat < n, flat.clamp(max=n - 1)
    l_src, l_ok, _ = ids(local.src)
    _, _, l_dst = ids(local.dst)
    r_src, r_ok, _ = ids(remote.src)
    _, _, r_dst = ids(remote.dst)

    def run():
        base = (1.0 - damp) / n
        r = torch.full((n,), 1.0 / n, dtype=torch.float32, device=g.device)
        cost = Cost.zeros(g.device)
        for _ in range(iters):
            x = torch.cat([_contrib(r, g.out_deg), r.new_zeros(1)])
            # phase 1: local edges — private writes, no conflicts
            acc_l = segment_sum(x[l_src] * l_ok, l_dst, n)
            cost = cost.charge(reads=loc_w, writes=loc_w, barriers=1)
            # phase 2: remote edges — combining (float -> lock-equivalent)
            acc_r = segment_sum(x[r_src] * r_ok, r_dst, n)
            cost = cost.charge(reads=cut_w).charge_combining_writes(
                cut_w, float_data=True)
            r = base + damp * (acc_l + acc_r)
            cost = cost.charge(reads=2 * n, iterations=1, barriers=1)
        return r, cost

    return run, stats


def pagerank_pa(g: Graph, num_parts: int, iters: int = 20,
                damp: float = 0.85) -> PageRankResult:
    run, _ = pagerank_pa_prepare(g, num_parts, iters, damp)
    r, cost = run()
    return PageRankResult(ranks=r, cost=cost, iterations=iters)
