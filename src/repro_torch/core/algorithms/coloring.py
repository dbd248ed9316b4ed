"""Boman Graph Coloring — paper §3.6 / §4.6 / Algorithm 6 + §5 strategies
(FE Frontier-Exploit, GS Generic-Switch, GrS Greedy-Switch, CR
Conflict-Removal, Algorithm 9). PyTorch port of
``repro.core.algorithms.coloring``.

Structure per iteration (Algorithm 6):
  phase 1  seq_color_partition: each partition greedily first-fit colors
           its own uncolored vertices — sequential within, parallel
           across partitions: slot i of every partition colors in one
           [P]-vector step, S = ceil(n / P) steps (a host loop here);
  phase 2  fix_conflicts over border vertices:
           push — the iterating endpoint writes the other endpoint's
                  state (cross-partition CAS; combining writes);
           pull — each endpoint re-checks and demotes itself (reads).
           The loser of a conflict is the higher vertex id (the result is
           direction-independent).

The baseline runs as a two-phase :class:`~repro_torch.core.engine
.PhaseProgram` (engine epoch = Algorithm 6 iteration) of ``local_fn``
steps: they never touch the exchange backend, but the policy still
decides push or pull per step and the phases charge the matching Table-1
cost. Registered with ``repro_torch.api`` as ``"coloring"``;
:func:`boman_coloring` is the thin legacy wrapper. FE / GS / CR remain
standalone strategies.

Colors are 1..C; 0 = uncolored.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ...graphs.partition import partition_1d
from ...graphs.structure import Graph
from ...sparse.segment import segment_max
from ..backend import DenseBackend, EllBackend, require_backend
from ..cost_model import COUNTER, Cost, counter
from ..direction import Direction, Fixed
from ..engine import Phase, PhaseProgram, VertexProgram

__all__ = ["boman_coloring", "fe_coloring", "greedy_sequential",
           "conflict_removal_coloring", "ColoringResult",
           "validate_coloring", "coloring_program", "coloring_init",
           "coloring_finalize"]


class ColoringResult(NamedTuple):
    colors: torch.Tensor      # int32[n] in 1..C (0 only if C exhausted)
    cost: Cost
    iterations: int
    num_colors: torch.Tensor


def validate_coloring(g: Graph, colors: torch.Tensor) -> torch.Tensor:
    """True iff no edge joins two equal nonzero colors."""
    cs = colors[g.coo_src.long()]
    cd = colors[g.coo_dst.long()]
    return ~((cs == cd) & (cs > 0)).any()


def _used_mask(g: Graph, v_ids: torch.Tensor, colors: torch.Tensor,
               C: int) -> torch.Tensor:
    """bool[k, C+1]: colors already used in N(v) for each v in v_ids (the
    reference's one-hot sum over neighbors, as a scatter)."""
    nbrs = g.ell_idx[v_ids.clamp(max=g.n - 1).long()]      # [k, d_ell]
    ncol = torch.cat([colors, colors.new_zeros(1)])[nbrs.long()]
    ncol = torch.where(nbrs < g.n, ncol, 0)               # sentinel -> 0
    used = torch.zeros((nbrs.shape[0], C + 1), dtype=torch.bool,
                       device=colors.device)
    return used.scatter_(1, ncol.long(), True)


def _first_fit(used: torch.Tensor) -> torch.Tensor:
    """Smallest color in 1..C not present in ``used`` [k, C+1]; 0 if
    none."""
    free = ~used[:, 1:]                                    # colors 1..C
    pick = free.to(torch.uint8).argmax(dim=-1).to(torch.int32) + 1
    return torch.where(free.any(dim=-1), pick, 0)


def _phase1(g: Graph, colors: torch.Tensor, P: int, C: int, cost: Cost,
            only_mask: Optional[torch.Tensor] = None):
    """seq_color_partition for all partitions (slot-synchronous greedy)."""
    part = partition_1d(g.n, P)
    S = part.shard_size
    dev = colors.device
    lanes = S * torch.arange(P, dtype=torch.int32, device=dev)
    # colors plus one spare slot. Lanes past n read and write vertex n-1
    # with their old color, as in the reference, whose scatter applies a
    # slot's writes in lane order: a lane whose write the next lane
    # repeats writes the spare slot instead, so the last write to n-1
    # wins here too
    buf = torch.cat([colors, colors.new_zeros(1)])
    spare = torch.full((P,), g.n, dtype=torch.int64, device=dev)
    for i in range(S):
        idx = i + lanes
        v = idx.clamp(max=g.n - 1)
        valid = idx < g.n
        old = buf[v.long()]
        todo = (old == 0) & valid
        if only_mask is not None:
            todo &= only_mask[v.long()]
        pick = _first_fit(_used_mask(g, v, buf[:g.n], C))
        new = torch.where(todo, pick, old)
        last = torch.cat([v[:-1] != v[1:], valid.new_ones(1)])
        buf.scatter_(0, torch.where(last, v.long(), spare), new)
        # reads: neighbor color scan; writes: one private write per vertex
        cost = cost.charge(
            reads=torch.where(todo, g.in_deg[v.long()], 0).to(COUNTER).sum(),
            writes=todo.to(COUNTER).sum())
    return buf[:g.n], cost


def _fix_conflicts(g: Graph, colors: torch.Tensor, P: int, do_push: bool,
                   cost: Cost):
    """Phase 2: demote the higher-id endpoint of every conflicting
    cross-partition edge. The demotion is direction-independent; push
    writes the neighbor (combining int writes), pull re-checks and writes
    self (remote reads) — only the Cost differs."""
    part = partition_1d(g.n, P)
    own_s = part.owner(g.coo_src)
    own_d = part.owner(g.coo_dst)
    cs = colors[g.coo_src.long()]
    cd = colors[g.coo_dst.long()]
    cross = own_s != own_d
    conflict = cross & (cs == cd) & (cs > 0)
    n_conf = conflict.to(COUNTER).sum()
    # loser = higher id endpoint; the symmetric edge list covers both
    demote_dst = conflict & (g.coo_dst > g.coo_src)
    demote = segment_max(demote_dst.to(torch.int32), g.coo_dst, g.n) > 0
    colors = torch.where(demote, 0, colors)
    # the border scan reads both endpoint colors
    cost = cost.charge(reads=2 * cross.to(COUNTER).sum())
    if do_push:
        # the iterating endpoint CASes the other endpoint's color slot
        cost = cost.charge_combining_writes(n_conf, float_data=False)
    else:
        # the loser re-reads its neighbors and demotes itself (private)
        cost = cost.charge(reads=n_conf, writes=demote.to(COUNTER).sum())
    return colors, cost, n_conf


def coloring_program(g: Graph, num_parts: int = 16, C: int = 64,
                     max_iters: int = 64, policy=None, backend=None
                     ) -> tuple[PhaseProgram, int]:
    """Baseline BGC (Algorithm 6) as a two-phase engine program."""
    require_backend("coloring", backend, DenseBackend, EllBackend)

    def color_enter(g_, state, frontier, epoch):
        return state, state["colors"] == 0

    def color_local(g_, state, frontier, step, do_push, cost):
        colors, cost = _phase1(g_, state["colors"], num_parts, C, cost)
        return {"colors": colors, "conf": state["conf"]}, frontier, True, \
            cost

    def fix_enter(g_, state, frontier, epoch):
        return state, torch.ones((g_.n,), dtype=torch.bool,
                                 device=frontier.device)

    def fix_local(g_, state, frontier, step, do_push, cost):
        colors, cost, conf = _fix_conflicts(g_, state["colors"], num_parts,
                                            do_push, cost)
        return {"colors": colors, "conf": conf}, frontier, True, cost

    def epoch_cond(g_, state, epoch):
        return epoch == 0 or bool(state["conf"] > 0)

    pp = PhaseProgram(
        phases=(Phase(program=VertexProgram(local_fn=color_local),
                      max_steps=1, name="color", enter_fn=color_enter),
                Phase(program=VertexProgram(local_fn=fix_local),
                      max_steps=1, name="fix", enter_fn=fix_enter)),
        epoch_cond=epoch_cond)
    return pp, max_iters


def coloring_init(g: Graph, **_):
    state0 = {"colors": torch.zeros((g.n,), dtype=torch.int32,
                                    device=g.device),
              "conf": counter(1, g.device)}
    return state0, torch.ones((g.n,), dtype=torch.bool, device=g.device)


def coloring_finalize(g: Graph, state):
    return {"colors": state["colors"],
            "num_colors": state["colors"].max()}


def boman_coloring(g: Graph, num_parts: int = 16, C: int = 64,
                   direction: str = "push", max_iters: int = 64
                   ) -> ColoringResult:
    """Legacy entry point — a thin wrapper over ``api.solve``."""
    from ... import api
    policy = Fixed(Direction.PUSH if direction == "push"
                   else Direction.PULL)
    r = api.solve(g, "coloring", policy=policy, num_parts=num_parts, C=C,
                  max_iters=max_iters)
    return ColoringResult(colors=r.state["colors"], cost=r.cost,
                          iterations=r.epochs,
                          num_colors=r.state["num_colors"])


def fe_coloring(g: Graph, generator: torch.Generator,
                direction: str = "push", max_iters: int = 256,
                use_gs: bool = False, gs_threshold: float = 0.1
                ) -> ColoringResult:
    """Frontier-Exploit BGC (§5-FE), optional Generic-Switch (§5-GS).

    Round i colors the uncolored neighbors of the frontier with color c_i.
      push mode: all candidates grab c_i; adjacent candidate pairs
                 conflict and the higher id reverts (stays for a later
                 round) — fewer reads, more rounds;
      pull/GS mode: a candidate takes c_i only if it out-prioritizes all
                 uncolored neighbors (Jones–Plassmann style) — conflict-
                 free by construction, used once the uncolored tail drops
                 below ``gs_threshold * n`` when ``use_gs``.

    Vertex priorities are a permutation drawn from ``generator``. As in
    the reference, ``direction`` does not change the schedule.
    """
    prio = torch.randperm(g.n, generator=generator,
                          device=generator.device).to(g.device)
    return _fe_coloring(g, prio.to(torch.int32), max_iters=max_iters,
                        use_gs=use_gs, gs_threshold=gs_threshold)


def _fe_coloring(g: Graph, prio: torch.Tensor, max_iters: int = 256,
                 use_gs: bool = False, gs_threshold: float = 0.1
                 ) -> ColoringResult:
    """:func:`fe_coloring` on the priority permutation ``prio``
    (int32[n])."""
    n, dev = g.n, g.device
    ell = g.ell_idx.long()
    real = g.ell_idx < n
    ids = torch.arange(n, dtype=torch.int32, device=dev)

    def gather(x: torch.Tensor, pad) -> torch.Tensor:
        return torch.cat([x, x.new_full((1,), pad)])[ell]

    # initial stable set: local priority maxima (one Luby step)
    nbr_prio = torch.where(real, gather(prio, -1), -1)
    stable = prio > nbr_prio.amax(dim=1)
    colors = torch.where(stable, 1, 0).to(torch.int32)
    frontier, c_i, it = stable, 2, 0
    cost = Cost.zeros(dev).charge(iterations=1)
    while it < max_iters and bool((colors == 0).any()):
        uncolored = colors == 0
        # candidates: uncolored vertices adjacent to the frontier
        adj_f = gather(frontier, False) & real
        cand = uncolored & adj_f.any(dim=1)
        cand = cand | (uncolored & ~frontier.any())     # restart islands
        nbr_uncol = gather(uncolored, False) & real
        do_pull = use_gs and int(uncolored.to(torch.int32).sum()) < int(
            gs_threshold * n)
        if do_pull:
            # JP: take c_i only when out-prioritizing uncolored neighbors
            wins = prio > torch.where(nbr_uncol, nbr_prio, -1).amax(dim=1)
            take = cand & wins
        else:
            # everyone grabs c_i; the higher-id endpoint of each
            # candidate-candidate edge conflicts and reverts
            nbr_cand = gather(cand, False) & real
            min_cand_nbr = torch.where(nbr_cand, g.ell_idx, n).amin(dim=1)
            take = cand & (min_cand_nbr > ids)
        colors = torch.where(take, c_i, colors)
        frontier = take
        cost = cost.charge(
            reads=torch.where(cand, g.in_deg, 0).to(COUNTER).sum(),
            writes=take.to(COUNTER).sum(), iterations=1, barriers=1)
        if not do_pull:
            cost = cost.charge_combining_writes(
                (cand & ~take).to(COUNTER).sum(), float_data=False)
        c_i += 1
        it += 1
    return ColoringResult(colors=colors, cost=cost, iterations=it + 1,
                          num_colors=colors.max())


def greedy_sequential(g: Graph, colors: torch.Tensor, mask: torch.Tensor,
                      C: int, cost: Cost):
    """One-at-a-time first-fit over ``mask`` vertices in id order (the
    GrS tail / CR border pre-pass). Sequential ⇒ conflict-free.

    Only vertex v's own step writes colors[v], so the vertices a step
    colors are those masked and uncolored on entry: the loop visits them
    alone, and the Cost is the reference's step-by-step sum."""
    todo = mask & (colors == 0)
    colors = colors.clone()
    for v in torch.nonzero(todo).flatten().tolist():
        vid = torch.tensor([v], dtype=torch.int32, device=colors.device)
        colors[v] = _first_fit(_used_mask(g, vid, colors, C))[0]
    return colors, cost.charge(
        reads=torch.where(todo, g.in_deg, 0).to(COUNTER).sum(),
        writes=todo.to(COUNTER).sum())


def conflict_removal_coloring(g: Graph, num_parts: int = 16, C: int = 64
                              ) -> ColoringResult:
    """§5-CR (Algorithm 9): greedily pre-color the border set B, then
    color partition interiors in parallel — zero conflicts, one
    iteration."""
    part = partition_1d(g.n, num_parts)
    cross = part.owner(g.coo_src) != part.owner(g.coo_dst)
    border = segment_max(cross.to(torch.int32), g.coo_dst, g.n) > 0
    colors = torch.zeros((g.n,), dtype=torch.int32, device=g.device)
    colors, cost = greedy_sequential(g, colors, border, C,
                                     Cost.zeros(g.device))
    cost = cost.charge(barriers=1)
    colors, cost = _phase1(g, colors, num_parts, C, cost,
                           only_mask=~border)
    cost = cost.charge(iterations=1)
    return ColoringResult(colors=colors, cost=cost, iterations=1,
                          num_colors=colors.max())
