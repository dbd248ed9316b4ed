"""Borůvka MST — paper §3.7 / §4.7 / Algorithm 7. PyTorch port of
``repro.core.algorithms.mst_boruvka``.

Each round: (FM) every supervertex finds its minimum-weight outgoing edge;
(BMT/M) incident supervertices hook along those edges and contract by
pointer jumping. Rounds at least halve the component count: O(log n).

push (FM): every edge offers its key to both incident supervertices'
      shared minimum slots — combining-min writes;
pull (FM): each supervertex privately min-reduces over its own incident
      edges — reads only.

A round is a two-:class:`~repro_torch.core.engine.Phase` epoch: a
*find-min* ``local_fn`` (the reduce is keyed by the supervertex, so it
bypasses the exchange backend) and a *contract* ``local_fn`` (pointer
jumping + relabel).

Determinism: edge keys pack (weight bits, undirected-pair rank) into one
int64, so comparison is orientation-invariant; hooking creates only
mutual 2-cycles (broken toward the lower root) and pointer jumping always
terminates. Both directions return the same MST.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ...graphs.structure import Graph
from ...sparse.segment import segment_max, segment_min
from ..backend import DenseBackend, EllBackend, require_backend
from ..cost_model import COUNTER, Cost, counter
from ..direction import Direction, Fixed
from ..engine import Phase, PhaseProgram, VertexProgram

__all__ = ["boruvka_mst", "MSTResult", "mst_program", "mst_init",
           "mst_finalize"]

_BIG = torch.iinfo(torch.int64).max


class MSTResult(NamedTuple):
    in_mst: torch.Tensor      # bool[m] over pull-major edge slots
    weight: torch.Tensor      # float32 total MST weight
    components: torch.Tensor  # int64 final component count (1 if connected)
    cost: Cost
    rounds: int


def mst_program(g: Graph, policy=None, backend=None
                ) -> tuple[PhaseProgram, int]:
    """Borůvka as find-min + contract phases per engine epoch."""
    require_backend("mst_boruvka", backend, DenseBackend, EllBackend)
    n, m = g.n, g.m

    def fm_enter(g_, state, frontier, epoch):
        return state, torch.ones((n,), dtype=torch.bool,
                                 device=frontier.device)

    def fm_local(g_, state, frontier, step, do_push, cost):
        comp = state["comp"]
        dev = comp.device
        src, dst = g_.coo_src.long(), g_.coo_dst.long()
        eid = torch.arange(m, dtype=torch.int64, device=dev)
        cs = comp[src]
        cd = comp[dst]
        external = cs != cd
        key = torch.where(external, state["pairkey"], _BIG)

        # FM: orientation-invariant min key per supervertex; push and
        # pull reduce the same value, only the Cost differs
        min_key = segment_min(key, cs, n)
        k_ext = external.to(COUNTER).sum()
        if do_push:
            cost = cost.charge(reads=counter(m, dev)
                               ).charge_combining_writes(k_ext,
                                                         float_data=False)
        else:
            cost = cost.charge(reads=counter(m, dev), writes=counter(n, dev))
        has_edge = min_key < _BIG

        # representative slot (the src-side orientation exists because
        # the edge list is symmetric): min slot among winners
        winner = key == min_key[cs.long()]
        sel_slot = segment_min(torch.where(winner, eid, _BIG), cs, n)
        sel_slot_c = torch.where(has_edge, sel_slot, 0)
        # only the selected slots are set: an edgeless supervertex points
        # past the end (slot m), which is dropped
        hit = torch.zeros((m + 1,), dtype=torch.bool, device=dev)
        hit[torch.where(has_edge, sel_slot, m)] = True
        hit = hit[:m]

        # BMT: hook to the other side's component; mutual 2-cycles break
        # toward the lower root
        other = comp[dst[sel_slot_c]]
        me = torch.arange(n, dtype=torch.int32, device=dev)
        parent = torch.where(has_edge, other, me)
        pp = parent[parent.long()]
        parent = torch.where((pp == me) & (me < parent), me, parent)

        state = dict(state, in_mst=state["in_mst"] | hit, parent=parent,
                     done=~has_edge.any())
        # supervertices that found an edge are the live frontier
        return state, has_edge, True, cost

    def contract_local(g_, state, frontier, step, do_push, cost):
        # pointer jumping: depth halves per step -> ceil(log2 n)+1 bounds
        # convergence, a fixed count so malformed hooks can never hang
        n_jumps = max(1, math.ceil(math.log2(max(2, n))) + 1)
        parent = state["parent"]
        for _ in range(n_jumps):
            parent = parent[parent.long()]
        comp = parent[state["comp"].long()]
        cost = cost.charge(writes=counter(n, parent.device))
        return dict(state, comp=comp, parent=parent), frontier, True, cost

    def epoch_cond(g_, state, epoch):
        return ~state["done"]

    pp = PhaseProgram(
        phases=(Phase(program=VertexProgram(local_fn=fm_local),
                      max_steps=1, name="find_min", enter_fn=fm_enter),
                # contract inherits the find-min frontier: a done round
                # leaves it empty and the contraction is skipped
                Phase(program=VertexProgram(local_fn=contract_local),
                      max_steps=1, name="contract")),
        epoch_cond=epoch_cond)
    return pp, 64


def mst_init(g: Graph, **_):
    n, m, dev = g.n, g.m, g.device
    src = g.coo_src.to(torch.int64)
    dst = g.coo_dst.to(torch.int64)
    # orientation-invariant undirected pair rank in [0, m)
    pair = torch.minimum(src, dst) * (n + 1) + torch.maximum(src, dst)
    _, pair_rank = torch.unique(pair, sorted=True, return_inverse=True)
    # weights are positive floats: the int32 bit pattern preserves order
    wbits = g.coo_w.contiguous().view(torch.int32).to(torch.int64)
    pairkey = wbits * (m + 1) + pair_rank
    state0 = {
        "comp": torch.arange(n, dtype=torch.int32, device=dev),
        "parent": torch.arange(n, dtype=torch.int32, device=dev),
        "in_mst": torch.zeros((m,), dtype=torch.bool, device=dev),
        "done": torch.zeros((), dtype=torch.bool, device=dev),
        "pair": pair,
        "pairkey": pairkey,
    }
    return state0, torch.ones((n,), dtype=torch.bool, device=dev)


def mst_finalize(g: Graph, state):
    n, m = g.n, g.m
    pair, in_mst, comp = state["pair"], state["in_mst"], state["comp"]
    # total weight with undirected dedup (both orientations may be marked)
    order = torch.argsort(pair, stable=True)
    pair_s = pair[order]
    sel_s = in_mst[order]
    w_s = g.coo_w[order]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=pair.device),
                       pair_s[1:] != pair_s[:-1]])
    grp = torch.cumsum(first.to(torch.int32), 0) - 1
    any_sel = segment_max(sel_s.to(torch.int32), grp, m) > 0
    pair_w = segment_max(w_s, grp, m)
    weight = torch.where(any_sel, pair_w, 0.0).sum()

    roots = segment_max(torch.ones((n,), dtype=torch.int32,
                                   device=comp.device), comp, n) > 0
    return {"in_mst": in_mst, "weight": weight,
            "components": roots.to(torch.int32).sum()}


def boruvka_mst(g: Graph, direction: str = "pull", max_rounds: int = 64
                ) -> MSTResult:
    """Legacy entry point — a thin wrapper over ``api.solve``."""
    from ... import api
    policy = Fixed(Direction.PUSH if direction == "push"
                   else Direction.PULL)
    r = api.solve(g, "mst_boruvka", policy=policy, max_steps=max_rounds)
    return MSTResult(in_mst=r.state["in_mst"], weight=r.state["weight"],
                     components=r.state["components"], cost=r.cost,
                     rounds=r.epochs)
