"""Acceleration strategies (paper §5) — index + shared helpers. PyTorch
port of ``repro.core.strategies``.

Implementations live with their algorithms; this module is the map:

  PA  Partition-Awareness   -> graphs.partition.pa_split (the split) +
                               algorithms.pagerank.pagerank_pa (Alg. 8)
  FE  Frontier-Exploit      -> algorithms.coloring.fe_coloring
  GS  Generic-Switch        -> direction.GenericSwitch (BFS/engine) +
                               fe_coloring(use_gs=True)
  GrS Greedy-Switch         -> direction.GreedySwitch + greedy_tail below
  CR  Conflict-Removal      -> algorithms.coloring.conflict_removal_coloring
"""

from __future__ import annotations

from ..graphs.structure import Graph
from .algorithms.coloring import greedy_sequential
from .cost_model import Cost

__all__ = ["greedy_tail_coloring"]


def greedy_tail_coloring(g: Graph, colors, C: int, cost: Cost):
    """GrS terminal hand-off for coloring: finish all still-uncolored
    vertices with the sequential greedy scheme (conflict-free)."""
    colors, cost = greedy_sequential(g, colors, colors == 0, C, cost)
    return colors, cost.charge(iterations=1)
