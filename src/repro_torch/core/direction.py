"""Direction selection: push / pull / auto (paper §3.8, §5 GS/GrS).
PyTorch port of ``repro.core.direction``.

  * ``Fixed``         — always push or always pull.
  * ``GenericSwitch`` — Beamer's direction-optimizing rule (paper §5-GS).
  * ``GreedySwitch``  — GS plus a terminal greedy hand-off (§5-GrS).
  * ``AutoSwitch``    — cost-model-driven: prices a push and a pull step
    with :class:`~repro_torch.core.cost_model.CostPredictor` and takes
    the cheaper, with hysteresis.

Policies return a 0-d bool tensor (True = push); the engine's host loop
reads it to run only the chosen direction. All arithmetic on counters is
float64, as in the JAX package under x64.
"""

from __future__ import annotations

import dataclasses
import enum

import torch

from ..graphs.structure import Graph
from .cost_model import PRED, CostPredictor, StepStats
from .primitives import frontier_out_edges

__all__ = ["Direction", "Fixed", "GenericSwitch", "GreedySwitch",
           "AutoSwitch", "DirectionPolicy"]


class Direction(enum.Enum):
    PUSH = "push"
    PULL = "pull"
    AUTO = "auto"


@dataclasses.dataclass(frozen=True)
class DirectionPolicy:
    """Per-step direction chooser — the strategy axis of ``api.solve``."""

    def decide_push(self, g: Graph, frontier: torch.Tensor,
                    unvisited_edges: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def decide(self, g: Graph, frontier: torch.Tensor,
               stats: StepStats) -> torch.Tensor:
        return self.decide_push(g, frontier, stats.unvisited_edges)

    def trace_predictor(self) -> CostPredictor:
        """The cost model whose prices land in StepTrace slots."""
        return CostPredictor()

    @property
    def name(self) -> str:
        return type(self).__name__


@dataclasses.dataclass(frozen=True)
class Fixed(DirectionPolicy):
    """Always run one direction — the paper's baseline columns."""
    direction: Direction = Direction.PUSH

    def __post_init__(self):
        if self.direction == Direction.AUTO:
            raise ValueError(
                "Fixed(Direction.AUTO) is not a policy: Fixed always runs "
                "one direction. Use AutoSwitch() (or GenericSwitch() / "
                "GreedySwitch()) for automatic direction optimization.")

    def decide_push(self, g, frontier, unvisited_edges):
        return torch.tensor(self.direction == Direction.PUSH)

    @property
    def name(self) -> str:
        return self.direction.value


@dataclasses.dataclass(frozen=True)
class GenericSwitch(DirectionPolicy):
    """Beamer-style direction optimization (paper §5-GS).

    push iff  m_frontier · alpha < unvisited_edges   (growing phase)
          or  m_frontier · beta  < m                 (shrinking tail).
    """
    alpha: float = 14.0
    beta: float = 24.0

    def decide_push(self, g, frontier, unvisited_edges):
        mf = frontier_out_edges(g, frontier).to(PRED)
        grow_push = mf * self.alpha < unvisited_edges.to(PRED)
        tail_push = mf * self.beta < g.m
        return grow_push | tail_push


@dataclasses.dataclass(frozen=True)
class GreedySwitch(DirectionPolicy):
    """GS + terminal greedy hand-off once the active set is tiny
    (paper §5-GrS); without a program ``tail_fn`` it is GS."""
    inner: GenericSwitch = dataclasses.field(default_factory=GenericSwitch)
    tail_frac: float = 0.001

    def decide_push(self, g, frontier, unvisited_edges):
        return self.inner.decide_push(g, frontier, unvisited_edges)

    def should_handoff(self, g: Graph, active_count) -> torch.Tensor:
        return active_count < max(1, int(self.tail_frac * g.n))


@dataclasses.dataclass(frozen=True)
class AutoSwitch(DirectionPolicy):
    """Cost-model-driven direction optimization: the cheaper predicted
    direction wins; ``hysteresis`` > 1 keeps the current direction
    unless the other is cheaper by that factor (not on the first step)."""
    predictor: CostPredictor = CostPredictor()
    hysteresis: float = 1.1

    def predict(self, stats: StepStats):
        return (self.predictor.predict_push(stats),
                self.predictor.predict_pull(stats))

    def trace_predictor(self) -> CostPredictor:
        return self.predictor

    def decide(self, g, frontier, stats: StepStats):
        pp, pl = self.predict(stats)
        pp, pl = pp.to(PRED), pl.to(PRED)
        h = 1.0 if stats.step == 0 else self.hysteresis
        if stats.prev_push:
            return pp < pl * h
        return pp * h < pl

    def decide_push(self, g, frontier, unvisited_edges):
        # legacy surface: price pull as the unvisited scan, no incumbent
        mf = frontier_out_edges(g, frontier)
        stats = StepStats(
            frontier_vertices=frontier.sum(), frontier_edges=mf,
            pull_edges=unvisited_edges, pull_vertices=(~frontier).sum(),
            unvisited_edges=unvisited_edges, step=0, prev_push=False)
        return self.decide(g, frontier, stats)
