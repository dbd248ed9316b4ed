"""PRAM cost counters and the per-step cost predictor (paper §4, Table 1;
§5 switching strategies). PyTorch port of ``repro.core.cost_model``.

Counters are explicit ``torch.int64`` 0-d tensors and predictions
explicit ``torch.float64``: the JAX package gets both from its global
x64 switch, and PyTorch's promotion would otherwise compute
``int64_tensor * 14.0`` in float32.

  * :class:`Cost` — the accumulated counters (what actually happened).
  * :class:`CostPredictor` — predicted weighted cost of a push vs a pull
    step from :class:`StepStats`, before the step runs.
  * :class:`StepTrace` — a fixed-capacity per-step record of what each
    step did (direction, frontier stats, counter deltas).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

__all__ = ["Cost", "zero_cost", "counter", "CostWeights", "DEFAULT_WEIGHTS",
           "CostPredictor", "StepStats", "StepTrace"]

COUNTER = torch.int64
PRED = torch.float64


def counter(x, device=None) -> torch.Tensor:
    """``x`` as an int64 counter tensor (on ``device`` when ``x`` is a
    python number; a tensor keeps its own device)."""
    if isinstance(x, torch.Tensor):
        return x.to(COUNTER)
    return torch.tensor(int(x), dtype=COUNTER, device=device)


def _zero():
    return torch.zeros((), dtype=COUNTER)


@dataclasses.dataclass(frozen=True)
class Cost:
    """Operation counts, paper §2.4 categories.

    reads / writes: plain memory accesses to shared vertex state.
    atomics: combining writes to integer data.
    locks: combining writes to float data.
    messages / collective_bytes: DM-setting traffic.
    barriers: bulk-synchronous phase boundaries.
    iterations: outer-loop rounds.
    """
    reads: torch.Tensor = dataclasses.field(default_factory=_zero)
    writes: torch.Tensor = dataclasses.field(default_factory=_zero)
    atomics: torch.Tensor = dataclasses.field(default_factory=_zero)
    locks: torch.Tensor = dataclasses.field(default_factory=_zero)
    messages: torch.Tensor = dataclasses.field(default_factory=_zero)
    collective_bytes: torch.Tensor = dataclasses.field(default_factory=_zero)
    barriers: torch.Tensor = dataclasses.field(default_factory=_zero)
    iterations: torch.Tensor = dataclasses.field(default_factory=_zero)

    @classmethod
    def zeros(cls, device=None) -> "Cost":
        return cls(**{f.name: torch.zeros((), dtype=COUNTER, device=device)
                      for f in dataclasses.fields(cls)})

    def _fields(self) -> dict:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}

    def __add__(self, other: "Cost") -> "Cost":
        return Cost(**{k: v + getattr(other, k)
                       for k, v in self._fields().items()})

    def __sub__(self, other: "Cost") -> "Cost":
        return Cost(**{k: v - getattr(other, k)
                       for k, v in self._fields().items()})

    def charge(self, **kw) -> "Cost":
        """Return a new Cost with the given fields incremented."""
        vals = self._fields()
        for k, v in kw.items():
            vals[k] = vals[k] + counter(v, vals[k].device)
        return Cost(**vals)

    def charge_combining_writes(self, count, float_data: bool) -> "Cost":
        """Push-side conflict resolution: ints -> atomics, floats -> locks
        (paper §4.1)."""
        if float_data:
            return self.charge(locks=count, writes=count)
        return self.charge(atomics=count, writes=count)

    def as_dict(self) -> dict:
        return {k: int(v) for k, v in self._fields().items()}

    def weighted_total(self, weights: "CostWeights" = None) -> torch.Tensor:
        """Collapse the §4 memory counters to one float64 scalar."""
        w = DEFAULT_WEIGHTS if weights is None else weights
        f = lambda t: t.to(PRED)  # noqa: E731
        return (f(self.reads) * w.read + f(self.writes) * w.write
                + f(self.atomics) * w.atomic + f(self.locks) * w.lock
                + f(self.collective_bytes) * w.collective_byte)


def zero_cost() -> Cost:
    return Cost()


@dataclasses.dataclass(frozen=True)
class CostWeights:
    """Relative price of the paper's §4 access categories (a plain
    read/write is the unit)."""
    read: float = 1.0
    write: float = 1.0
    atomic: float = 2.0
    lock: float = 4.0
    collective_byte: float = 0.5


DEFAULT_WEIGHTS = CostWeights()


class StepStats(NamedTuple):
    """Cheap pre-step statistics for switching policies (int64 0-d
    tensors unless noted). ``float_data``, ``k_filter_push`` and
    ``width`` are python facts about the step; ``step`` and
    ``prev_push`` are python values of the host loop."""
    frontier_vertices: torch.Tensor
    frontier_edges: torch.Tensor
    pull_edges: torch.Tensor
    pull_vertices: torch.Tensor
    unvisited_edges: torch.Tensor
    step: int
    prev_push: bool
    float_data: bool = False
    k_filter_push: bool = False
    width: int = 1
    push_wire_bytes: torch.Tensor | int = 0
    pull_wire_bytes: torch.Tensor | int = 0
    pull_touched_edges: torch.Tensor | int = 0


def _f64(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(PRED)
    return torch.tensor(float(x), dtype=PRED)


@dataclasses.dataclass(frozen=True)
class CostPredictor:
    """Forward model of one k-relaxation step, in float64:

      push: k·width·(read + write + combining) over the frontier's k
            out-edges, plus the k-filter when the program declares one;
      pull: (pull_edges·read + pull_vertices·write)·width.

    Both add the predicted inter-device bytes (0 on one device). The
    engine charges the same formulas after the step, so the prediction
    is exact for exchange steps.
    """
    weights: CostWeights = DEFAULT_WEIGHTS

    def predict_push(self, stats: StepStats) -> torch.Tensor:
        w = self.weights
        combining = w.lock if stats.float_data else w.atomic
        k = _f64(stats.frontier_edges * stats.width)
        cost = k * (w.read + w.write + combining)
        if stats.k_filter_push:
            cost = cost + _f64(stats.frontier_vertices) * (w.read + w.write)
        return cost + _f64(stats.push_wire_bytes).to(cost.device) \
            * w.collective_byte

    def predict_pull(self, stats: StepStats) -> torch.Tensor:
        w = self.weights
        scan = (_f64(stats.pull_edges) * w.read
                + _f64(stats.pull_vertices) * w.write) * stats.width
        return scan + _f64(stats.pull_wire_bytes).to(scan.device) \
            * w.collective_byte


_TRACE_COLUMNS = (
    ("pushed", torch.bool), ("frontier_vertices", COUNTER),
    ("frontier_edges", COUNTER), ("pull_touched_edges", COUNTER),
    ("reads", COUNTER), ("writes", COUNTER), ("atomics", COUNTER),
    ("locks", COUNTER), ("predicted_push", PRED), ("predicted_pull", PRED),
    ("push_wire_bytes", COUNTER), ("pull_wire_bytes", COUNTER))


@dataclasses.dataclass(frozen=True)
class StepTrace:
    """Fixed-capacity per-step record of what the engine actually did.

    One slot per executed step (across all phases and epochs, in order):
    the chosen direction, the frontier statistics the decision saw, the
    predicted push/pull prices, the predicted wire bytes and the step's
    delta of the four §4 memory counters. Steps beyond capacity are
    counted in ``overflow`` instead of written.
    """
    pushed: torch.Tensor
    frontier_vertices: torch.Tensor
    frontier_edges: torch.Tensor
    pull_touched_edges: torch.Tensor
    reads: torch.Tensor
    writes: torch.Tensor
    atomics: torch.Tensor
    locks: torch.Tensor
    predicted_push: torch.Tensor
    predicted_pull: torch.Tensor
    push_wire_bytes: torch.Tensor
    pull_wire_bytes: torch.Tensor
    overflow: torch.Tensor

    @classmethod
    def empty(cls, capacity: int, device=None) -> "StepTrace":
        cols = {name: torch.zeros((capacity,), dtype=dt, device=device)
                for name, dt in _TRACE_COLUMNS}
        return cls(**cols, overflow=torch.zeros((), dtype=COUNTER,
                                                device=device))

    @property
    def capacity(self) -> int:
        return self.pushed.shape[0]

    def record(self, idx: int, pushed: bool, stats: StepStats, delta: Cost,
               predicted_push=0.0, predicted_pull=0.0) -> "StepTrace":
        """This trace with step ``idx`` written (past capacity: one more
        ``overflow`` instead). Columns are updated in place: the trace is
        owned by the one engine run that records into it."""
        if idx >= self.capacity:
            return dataclasses.replace(self, overflow=self.overflow + 1)
        vals = dict(
            pushed=pushed, frontier_vertices=stats.frontier_vertices,
            frontier_edges=stats.frontier_edges,
            pull_touched_edges=stats.pull_touched_edges,
            reads=delta.reads, writes=delta.writes,
            atomics=delta.atomics, locks=delta.locks,
            predicted_push=predicted_push, predicted_pull=predicted_pull,
            push_wire_bytes=stats.push_wire_bytes,
            pull_wire_bytes=stats.pull_wire_bytes)
        for name, v in vals.items():
            col = getattr(self, name)
            col[idx] = torch.as_tensor(v, dtype=col.dtype).to(col.device)
        return self

    def as_dict(self, steps: int = None) -> dict:
        """Python-native view, trimmed to the first ``steps`` slots."""
        k = self.capacity if steps is None else min(steps, self.capacity)
        out = {}
        for name, dt in _TRACE_COLUMNS:
            col = getattr(self, name)[:k].cpu().tolist()
            if dt == torch.bool:
                out[name] = [bool(x) for x in col]
            elif dt == PRED:
                out[name] = [float(x) for x in col]
            else:
                out[name] = [int(x) for x in col]
        out["overflow"] = int(self.overflow)
        return out
