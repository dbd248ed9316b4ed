"""PushPullEngine — the fixed-point loop over push/pull k-relaxations.
PyTorch port of ``repro.core.engine`` (``run``; the stepwise path and
checkpoints are not ported yet).

A *vertex program* is (msg_fn, combine, update_fn) plus optional hooks:

    msg_fn(src_value, edge_weight) -> message
    combine ∈ {sum, min, max}
    update_fn(old_state, combined_msgs, step) -> (new_state, frontier,
                                                  converged)
    values_fn(g, state, frontier) -> wire values       (default: state)
    touched_fn(g, state, frontier, visited) -> bool[n] pull destinations
    local_fn(g, state, frontier, step, do_push, cost)  (a step that never
        -> (state, frontier, converged, cost)           touches the
                                                        exchange backend)

A :class:`PhaseProgram` runs a sequence of :class:`Phase` s under an
epoch loop (Δ-stepping's buckets, BC's forward/backward pair per source,
Borůvka's find-min/contract rounds, Boman coloring's color/fix rounds).

The JAX package runs the loop under ``lax.while_loop`` and picks the
direction with ``lax.cond``; here the loop runs on the host over device
tensors, reads each step's decision and convergence flag, and runs only
the chosen direction. Counters, step counts and trace rows are the
JAX engine's exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Union

import torch

from ..graphs.structure import Graph
from .backend import DenseBackend, ExchangeBackend
from .cost_model import COUNTER, Cost, StepStats, StepTrace, counter
from .direction import Direction, DirectionPolicy, Fixed, GreedySwitch
from .primitives import frontier_in_edges, frontier_out_edges, k_filter

__all__ = ["VertexProgram", "Phase", "PhaseProgram", "PushPullEngine",
           "EngineResult"]


@dataclasses.dataclass(frozen=True)
class VertexProgram:
    combine: str = "sum"
    msg_fn: Optional[Callable] = None
    update_fn: Callable = None  # type: ignore[assignment]
    values_fn: Optional[Callable] = None
    # what pull inspects: 'all' destinations, or only the 'unvisited' ones
    pull_touched: str = "all"
    touched_fn: Optional[Callable] = None
    # static per-iteration charges, e.g. (("reads", 2 * n),)
    step_charges: tuple = ()
    # charge_fn(g, state, frontier) -> dict of counter increments
    charge_fn: Optional[Callable] = None
    # charge the paper's k-filter after push steps
    k_filter_push: bool = False
    # k_filter_set_fn(old_state, new_state, frontier) -> bool[n]
    k_filter_set_fn: Optional[Callable] = None
    # GreedySwitch terminal hand-off: tail_fn(g, state, frontier, cost)
    tail_fn: Optional[Callable] = None
    # local_fn(g, state, frontier, step, do_push, cost)
    #   -> (state, frontier, converged, cost) replaces relax + update:
    # the step never touches the exchange backend (partition-sequential
    # coloring, Borůvka's find-min over supervertices, blocked triangle
    # edge maps); the decided direction arrives as the python bool
    # ``do_push`` so the step can charge the direction's cost
    local_fn: Optional[Callable] = None


@dataclasses.dataclass(frozen=True)
class Phase:
    """One fixed-point loop inside a program; ``enter_fn(g, state,
    frontier, epoch)`` rewrites the carry before the first step,
    ``exit_fn(g, state, frontier, cost)`` after the loop."""
    program: VertexProgram
    max_steps: int = 100
    name: str = ""
    enter_fn: Optional[Callable] = None
    exit_fn: Optional[Callable] = None


@dataclasses.dataclass(frozen=True)
class PhaseProgram:
    """Phases iterated as epochs while ``epoch_cond(g, state, epoch)``
    holds (None = exactly ``max_epochs``)."""
    phases: tuple
    max_epochs: Optional[int] = None
    epoch_cond: Optional[Callable] = None
    epoch_exit_fn: Optional[Callable] = None


class EngineResult(NamedTuple):
    state: Any
    cost: Cost
    steps: int
    push_steps: int
    converged: bool = True
    epochs: int = 1
    trace: Optional[StepTrace] = None


@dataclasses.dataclass
class _Carry:
    """What flows from phase to phase and epoch to epoch."""
    state: Any
    frontier: torch.Tensor
    cost: Cost
    steps: int
    pushes: int
    trace: StepTrace


@dataclasses.dataclass(frozen=True)
class PushPullEngine:
    program: Union[VertexProgram, PhaseProgram]
    policy: DirectionPolicy = Fixed(Direction.PULL)
    max_steps: int = 100
    backend: ExchangeBackend = DenseBackend()
    # > 0 records every executed step into a StepTrace of that capacity
    trace_capacity: int = 0

    def _step_stats(self, g: Graph, prog: VertexProgram, frontier,
                    unvisited, touched, values, step: int,
                    last_push: bool) -> StepStats:
        """The decision inputs for this step, from degree sums only."""
        pull_edges, pull_vertices = self.backend.predict_pull_scan(
            g, touched, values=values, combine=prog.combine,
            msg_fn=prog.msg_fn)
        pull_touched = (counter(g.m, g.device) if touched is None
                        else frontier_in_edges(g, touched))
        float_data = bool(values is not None
                          and values.dtype.is_floating_point)
        width = (1 if values is None or values.ndim == 1
                 else int(values.shape[-1]))
        push_wb = pull_wb = counter(0, g.device)
        if values is not None:
            push_wb, pull_wb = self.backend.predict_comm_bytes(
                g, values, frontier)
        return StepStats(
            frontier_vertices=frontier.to(COUNTER).sum(),
            frontier_edges=frontier_out_edges(g, frontier),
            pull_edges=pull_edges, pull_vertices=pull_vertices,
            unvisited_edges=frontier_in_edges(g, unvisited),
            step=step, prev_push=last_push, float_data=float_data,
            k_filter_push=prog.k_filter_push, width=width,
            push_wire_bytes=push_wb, pull_wire_bytes=pull_wb,
            pull_touched_edges=pull_touched)

    def _run_phase(self, g: Graph, phase: Phase, c: _Carry,
                   epoch: int) -> bool:
        """Run one phase's loop on carry ``c`` (updated in place);
        returns the phase's converged flag."""
        prog = phase.program
        values_fn = prog.values_fn or (lambda g_, s, f: s)
        greedy = (isinstance(self.policy, GreedySwitch)
                  and prog.tail_fn is not None)
        fixed_dir = (self.policy.direction
                     if isinstance(self.policy, Fixed) else None)
        tracing = self.trace_capacity > 0
        predictor = self.policy.trace_predictor() if tracing else None

        if phase.enter_fn is not None:
            c.state, c.frontier = phase.enter_fn(g, c.state, c.frontier,
                                                 epoch)
        visited = c.frontier
        # an empty entering frontier is already converged
        converged = not bool(c.frontier.any())
        handoff = False
        step, pushes, last_push = 0, 0, False
        while not converged and not handoff and step < phase.max_steps:
            frontier = c.frontier
            unvisited = ~visited
            if prog.local_fn is not None:
                values = touched = None
            else:
                values = values_fn(g, c.state, frontier)
                if prog.touched_fn is not None:
                    touched = prog.touched_fn(g, c.state, frontier, visited)
                elif prog.pull_touched == "unvisited":
                    touched = unvisited
                else:
                    touched = None
            stats = (self._step_stats(g, prog, frontier, unvisited, touched,
                                      values, step, last_push)
                     if (fixed_dir is None or tracing) else None)
            if fixed_dir is not None:
                do_push = fixed_dir == Direction.PUSH
            else:
                do_push = bool(self.policy.decide(g, frontier, stats))
            cost0 = c.cost
            if prog.local_fn is not None:
                state, new_frontier, conv, cost = prog.local_fn(
                    g, c.state, frontier, step, do_push, cost0)
            else:
                msgs, cost = self.backend.relax(
                    g, values, frontier,
                    direction=Direction.PUSH if do_push else Direction.PULL,
                    combine=prog.combine, msg_fn=prog.msg_fn,
                    touched=touched, cost=cost0)
                state, new_frontier, conv = prog.update_fn(c.state, msgs,
                                                           step)
                if prog.k_filter_push and do_push:
                    # push produced a sparse updated set -> k-filter
                    kf_set = (new_frontier if prog.k_filter_set_fn is None
                              else prog.k_filter_set_fn(c.state, state,
                                                        new_frontier))
                    _, cost = k_filter(kf_set, cost)
            cost = cost.charge(iterations=1, barriers=1,
                               **dict(prog.step_charges))
            if prog.charge_fn is not None:
                cost = cost.charge(**prog.charge_fn(g, c.state, frontier))
            if greedy:
                active = new_frontier.to(COUNTER).sum()
                handoff = (not bool(conv)) and bool(
                    self.policy.should_handoff(g, active))
            if tracing:
                c.trace = c.trace.record(
                    c.steps + step, do_push, stats, cost - cost0,
                    predicted_push=predictor.predict_push(stats),
                    predicted_pull=predictor.predict_pull(stats))
            c.state, c.frontier, c.cost = state, new_frontier, cost
            visited = visited | new_frontier
            converged = bool(conv)
            step += 1
            pushes += int(do_push)
            last_push = do_push
        if greedy and handoff:
            c.state, c.cost = prog.tail_fn(g, c.state, c.frontier, c.cost)
            converged = True
        if phase.exit_fn is not None:
            c.state, c.frontier, c.cost = phase.exit_fn(g, c.state,
                                                        c.frontier, c.cost)
        c.steps += step
        c.pushes += pushes
        return converged

    def run(self, g: Graph, init_state: Any,
            init_frontier: torch.Tensor) -> EngineResult:
        if isinstance(self.program, PhaseProgram):
            pp = self.program
            phases = tuple(pp.phases)
            max_epochs = (self.max_steps if pp.max_epochs is None
                          else pp.max_epochs)
            epoch_cond, epoch_exit = pp.epoch_cond, pp.epoch_exit_fn
        else:
            phases = (Phase(program=self.program,
                            max_steps=self.max_steps),)
            max_epochs, epoch_cond, epoch_exit = 1, None, None

        c = _Carry(state=init_state, frontier=init_frontier,
                   cost=Cost.zeros(g.device), steps=0, pushes=0,
                   trace=StepTrace.empty(self.trace_capacity, g.device))

        def run_epoch(epoch: int) -> bool:
            conv = True
            for ph in phases:
                conv = self._run_phase(g, ph, c, epoch)
            if epoch_exit is not None:
                c.state, c.frontier = epoch_exit(g, c.state, c.frontier,
                                                 epoch)
            return conv

        if max_epochs == 1 and epoch_cond is None:
            converged, epochs = run_epoch(0), 1
        else:
            epochs, conv = 0, True
            while epochs < max_epochs and (
                    epoch_cond is None
                    or bool(epoch_cond(g, c.state, epochs))):
                conv = run_epoch(epochs)
                epochs += 1
            # converged iff the work test (not the epoch bound) ended it
            converged = (not bool(epoch_cond(g, c.state, epochs))
                         if epoch_cond is not None else conv)
        return EngineResult(
            state=c.state, cost=c.cost, steps=c.steps, push_steps=c.pushes,
            converged=converged, epochs=epochs,
            trace=c.trace if self.trace_capacity > 0 else None)
