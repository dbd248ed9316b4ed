"""PushPullEngine — the fixed-point loop over push/pull k-relaxations.
PyTorch port of ``repro.core.engine``: ``run``, and ``run_stepwise``
with its per-step wall times, finite check and checkpoints.

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
    pull_update: a spec, e.g. ``("ppr", damp, tol)``, that lets a
        backend run a full-scan pull and ``update_fn`` as one step
        (``ExchangeBackend.pull_update``)

A :class:`PhaseProgram` runs a sequence of :class:`Phase` s under an
epoch loop (Δ-stepping's buckets, BC's forward/backward pair per source,
Borůvka's find-min/contract rounds, Boman coloring's color/fix rounds).

The JAX package runs the loop under ``lax.while_loop`` and picks the
direction with ``lax.cond``; here the loop runs on the host over device
tensors, reads each step's decision and convergence flag, and runs only
the chosen direction. Counters, step counts and trace rows are the
JAX engine's exactly. One function takes a step on an explicit loop
carry (:class:`_Loop`), and one loop drives it for both ``run`` and
``run_stepwise``, so the two are bit-identical by construction: the
stepwise path only adds the ``engine.step`` fault site, a timer, the
finite check and checkpoints around the same calls.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, NamedTuple, Optional, Union

import torch

from ..graphs.structure import Graph
from ..models.common import tree_leaves
from ..obs.trace import region
from ..resilience import DivergenceError, SolveInterrupted, fault_point
from .backend import DenseBackend, ExchangeBackend
from .cost_model import (COUNTER, Cost, CostPredictor, StepStats, StepTrace,
                         counter)
from .direction import Direction, DirectionPolicy, Fixed, GreedySwitch
from .primitives import frontier_in_edges, frontier_out_edges, k_filter

__all__ = ["VertexProgram", "Phase", "PhaseProgram", "PushPullEngine",
           "EngineResult", "Checkpoint"]


class Checkpoint(NamedTuple):
    """A stepwise solve's resumable snapshot: the loop carry (the
    backend's exchange state included) after ``step`` completed steps. The carry is a copy (every tensor cloned),
    since later steps write the trace and may write state in place;
    resuming copies it again and re-enters the same step function, so a
    resumed run is bit-identical to an uninterrupted one."""
    step: int
    carry: Any


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
    # a frozen spec of update_fn (("ppr", damp, tol)) that a backend may
    # fuse into a full-scan pull: ExchangeBackend.pull_update
    pull_update: Optional[tuple] = None


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
    # the backend's final exchange-carried state (the sharded push's
    # error-feedback accumulator); () for stateless backends
    xstate: Any = ()


@dataclasses.dataclass
class _Carry:
    """What flows from phase to phase and epoch to epoch."""
    state: Any
    frontier: torch.Tensor
    cost: Cost
    steps: int
    pushes: int
    trace: StepTrace
    xstate: Any = ()


@dataclasses.dataclass(frozen=True)
class _Loop:
    """One phase's loop carry: everything a step reads and writes."""
    state: Any
    frontier: torch.Tensor
    visited: torch.Tensor
    converged: bool
    handoff: bool
    step: int
    cost: Cost
    pushes: int
    last_push: bool
    trace: StepTrace
    # the backend's exchange-carried state; () for stateless backends
    xstate: Any = ()


@dataclasses.dataclass(frozen=True)
class _PhaseRun:
    """What stays fixed while one phase loops."""
    phase: Phase
    steps0: int                # steps before this phase: the trace cursor
    greedy: bool               # GreedySwitch with a tail hand-off
    fixed_dir: Optional[Direction]
    predictor: Optional[CostPredictor]

    def going(self, st: _Loop) -> bool:
        return (not st.converged and not st.handoff
                and st.step < self.phase.max_steps)


def _clone(tree):
    """A copy of ``tree`` with every tensor cloned: tensors, dicts,
    lists, tuples, named tuples and dataclasses (``_Loop``, ``Cost``,
    ``StepTrace``); anything else is shared."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*map(_clone, tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map(_clone, tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _clone(getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    return tree


class _Watch:
    """``run_stepwise``'s guards around each step: its wall time (the
    host clock around the step, which ends with a synchronize on the
    card, else it would time the launches), the finite check, the
    checkpoints and ``on_step``. ``i`` counts completed steps, ``last``
    is the newest checkpoint."""

    def __init__(self, device: torch.device, on_step, check_finite,
                 checkpoint_every: int, resume_from):
        self.device = device
        self.on_step = on_step
        self.check_finite = check_finite
        self.every = checkpoint_every
        self.last = resume_from
        self.i = 0 if resume_from is None else resume_from.step

    def step(self, take: Callable[[], _Loop]) -> _Loop:
        t0 = time.perf_counter()
        st = take()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        us = (time.perf_counter() - t0) * 1e6
        self.i += 1
        if self.check_finite:
            PushPullEngine._check_finite(st.state, self.check_finite,
                                         self.i - 1)
        if self.every and self.i % self.every == 0:
            self.last = Checkpoint(step=self.i, carry=_clone(st))
        if self.on_step is not None:
            self.on_step(self.i - 1, us)
        return st


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

    # -- one phase: enter, step, loop, finish ----------------------------
    def _enter(self, g: Graph, phase: Phase, c: _Carry,
               epoch: int) -> tuple[_PhaseRun, _Loop]:
        """Rewrite the carry with ``enter_fn`` and build the phase's
        first loop carry."""
        if phase.enter_fn is not None:
            c.state, c.frontier = phase.enter_fn(g, c.state, c.frontier,
                                                 epoch)
        ph = _PhaseRun(
            phase=phase, steps0=c.steps,
            greedy=(isinstance(self.policy, GreedySwitch)
                    and phase.program.tail_fn is not None),
            fixed_dir=(self.policy.direction
                       if isinstance(self.policy, Fixed) else None),
            predictor=(self.policy.trace_predictor()
                       if self.trace_capacity > 0 else None))
        # an empty entering frontier is already converged
        st = _Loop(state=c.state, frontier=c.frontier, visited=c.frontier,
                   converged=not bool(c.frontier.any()), handoff=False,
                   step=0, cost=c.cost, pushes=0, last_push=False,
                   trace=c.trace, xstate=c.xstate)
        return ph, st

    def _step(self, g: Graph, ph: _PhaseRun, st: _Loop) -> _Loop:
        """One step of the phase on carry ``st``: the next carry. Writes
        the step's trace row into ``st.trace`` in place."""
        prog = ph.phase.program
        frontier, step = st.frontier, st.step
        unvisited = ~st.visited
        values_fn = prog.values_fn or (lambda g_, s, f: s)
        tracing = ph.predictor is not None
        if prog.local_fn is not None:
            values = touched = None
        else:
            # a step the backend may fuse (``pull_update``) asks for the
            # payload itself, maybe of some columns only; the payload is
            # computed here where the step's statistics read it
            values = (values_fn(g, st.state, frontier)
                      if prog.pull_update is None or ph.fixed_dir is None
                      or tracing else None)
            if prog.touched_fn is not None:
                touched = prog.touched_fn(g, st.state, frontier, st.visited)
            elif prog.pull_touched == "unvisited":
                touched = unvisited
            else:
                touched = None
        stats = (self._step_stats(g, prog, frontier, unvisited, touched,
                                  values, step, st.last_push)
                 if (ph.fixed_dir is None or tracing) else None)
        if ph.fixed_dir is not None:
            do_push = ph.fixed_dir == Direction.PUSH
        else:
            do_push = bool(self.policy.decide(g, frontier, stats))
        cost0 = st.cost
        xstate = st.xstate
        fused = None
        if not do_push and touched is None and prog.pull_update is not None:
            def values_of(state):
                if state is st.state and values is not None:
                    return values
                return values_fn(g, state, frontier)
            # a state made by this loop's earlier steps is the loop's own
            fused = self.backend.pull_update(g, values_of, st.state,
                                             prog.pull_update, cost0,
                                             private=step > 0)
        if values is None and prog.local_fn is None and fused is None:
            values = values_fn(g, st.state, frontier)
        if prog.local_fn is not None:
            state, new_frontier, conv, cost = prog.local_fn(
                g, st.state, frontier, step, do_push, cost0)
        elif fused is not None:
            state, new_frontier, conv, cost = fused
        else:
            msgs, cost, xstate = self.backend.relax_ex(
                g, values, frontier,
                direction=Direction.PUSH if do_push else Direction.PULL,
                combine=prog.combine, msg_fn=prog.msg_fn, touched=touched,
                cost=cost0, xstate=xstate)
            state, new_frontier, conv = prog.update_fn(st.state, msgs, step)
            if prog.k_filter_push and do_push:
                # push produced a sparse updated set -> k-filter
                kf_set = (new_frontier if prog.k_filter_set_fn is None
                          else prog.k_filter_set_fn(st.state, state,
                                                    new_frontier))
                _, cost = k_filter(kf_set, cost)
        cost = cost.charge(iterations=1, barriers=1,
                           **dict(prog.step_charges))
        if prog.charge_fn is not None:
            cost = cost.charge(**prog.charge_fn(g, st.state, frontier))
        handoff = st.handoff
        if ph.greedy:
            active = new_frontier.to(COUNTER).sum()
            handoff = (not bool(conv)) and bool(
                self.policy.should_handoff(g, active))
        trace = st.trace
        if tracing:
            trace = trace.record(
                ph.steps0 + step, do_push, stats, cost - cost0,
                predicted_push=ph.predictor.predict_push(stats),
                predicted_pull=ph.predictor.predict_pull(stats))
        return _Loop(state=state, frontier=new_frontier,
                     visited=st.visited | new_frontier,
                     converged=bool(conv), handoff=handoff, step=step + 1,
                     cost=cost, pushes=st.pushes + int(do_push),
                     last_push=do_push, trace=trace, xstate=xstate)

    def _loop(self, g: Graph, ph: _PhaseRun, st: _Loop,
              watch: Optional[_Watch] = None) -> _Loop:
        """The phase loop of both ``run`` and ``run_stepwise``. With a
        watch, the ``engine.step`` fault site comes before each test of
        the loop condition (the final one included, as in the JAX
        package's host loop) and the watch's guards around each step."""
        while True:
            if watch is not None:
                fault_point("engine.step")
            if not ph.going(st):
                return st
            with region("engine.step"):
                st = (self._step(g, ph, st) if watch is None
                      else watch.step(lambda: self._step(g, ph, st)))

    def _finish(self, g: Graph, ph: _PhaseRun, st: _Loop,
                c: _Carry) -> bool:
        """Greedy tail hand-off and ``exit_fn``; folds the phase into
        ``c`` and returns the phase's converged flag."""
        prog = ph.phase.program
        c.state, c.frontier, c.cost, c.trace, c.xstate = (
            st.state, st.frontier, st.cost, st.trace, st.xstate)
        converged = st.converged
        if ph.greedy and st.handoff:
            c.state, c.cost = prog.tail_fn(g, c.state, c.frontier, c.cost)
            converged = True
        if ph.phase.exit_fn is not None:
            c.state, c.frontier, c.cost = ph.phase.exit_fn(
                g, c.state, c.frontier, c.cost)
        c.steps += st.step
        c.pushes += st.pushes
        return converged

    def _carry(self, g: Graph, init_state, init_frontier) -> _Carry:
        return _Carry(state=init_state, frontier=init_frontier,
                      cost=Cost.zeros(g.device), steps=0, pushes=0,
                      trace=StepTrace.empty(self.trace_capacity, g.device),
                      xstate=self.backend.init_exchange_state(g))

    def _result(self, c: _Carry, converged: bool,
                epochs: int) -> EngineResult:
        return EngineResult(
            state=c.state, cost=c.cost, steps=c.steps, push_steps=c.pushes,
            converged=converged, epochs=epochs,
            trace=c.trace if self.trace_capacity > 0 else None,
            xstate=c.xstate)

    def run(self, g: Graph, init_state: Any,
            init_frontier: torch.Tensor) -> EngineResult:
        with region("engine.run"):
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

            c = self._carry(g, init_state, init_frontier)

            def run_epoch(epoch: int) -> bool:
                conv = True
                for phase in phases:
                    ph, st = self._enter(g, phase, c, epoch)
                    conv = self._finish(g, ph, self._loop(g, ph, st), c)
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
            return self._result(c, converged, epochs)

    # -- host-driven stepwise execution (telemetry and resilience) --------
    @property
    def supports_stepwise(self) -> bool:
        """True when :meth:`run_stepwise` can execute this program:
        flat (single-phase, single-epoch) programs only."""
        return not isinstance(self.program, PhaseProgram)

    @staticmethod
    def _check_finite(state: Any, mode, step: int) -> None:
        """Stop on non-finite float state: ``mode`` ``"nan"`` trips on
        NaN only (BFS and SSSP carry ±Inf sentinels), ``"all"`` or True
        on NaN or ±Inf. The leaves' flags are reduced on the device and
        read once. Raises :class:`DivergenceError` naming the step."""
        strict = mode in ("all", True)
        flags = [(~torch.isfinite(x)).any() if strict else x.isnan().any()
                 for x in tree_leaves(state) if x.dtype.is_floating_point]
        if flags and bool(torch.stack(flags).any()):
            raise DivergenceError(step=step,
                                  mode="all" if strict else "nan")

    def run_stepwise(self, g: Graph, init_state: Any,
                     init_frontier: torch.Tensor,
                     on_step: Optional[Callable] = None,
                     check_finite=None, checkpoint_every: int = 0,
                     resume_from: Optional[Checkpoint] = None
                     ) -> EngineResult:
        """Run a flat program step by step with guards around each step.

        The same step function and loop as :meth:`run`, so the result
        (state, ``Cost``, steps, push steps, ``StepTrace``, converged) is
        bit-identical to it, provided the backend's kernels are
        deterministic. Around each step:

        * the ``engine.step`` fault site;
        * ``on_step(step_index, wall_us)``: the step's wall time, on the
          card up to a ``torch.cuda.synchronize``. Before the timed
          loop one step runs on a copy of the carry and is thrown away,
          so that the first timed step does not pay for the tuner's
          probes, plans and library loads;
        * ``check_finite``: ``"nan"``, ``"all"`` or True enables the
          divergence check (:meth:`_check_finite`) after every step;
        * ``checkpoint_every=N``: a :class:`Checkpoint` every N
          completed steps. A failure mid-loop (an injected
          ``engine.step`` fault, a failing launch) raises
          :class:`SolveInterrupted` carrying the last one;
        * ``resume_from``: re-enter the loop from a checkpoint (a copy
          of it, so it can serve again).

        Raises:
            ValueError: for :class:`PhaseProgram` programs.
            DivergenceError: ``check_finite`` tripped.
            SolveInterrupted: the loop died.
        """
        if not self.supports_stepwise:
            raise ValueError(
                "run_stepwise executes flat (single-VertexProgram) "
                "programs only; phase-structured programs run under "
                "run() — check supports_stepwise before dispatching")
        phase = Phase(program=self.program, max_steps=self.max_steps)
        c = self._carry(g, init_state, init_frontier)
        ph, st = self._enter(g, phase, c, 0)
        if resume_from is not None:
            st = _clone(resume_from.carry)
        watch = _Watch(torch.device(g.device), on_step, check_finite,
                       checkpoint_every, resume_from)
        if on_step is not None and ph.going(st):
            self._step(g, ph, _clone(st))       # warm-up, thrown away
        try:
            st = self._loop(g, ph, st, watch)
        except (DivergenceError, SolveInterrupted):
            raise
        except Exception as exc:  # noqa: BLE001 — the resumable seam
            raise SolveInterrupted(step=watch.i,
                                   checkpoint=watch.last) from exc
        return self._result(c, self._finish(g, ph, st, c), 1)
