"""repro_torch.api — one k-relaxation API for the graph workloads.
PyTorch port of ``repro.api``: ``solve`` for the ten algorithms of the
JAX package, and ``solve_batch`` for B queries of the
source-parameterized ones in one engine run, each with the reference's
telemetry (``telemetry=``) and, for ``solve``, its resilience guards
(``check_finite=``, ``checkpoint_every=``).

    import torch
    from repro_torch import api
    from repro_torch.graphs import kronecker
    from repro_torch.shard import ShardedBackend

    g = kronecker(12, 16, weighted=True)                    # on the card
    r = api.solve(g, "pagerank", iters=20, backend="cuda")  # CUDA kernels
    r = api.solve(g, "bfs", root=0, policy="auto", backend="cuda")
    r = api.solve(g, "sssp_delta", source=0, delta=2.0)     # dense backend
    r = api.solve(g, "mst_boruvka", backend="cuda")         # local steps
    br = api.solve_batch(g, "ppr", sources=[0, 5, 9], backend="cuda")
    br.states[1]["ranks"]          # == solve(g, "ppr", source=5).state
    r = api.solve(g, "pagerank", backend="shard")  # a shard per card
    sb = ShardedBackend.prepare(g, devices=[torch.device("cuda")] * 4,
                                inner="cuda")       # 4 shards, one card
    r = api.solve(g, "bfs", root=0, policy="auto", backend=sb)

    tel = Telemetry()              # repro_torch.obs: step times, counters
    r = api.solve(g, "bfs", root=0, policy="auto", backend="cuda",
                  telemetry=tel)   # and the AutoSwitch decision audit

``policy`` picks the direction per step (``"push"``, ``"pull"``,
``"gs"``, ``"grs"``, ``"auto"`` or a DirectionPolicy); ``backend`` the
memory system (``"dense"``, ``"ell"``, ``"cuda"``, ``"shard"`` or an
ExchangeBackend such as ``DistributedBackend.prepare(g)``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import numpy as np

from .core.algorithms import (
    betweenness_finalize, betweenness_init, betweenness_program, bfs_init,
    bfs_program, coloring_finalize, coloring_init, coloring_program,
    mst_finalize, mst_init, mst_program, pagerank_init, pagerank_program,
    ppr_finalize, ppr_init, ppr_program, pr_delta_finalize, pr_delta_init,
    pr_delta_program, sssp_delta_finalize, sssp_delta_init,
    sssp_delta_program, triangle_finalize, triangle_init, triangle_program,
    wcc_init, wcc_program)
from .core.backend import (CudaBackend, DenseBackend, DistributedBackend,
                           EllBackend, ExchangeBackend)
from .core.cost_model import Cost, StepTrace
from .core.direction import (AutoSwitch, Direction, DirectionPolicy, Fixed,
                             GenericSwitch, GreedySwitch)
from .core.engine import PushPullEngine
from .graphs.structure import Graph

__all__ = ["RunResult", "AlgorithmSpec", "EngineCache", "register",
           "algorithms", "get_spec", "solve", "solve_batch",
           "clear_engine_cache",
           "validate_vertex_indices",
           "POLICY_SHORTHANDS", "BACKEND_SHORTHANDS", "DenseBackend",
           "EllBackend", "CudaBackend", "DistributedBackend",
           "ExchangeBackend", "Fixed",
           "GenericSwitch", "GreedySwitch", "AutoSwitch", "Direction"]


class RunResult(NamedTuple):
    """Result of ``solve``: the algorithm's public ``state``, the §4
    ``cost`` counters, ``steps`` (relaxation steps across all phases),
    ``push_steps``, ``converged``, ``epochs`` (1 for flat programs) and
    the per-step ``trace`` when ``solve(..., trace=N)`` was given."""
    state: Any
    cost: Cost
    steps: int
    push_steps: int
    converged: bool
    epochs: int
    trace: Optional[StepTrace] = None


@dataclasses.dataclass(frozen=True)
class AlgorithmSpec:
    """How an algorithm plugs into the engine.

    build(g, *, policy, backend, **static_kw) -> (program,
        default_max_steps); raises NotImplementedError/ValueError for
        (policy, backend) combinations it cannot run.
    init(g, **kw) -> (init_state, init_frontier).
    finalize(g, state) -> public state.
    runtime_keys: kwargs consumed only by ``init`` (not in the cache key).
    backends: declared-supported backend names (introspection only; the
        authoritative check lives in ``build``).
    """
    name: str
    build: Callable
    init: Callable
    finalize: Callable = staticmethod(lambda g, state: state)
    default_policy: DirectionPolicy = GenericSwitch()
    runtime_keys: tuple = ()
    backends: tuple = ("dense", "ell", "cuda", "distributed", "shard")
    paper: str = ""


_REGISTRY: dict[str, AlgorithmSpec] = {}


class EngineCache:
    """Bounded FIFO of built engines keyed by hashable tuples;
    unhashable keys skip caching and rebuild every call. An engine keeps
    its backend, and a sharded or distributed backend keeps its shards'
    copies (or views) of the graph on the card: such an entry pins them
    until it is evicted or :meth:`clear` drops it."""

    def __init__(self, max_size: int = 128):
        self.max_size = max_size
        self._data: dict = {}

    def get_or_build(self, key, build: Callable):
        try:
            hash(key)
        except TypeError:
            return build()
        engine = self._data.get(key)
        if engine is None:
            engine = build()
            while len(self._data) >= self.max_size:
                self._data.pop(next(iter(self._data)))
            self._data[key] = engine
        return engine

    def clear(self) -> None:
        self._data.clear()


_ENGINE_CACHE = EngineCache()


def clear_engine_cache() -> None:
    """Drop every engine ``solve`` and ``solve_batch`` have cached, and
    with them what their backends hold for graphs no longer in use."""
    _ENGINE_CACHE.clear()


def register(spec: AlgorithmSpec) -> AlgorithmSpec:
    _REGISTRY[spec.name] = spec
    return spec


def algorithms() -> list[str]:
    """Names accepted by ``solve``."""
    return sorted(_REGISTRY)


def get_spec(name: str) -> AlgorithmSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown algorithm {name!r}; registered: {algorithms()}"
        ) from None


POLICY_SHORTHANDS: dict[str, Callable[[], DirectionPolicy]] = {
    "push": lambda: Fixed(Direction.PUSH),
    "pull": lambda: Fixed(Direction.PULL),
    "gs": GenericSwitch,
    "grs": GreedySwitch,
    "auto": AutoSwitch,
}

# one shared instance per name: engines are cached per backend instance,
# and the CUDA backend keeps its per-graph bin plans, layouts and tuner
# results
BACKEND_SHORTHANDS: dict[str, ExchangeBackend] = {
    "dense": DenseBackend(),
    "ell": EllBackend(),
    "cuda": CudaBackend(),
}

# solve(trace=True) records up to this many steps
_DEFAULT_TRACE_CAPACITY = 256

_VERTEX_KEYS = ("root", "source")


def validate_vertex_indices(g: Graph, name: str, value) -> None:
    """Raise ``ValueError`` naming any vertex index outside ``[0, n)``."""
    if hasattr(value, "cpu"):
        value = value.cpu()
    arr = np.asarray(value)
    if arr.size == 0:
        return
    if arr.dtype == object or not np.issubdtype(arr.dtype, np.integer):
        raise ValueError(
            f"{name}={value!r} is not a vertex index (expected integer "
            f"in [0, {g.n}))")
    bad = (arr < 0) | (arr >= g.n)
    if bad.any():
        first = int(arr.reshape(-1)[np.flatnonzero(bad.reshape(-1))[0]])
        raise ValueError(
            f"{name} contains vertex index {first} out of range for a "
            f"graph with n={g.n} vertices (valid: 0..{g.n - 1})")


def _resolve_policy(policy) -> DirectionPolicy:
    if not isinstance(policy, str):
        return policy
    try:
        return POLICY_SHORTHANDS[policy]()
    except KeyError:
        raise ValueError(
            f"unknown policy shorthand {policy!r}; valid options: "
            f"{sorted(POLICY_SHORTHANDS)} (or pass a DirectionPolicy "
            "instance)") from None


# graph-specific "shard" backends, one per live graph (keyed by id, with
# a weakref guard against id reuse after collection)
_SHARD_BACKENDS: dict[int, tuple] = {}


def _shard_backend_for(g: Graph) -> ExchangeBackend:
    import weakref

    from .shard import ShardedBackend
    key = id(g)
    hit = _SHARD_BACKENDS.get(key)
    if hit is not None and hit[0]() is g:
        return hit[1]
    prepared = ShardedBackend.prepare(g)
    ref = weakref.ref(g, lambda _: _SHARD_BACKENDS.pop(key, None))
    _SHARD_BACKENDS[key] = (ref, prepared)
    return prepared


def _resolve_backend(backend, g: Optional[Graph] = None) -> ExchangeBackend:
    if backend is None:
        return BACKEND_SHORTHANDS["dense"]
    if not isinstance(backend, str):
        return backend
    if backend == "shard":
        # graph-specific: prepared per graph (a shard per visible CUDA
        # device), not a shared instance like the other shorthands
        if g is None:
            raise ValueError(
                "backend='shard' is graph-specific; pass it through "
                "solve()/solve_batch(), or prepare an instance with "
                "repro_torch.shard.ShardedBackend.prepare(g)")
        return _shard_backend_for(g)
    try:
        return BACKEND_SHORTHANDS[backend]
    except KeyError:
        raise ValueError(
            f"unknown backend shorthand {backend!r}; valid options: "
            f"{sorted(BACKEND_SHORTHANDS) + ['shard']} (or pass an "
            "ExchangeBackend instance, e.g. "
            "DistributedBackend.prepare(g))") from None


def solve(g: Graph, algorithm: str, *,
          policy: Optional[DirectionPolicy | str] = None,
          backend: Optional[ExchangeBackend | str] = None,
          max_steps: Optional[int] = None, trace: int | bool = 0,
          telemetry=None, check_finite=None, checkpoint_every: int = 0,
          **kw) -> RunResult:
    """Run ``algorithm`` on ``g`` (on ``g``'s device) under a direction
    policy and an exchange backend.

    Args:
        g: the :class:`~repro_torch.graphs.structure.Graph`.
        algorithm: a registered name — see :func:`algorithms`.
        policy: a DirectionPolicy or ``"push"``, ``"pull"``, ``"gs"``,
            ``"grs"``, ``"auto"``; default: the algorithm's own.
        backend: an ExchangeBackend or ``"dense"`` (default), ``"ell"``,
            ``"cuda"`` (the CUDA kernels; plain versions on CPU tensors),
            ``"shard"`` (a ``ShardedBackend`` prepared for ``g``, one
            shard per visible CUDA device).
        max_steps: per-phase step bound (bounds epochs for phase
            programs).
        trace: StepTrace capacity, or True for 256 slots.
        telemetry: a :class:`repro_torch.obs.Telemetry` handle, or None
            (default). With a handle the run emits per-step counter and
            prediction rows, a run summary, a ``solve:<algorithm>`` span
            and a direction-decision audit into it, and flat programs
            run step by step so each step also carries its wall time
            (``telemetry.step_timing = False`` keeps ``run``). None runs
            the engine's ``run`` and imports nothing of ``obs``.
        check_finite: the divergence guard: ``"nan"`` trips on NaN
            state, ``"all"`` or True also on ±Inf (BFS and SSSP carry
            Inf sentinels). Flat programs check after every step and
            raise :class:`repro_torch.resilience.DivergenceError` naming
            the step; phase programs check the final state.
        checkpoint_every: snapshot the loop carry every N steps (flat
            programs only); an interrupted solve resumes from the last
            checkpoint, bit-identical, within a bounded number of
            stalled resumes. 0 (default) disables.
        **kw: ``root``, ``source``, ``iters``, ``damp``, ``delta``,
            ``tol``, ``num_sources``, ``num_parts``, ``C``, ...

    Raises:
        KeyError: unknown algorithm.
        ValueError: unknown shorthand, unsupported (policy × backend)
            combination, a ``root``/``source`` outside ``[0, n)``, or
            ``checkpoint_every`` on a phase program.
    """
    spec = get_spec(algorithm)
    for vkey in _VERTEX_KEYS:
        if vkey in kw:
            validate_vertex_indices(g, vkey, kw[vkey])
    policy = (spec.default_policy if policy is None
              else _resolve_policy(policy))
    backend = _resolve_backend(backend, g)
    trace_capacity = (_DEFAULT_TRACE_CAPACITY if trace is True
                      else int(trace))
    if telemetry is not None and trace_capacity == 0:
        # telemetry needs the StepTrace rows to audit against
        trace_capacity = _DEFAULT_TRACE_CAPACITY
    static_kw = {k: v for k, v in kw.items() if k not in spec.runtime_keys}

    def build_engine() -> PushPullEngine:
        try:
            program, default_steps = spec.build(
                g, policy=policy, backend=backend, **static_kw)
        except (NotImplementedError, ValueError) as e:
            raise ValueError(
                f"algorithm {algorithm!r} does not support the "
                f"combination policy={policy.name} × "
                f"backend={backend.name}: {e}") from e
        return PushPullEngine(
            program=program, policy=policy,
            max_steps=default_steps if max_steps is None else max_steps,
            backend=backend, trace_capacity=trace_capacity)

    engine = _ENGINE_CACHE.get_or_build(
        (algorithm, spec, policy, backend,
         tuple(sorted(static_kw.items())),
         g.n, g.m, g.d_ell, max_steps, trace_capacity), build_engine)
    init_state, init_frontier = spec.init(g, **kw)
    if checkpoint_every and not engine.supports_stepwise:
        raise ValueError(
            f"checkpoint_every is supported for flat programs only; "
            f"{algorithm!r} is phase-structured (its epoch/phase loop "
            "runs under run())")
    guards = bool(check_finite) or checkpoint_every > 0
    if telemetry is not None:
        res = _solve_observed(telemetry, engine, g, init_state,
                              init_frontier, algorithm=algorithm,
                              policy=policy, backend=backend,
                              check_finite=check_finite,
                              checkpoint_every=checkpoint_every)
    elif guards and engine.supports_stepwise:
        res = _run_stepwise_resilient(
            engine, g, init_state, init_frontier,
            check_finite=check_finite, checkpoint_every=checkpoint_every)
    else:
        res = engine.run(g, init_state, init_frontier)
        if check_finite:
            # phase programs are checked at run end
            PushPullEngine._check_finite(res.state, check_finite, res.steps)
    return RunResult(state=spec.finalize(g, res.state), cost=res.cost,
                     steps=res.steps, push_steps=res.push_steps,
                     converged=res.converged, epochs=res.epochs,
                     trace=res.trace)


def _run_stepwise_resilient(engine: PushPullEngine, g: Graph,
                            init_state, init_frontier, *, on_step=None,
                            check_finite=None, checkpoint_every: int = 0,
                            max_resumes: int = 4):
    """Stepwise execution with checkpoint-resume: a failure mid-loop (an
    injected ``engine.step`` fault, a failing launch) resumes from the
    last checkpoint, or restarts when it predates the first; the replayed
    steps are the same calls, so the result is bit-identical to an
    uninterrupted run. ``max_resumes`` bounds consecutive resumes
    without checkpoint progress: a fault pattern may interrupt a long
    solve any number of times as long as each resume advances the
    checkpoint, while a permanent failure re-raises
    :class:`~repro_torch.resilience.SolveInterrupted` after
    ``max_resumes`` stalled attempts (``__cause__`` is the original
    error)."""
    from .resilience import SolveInterrupted, note
    ckpt = None
    stalled = 0
    while True:
        try:
            return engine.run_stepwise(
                g, init_state, init_frontier, on_step=on_step,
                check_finite=check_finite,
                checkpoint_every=checkpoint_every, resume_from=ckpt)
        except SolveInterrupted as e:
            progressed = e.checkpoint is not None and (
                ckpt is None or e.checkpoint.step > ckpt.step)
            stalled = 0 if progressed else stalled + 1
            if stalled > max_resumes:
                raise
            if e.checkpoint is not None:
                ckpt = e.checkpoint
            note("resume.engine.step", failed_step=e.step,
                 resume_from=(ckpt.step if ckpt is not None else 0),
                 stalled=stalled)


def _solve_observed(tel, engine: PushPullEngine, g: Graph, init_state,
                    init_frontier, *, algorithm: str,
                    policy: DirectionPolicy, backend: ExchangeBackend,
                    check_finite=None, checkpoint_every: int = 0):
    """The telemetry path of ``solve`` and ``solve_batch``: run the
    engine (step by step with per-step wall times when the handle asks
    for them and the program is flat), inside a ``solve:<algorithm>``
    span that ends with a synchronize of the card; then fold the result
    into the handle (step and run events, the tuner's and the
    resilience layer's counters) and emit an ``audit`` event when the
    run has step rows."""
    from .obs.metrics import collect_resilience, collect_tuner, record_solve
    from .obs.report import decision_audit

    run = tel.new_run()
    step_times: dict[int, float] = {}
    t0 = tel.now_us()
    guards = bool(check_finite) or checkpoint_every > 0
    with tel.span(f"solve:{algorithm}", device=g.device, run=run,
                  algorithm=algorithm, policy=policy.name,
                  backend=backend.name) as sp:
        if (tel.step_timing or guards) and engine.supports_stepwise:
            res = _run_stepwise_resilient(
                engine, g, init_state, init_frontier,
                on_step=(lambda i, us: step_times.__setitem__(i, us))
                if tel.step_timing else None,
                check_finite=check_finite,
                checkpoint_every=checkpoint_every)
        else:
            res = engine.run(g, init_state, init_frontier)
            if check_finite:
                PushPullEngine._check_finite(res.state, check_finite,
                                             res.steps)
        sp["steps"] = int(res.steps)
    record_solve(tel, algorithm=algorithm, policy=policy,
                 backend=backend, result=res, run=run,
                 step_times=step_times or None, t0_us=t0)
    collect_tuner(tel)
    collect_resilience(tel)
    audit = decision_audit(tel.events_for(run, "step"), run=run)
    if audit is not None:
        tel.emit("audit", run=run, basis=audit["basis"],
                 audited_steps=audit["audited_steps"],
                 flagged=audit["flagged"],
                 mispredict_rate=audit["mispredict_rate"])
    return res


def solve_batch(g: Graph, algorithm: str, *, sources,
                policy: Optional[DirectionPolicy | str] = None,
                backend: Optional[ExchangeBackend | str] = None,
                max_steps: Optional[int] = None, telemetry=None, **kw):
    """Run B queries of ``algorithm`` (one per entry of ``sources``) as
    one batched engine run over ``g``: B payload columns, one graph scan
    per pull step, one union-frontier scatter per push step. Per-query
    results equal a loop of single-source :func:`solve` calls.

    Only ``"bfs"``, ``"sssp_delta"`` and ``"ppr"`` have batched programs
    (``repro_torch.service.batchable()``).

        br = api.solve_batch(g, "bfs", sources=[0, 5, 9])
        br.states[1]["dist"]       # == solve(g, "bfs", root=5).state["dist"]

    ``telemetry``: a :class:`repro_torch.obs.Telemetry` handle, as for
    :func:`solve` (the whole batch is one run).

    Returns a :class:`repro_torch.service.BatchResult`.

    Raises:
        KeyError: unknown algorithm, or one without a batched program.
        ValueError: empty ``sources``, a source outside ``[0, n)``, or
            an unsupported (policy × backend) cell.
    """
    from .service.batch import solve_batch as _solve_batch
    return _solve_batch(g, algorithm, sources=sources, policy=policy,
                        backend=backend, max_steps=max_steps,
                        telemetry=telemetry, **kw)


register(AlgorithmSpec(
    name="bfs", build=bfs_program, init=bfs_init,
    runtime_keys=("root",), paper="§3.3/§4.3 Alg. 3"))

register(AlgorithmSpec(
    name="pagerank", build=pagerank_program, init=pagerank_init,
    default_policy=Fixed(Direction.PULL), paper="§3.1/§4.1 Alg. 1"))

register(AlgorithmSpec(
    name="ppr", build=ppr_program, init=ppr_init, finalize=ppr_finalize,
    default_policy=Fixed(Direction.PULL), runtime_keys=("source",),
    backends=("dense", "ell", "cuda", "shard"),
    paper="§3.1 (personalized variant; service-layer batching)"))

register(AlgorithmSpec(
    name="sssp_delta", build=sssp_delta_program, init=sssp_delta_init,
    finalize=sssp_delta_finalize, default_policy=Fixed(Direction.PUSH),
    runtime_keys=("source",), backends=("dense", "ell", "cuda", "shard"),
    paper="§3.4/§4.4 Alg. 4"))

register(AlgorithmSpec(
    name="wcc", build=wcc_program, init=wcc_init,
    paper="§3.3 (label propagation)"))

register(AlgorithmSpec(
    name="pr_delta", build=pr_delta_program, init=pr_delta_init,
    finalize=pr_delta_finalize, default_policy=Fixed(Direction.PUSH),
    paper="§3.1 (Whang [60])"))

register(AlgorithmSpec(
    name="betweenness", build=betweenness_program, init=betweenness_init,
    finalize=betweenness_finalize, default_policy=Fixed(Direction.PULL),
    backends=("dense", "ell", "cuda"), paper="§3.5/§4.5 Alg. 5"))

register(AlgorithmSpec(
    name="coloring", build=coloring_program, init=coloring_init,
    finalize=coloring_finalize, default_policy=Fixed(Direction.PUSH),
    backends=("dense", "ell", "cuda"), paper="§3.6/§4.6 Alg. 6"))

register(AlgorithmSpec(
    name="mst_boruvka", build=mst_program, init=mst_init,
    finalize=mst_finalize, default_policy=Fixed(Direction.PULL),
    backends=("dense", "ell", "cuda"), paper="§3.7/§4.7 Alg. 7"))

register(AlgorithmSpec(
    name="triangle_count", build=triangle_program, init=triangle_init,
    finalize=triangle_finalize, default_policy=Fixed(Direction.PULL),
    backends=("dense", "ell", "cuda"), paper="§3.2/§4.2 Alg. 2"))
