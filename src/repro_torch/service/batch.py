"""solve_batch — one engine run answering B queries. PyTorch port of
``repro.service.batch``.

The batched path shares what a loop of single-source ``solve`` calls
would repeat: the graph layouts, every pull step's scan (one scan, B
payload columns), every push step's scatter (the union frontier), and
the direction decision (one :class:`~repro_torch.core.cost_model.
StepStats` per step, priced with ``width=B``). Engines are cached per
(algorithm, batch width, policy, backend, static kwargs, graph shape),
as ``api.solve`` caches them.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from .. import api
from ..core.backend import ExchangeBackend
from ..core.cost_model import Cost
from ..core.direction import DirectionPolicy
from ..core.engine import PushPullEngine
from ..graphs.structure import Graph
from ..obs.trace import region
from .programs import BatchSpec, _sources_array, get_batch_spec

__all__ = ["BatchResult", "solve_batch", "run_chunk", "default_step_bound"]


class BatchResult(NamedTuple):
    """Result of one batched multi-query run.

    Attributes:
        states: per-query public states, ``states[i]`` equal to
            ``api.solve(g, algorithm, source=sources[i], ...).state``.
        state: the raw batched state (leaves carry the query axis).
        cost: whole-batch counters (one union-frontier scatter or one
            B-wide scan per step, not the sum of B single-query costs).
        done: ``bool[B]`` per-query completion mask.
        converged / steps / push_steps / epochs: engine-level, shared
            across the batch (queries step in lockstep).
    """
    states: list
    state: Any
    cost: Cost
    steps: int
    push_steps: int
    converged: bool
    epochs: int
    done: torch.Tensor
    batch: int


_ENGINE_CACHE = api.EngineCache()


def _engine_for(g: Graph, algorithm: str, bspec: BatchSpec, batch: int,
                policy: DirectionPolicy, backend: ExchangeBackend,
                max_steps: Optional[int], static_kw: dict,
                trace_capacity: int = 0) -> PushPullEngine:
    def build_engine() -> PushPullEngine:
        try:
            program, default_steps = bspec.build(
                g, batch, policy=policy, backend=backend, **static_kw)
        except (NotImplementedError, ValueError) as e:
            raise ValueError(
                f"algorithm {algorithm!r} does not support the batched "
                f"combination policy={policy.name} × "
                f"backend={backend.name}: {e}") from e
        return PushPullEngine(
            program=program, policy=policy,
            max_steps=default_steps if max_steps is None else max_steps,
            backend=backend, trace_capacity=trace_capacity)

    return _ENGINE_CACHE.get_or_build(
        (algorithm, bspec, batch, policy, backend,
         tuple(sorted(static_kw.items())),
         g.n, g.m, g.d_ell, max_steps, trace_capacity), build_engine)


def _resolve(g: Graph, algorithm: str, sources, policy, backend, kw):
    spec = api.get_spec(algorithm)          # KeyError on unknown name
    bspec = get_batch_spec(algorithm)
    if sources is not None:
        api.validate_vertex_indices(g, "sources", sources)
    policy = (spec.default_policy if policy is None
              else api._resolve_policy(policy))
    backend = api._resolve_backend(backend, g)
    static_kw = {k: v for k, v in kw.items()
                 if k not in bspec.runtime_keys}
    return bspec, policy, backend, static_kw


def run_chunk(g: Graph, algorithm: str, batch: int, *, state, frontier,
              policy=None, backend=None, max_steps: Optional[int] = None,
              **kw):
    """One (possibly partial) batched engine run from a carried state —
    the scheduler's chunk primitive. Returns the raw ``EngineResult``
    and the per-query done mask."""
    with region("batch.run_chunk"):
        bspec, policy, backend, static_kw = _resolve(
            g, algorithm, None, policy, backend, kw)
        engine = _engine_for(g, algorithm, bspec, batch, policy, backend,
                             max_steps, static_kw)
        res = engine.run(g, state, frontier)
        return res, bspec.done(g, res.state, None, **kw)


def default_step_bound(g: Graph, algorithm: str, batch: int, *,
                       policy=None, backend=None, **kw) -> int:
    """The step (epoch, for phase programs) bound an unchunked run of
    this batched program gets, which the scheduler applies across
    chunks."""
    bspec, policy, backend, static_kw = _resolve(
        g, algorithm, None, policy, backend, kw)
    _, default_steps = bspec.build(g, batch, policy=policy,
                                   backend=backend, **static_kw)
    return int(default_steps)


def solve_batch(g: Graph, algorithm: str, *, sources, policy=None,
                backend=None, max_steps: Optional[int] = None,
                telemetry=None, **kw) -> BatchResult:
    """Batched multi-query solve — see :func:`repro_torch.api.solve_batch`
    for the public contract."""
    with region("batch.solve_batch"):
        batch = int(_sources_array(sources).shape[0])
        bspec, policy, backend, static_kw = _resolve(
            g, algorithm, sources, policy, backend, kw)
        tcap = api._DEFAULT_TRACE_CAPACITY if telemetry is not None else 0
        engine = _engine_for(g, algorithm, bspec, batch, policy, backend,
                             max_steps, static_kw, trace_capacity=tcap)
        state0, frontier0 = bspec.init(g, sources, **kw)
        if telemetry is None:
            res = engine.run(g, state0, frontier0)
        else:
            res = api._solve_observed(telemetry, engine, g, state0, frontier0,
                                      algorithm=algorithm, policy=policy,
                                      backend=backend)
        done = bspec.done(g, res.state, None, **kw)
        states = [bspec.extract(g, res.state, i) for i in range(batch)]
        return BatchResult(states=states, state=res.state, cost=res.cost,
                           steps=res.steps, push_steps=res.push_steps,
                           converged=res.converged, epochs=res.epochs,
                           done=done, batch=batch)
