"""QueryService — continuous batching over fixed query slots. PyTorch
port of ``repro.service.scheduler``, with its fault sites, chunk retries
and telemetry.

A fixed budget of B query *slots*, one batched engine run per compatible
request group, and between engine *chunks* every finished query retires
and frees its slot for the next queued request (``BatchSpec.admit``
splices the newcomer's column into the carried state; the engine resumes
from the rewritten carry).

Requests are grouped by (algorithm, policy, backend, static params).
Results land in an LRU :class:`~repro_torch.service.cache.ResultCache`
keyed by (graph fingerprint, algorithm, source, params, policy,
backend); repeated submissions hit the cache without touching the
engine, and identical in-flight requests coalesce onto one slot.

    svc = QueryService(g, slots=8, backend="cuda")
    rids = [svc.submit("bfs", source=s) for s in range(16)]
    svc.submit("ppr", source=3)
    svc.run_until_complete()
    svc.poll(rids[0])["dist"]          # == api.solve(g,"bfs",root=0)...
    svc.stats()["cache"]["hits"]

Algorithms without a batched program still flow through submit/poll:
each runs as one ``api.solve`` when its group is scheduled.

Failures: each chunk (and each single solve) runs behind the
``service.chunk`` fault site with bounded retries of transient errors;
a failing result-cache lookup or store (``service.cache.get``,
``service.cache.put``) degrades to a recompute. Each recovery is
counted and noted for ``repro_torch.obs``.
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Any, Optional

import numpy as np

from .. import api
from ..graphs.structure import Graph
from ..obs.trace import region
from ..resilience import (AdmissionError, DeadlineExceeded, FaultInjected,
                          fault_point, note)
from .batch import default_step_bound, run_chunk
from .cache import ResultCache, graph_fingerprint
from .programs import batchable, get_batch_spec

__all__ = ["QueryService", "QueryRecord"]

#: Finished queries whose queue and in-slot waits ``stats()`` reports.
WAITS_KEPT = 4096


def _source_kwarg(algorithm: str) -> str:
    """The kwarg naming the query vertex (``root`` for BFS, ``source``
    for SSSP/PPR)."""
    keys = api.get_spec(algorithm).runtime_keys
    return keys[0] if keys else "source"


@dataclasses.dataclass
class QueryRecord:
    """One submitted query and, once served, its result."""
    rid: int
    algorithm: str
    source: Optional[int]
    params: tuple
    state: Any = None          # public state once done
    cached: bool = False       # served straight from the result cache
    converged: bool = True     # False when force-retired (best effort)
    error: Optional[Exception] = None   # the failure, if serving failed
    deadline_ms: Optional[float] = None  # wall budget from submit time
    submitted_at: float = 0.0  # clock() at submit (deadline anchor)
    slotted_at: Optional[float] = None   # clock() on taking a slot
    finished_at: Optional[float] = None  # clock() when its result landed

    @property
    def done(self) -> bool:
        return self.state is not None or self.error is not None


@dataclasses.dataclass
class _Active:
    """The engine-side carry of the group currently occupying slots."""
    group: tuple
    algorithm: str
    policy: Any
    backend: Any
    params: dict
    width: int
    state: Any
    frontier: Any
    slot_rids: list            # per column: (rid, cache key) or None
    slot_chunks: list          # per column: chunks spent on this query
    step_bound: int            # the unchunked run's step/epoch budget
    total_steps: int = 0       # engine steps consumed by this batch
    slot_steps0: list = dataclasses.field(default_factory=list)
    # per column: total_steps when the query entered its slot


class QueryService:
    """Batched multi-query serving over one graph.

    Args:
        g: the graph every query runs against.
        slots: query slots per batched engine run.
        chunk_steps: engine steps (epochs for phase programs) per chunk
            between slot-refill opportunities.
        max_chunks_per_query: chunk budget per query; a query still not
            done after it is force-retired with its best-effort state
            (``converged=False``, not cached).
        max_records: bound on retained finished query records.
        cache: a :class:`ResultCache`, or None for a fresh one.
        max_queue: bound on queued (not yet slotted) requests; a
            ``submit`` past it raises
            :class:`~repro_torch.resilience.AdmissionError` without
            consuming a request id. Cache hits and coalesced duplicates
            are always admitted. None means unbounded.
        max_chunk_retries: retries of a transient failure (an injected
            fault, I/O, a timeout) per chunk and per single solve,
            behind the ``service.chunk`` fault site; deterministic
            errors (a bad cell, bad kwargs) are never retried.
        clock: monotonic-seconds callable for deadline accounting.
        backend: the backend of every ``submit`` that names none (e.g.
            ``"cuda"``); None means the ``api`` default.
        telemetry: a :class:`repro_torch.obs.Telemetry` handle, or None.
            With a handle the scheduler emits ``service.*`` events
            (submit outcomes, batch starts, chunk spans, force-retires),
            serves single solves with the same handle (so they carry run
            and step events), and folds :meth:`stats` and the
            process-wide ``resilience.*`` counters into the handle each
            time a batch drains.
    """

    def __init__(self, g: Graph, *, slots: int = 8,
                 chunk_steps: int = 32,
                 max_chunks_per_query: int = 256,
                 max_records: int = 4096,
                 cache: Optional[ResultCache] = None,
                 max_queue: Optional[int] = None,
                 max_chunk_retries: int = 2,
                 clock=time.monotonic, backend=None, telemetry=None):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.telemetry = telemetry
        self.g = g
        self.slots = slots
        self.chunk_steps = chunk_steps
        self.max_chunks_per_query = max_chunks_per_query
        self.max_records = max_records
        self.max_queue = max_queue
        self.max_chunk_retries = max_chunk_retries
        self.backend = backend
        self.cache = cache if cache is not None else ResultCache()
        self._clock = clock
        self._fp = graph_fingerprint(g)
        self._next_rid = 0
        self._records: dict[int, QueryRecord] = {}
        self._pending = 0
        # group key -> FIFO of (rid, cache key, source, params); drained
        # queues are deleted
        self._queues: dict[tuple, deque] = {}
        self._inflight: dict[tuple, list[int]] = {}  # cache key -> rids
        self._active: Optional[_Active] = None
        self.coalesced = 0
        self.batches_started = 0
        self.chunks_run = 0
        self.force_retired = 0
        self.chunk_retries = 0
        self.deadline_expired = 0
        self.admission_rejected = 0
        self.cache_errors = 0
        self._failures: deque = deque(maxlen=64)
        # (queue, in-slot) ms of the newest WAITS_KEPT slotted queries
        # that finished, a ring: row n % WAITS_KEPT holds the n-th
        self._waits = np.zeros((WAITS_KEPT, 2))
        self._finished_waits = 0

    def _emit(self, name: str, **fields) -> None:
        if self.telemetry is not None:
            self.telemetry.emit("event", name, **fields)

    # -- submission ------------------------------------------------------
    def submit(self, algorithm: str, source: Optional[int] = None, *,
               policy=None, backend=None,
               deadline_ms: Optional[float] = None, **params) -> int:
        """Enqueue one query; returns a request id for :meth:`poll`.

        ``source`` is the query vertex of a source-parameterized
        algorithm (``root`` for BFS). ``deadline_ms`` bounds the query's
        wall time from submission: a query still queued or running past
        it fails with
        :class:`~repro_torch.resilience.DeadlineExceeded`. ``params``
        are the algorithm's kwargs (``delta``, ``damp``, ``iters``, ...).

        Raises :class:`~repro_torch.resilience.AdmissionError` (consuming
        no request id) when ``max_queue`` is set and the backlog is full.
        """
        api.get_spec(algorithm)                      # KeyError if unknown
        backend = self.backend if backend is None else backend
        if isinstance(policy, str):
            api._resolve_policy(policy)   # bad shorthand fails at submit
        if source is not None:
            api.validate_vertex_indices(self.g, "source", source)
            source = int(source)
        elif algorithm in batchable():
            raise ValueError(
                f"{algorithm!r} is source-parameterized: submit() "
                f"requires a source vertex (0..{self.g.n - 1})")
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError(
                f"deadline_ms must be > 0, got {deadline_ms}")
        pkey = tuple(sorted(params.items()))
        ckey = (self._fp, algorithm, source, pkey, policy, backend)
        hit = self._cache_lookup(ckey)
        coalesce = hit is None and ckey in self._inflight
        if hit is None and not coalesce and self.max_queue is not None:
            queued = sum(len(q) for q in self._queues.values())
            if queued >= self.max_queue:
                self.admission_rejected += 1
                note("admission.service.reject", queued=queued,
                     algorithm=algorithm)
                self._emit("service.admission_reject",
                           algorithm=algorithm, queued=queued)
                raise AdmissionError(queued, self.max_queue)
        rid = self._next_rid
        self._next_rid += 1
        rec = QueryRecord(rid=rid, algorithm=algorithm, source=source,
                          params=pkey, deadline_ms=deadline_ms,
                          submitted_at=self._clock())
        self._records[rid] = rec
        if hit is not None:
            rec.state, rec.converged = hit
            rec.cached = True
            self._emit("service.cache_hit", rid=rid, algorithm=algorithm)
            return rid
        if coalesce:                                 # coalesce duplicates
            self._inflight[ckey].append(rid)
            self.coalesced += 1
            self._pending += 1
            self._emit("service.coalesce", rid=rid, algorithm=algorithm)
            return rid
        self._inflight[ckey] = [rid]
        self._pending += 1
        gkey = (algorithm, policy, backend, rec.params)
        self._queues.setdefault(gkey, deque()).append((rid, ckey, source,
                                                       dict(params)))
        return rid

    def poll(self, rid: int) -> Optional[Any]:
        """The query's public state, or None while pending. Raises
        RuntimeError (chaining the original failure) if serving it
        failed."""
        rec = self._records[rid]
        if rec.error is not None:
            raise RuntimeError(
                f"query {rid} ({rec.algorithm!r}) failed: "
                f"{rec.error}") from rec.error
        return rec.state

    def status(self, rid: int) -> dict:
        """Non-raising view of one query, also for unknown or evicted
        rids and failed queries."""
        rec = self._records.get(rid)
        if rec is None:
            return {"rid": rid, "status": "unknown"}
        if rec.error is not None:
            return {"rid": rid, "status": "failed",
                    "algorithm": rec.algorithm,
                    "error": f"{type(rec.error).__name__}: {rec.error}"}
        if rec.state is not None:
            return {"rid": rid, "status": "done",
                    "algorithm": rec.algorithm, "cached": rec.cached,
                    "converged": rec.converged}
        return {"rid": rid, "status": "pending",
                "algorithm": rec.algorithm}

    def record(self, rid: int) -> QueryRecord:
        return self._records[rid]

    def pending(self) -> int:
        return self._pending

    # -- the serving loop ------------------------------------------------
    def step(self) -> int:
        """One scheduling action: run a chunk of the active batch (or
        start one, or serve one unbatchable query). Returns the number
        of queries completed by this step."""
        if self._active is None:
            with region("service.start"):
                started = self._start_next_group()
            if not started:
                return 0
            if self._active is None:                 # served unbatchable
                return 1
        return self._run_chunk()

    def run_until_complete(self, max_rounds: int = 100_000) -> None:
        """Drive :meth:`step` until every submitted query has a result."""
        rounds = 0
        while self.pending():
            rounds += 1
            if rounds > max_rounds:
                raise RuntimeError(
                    f"QueryService did not drain within {max_rounds} "
                    f"rounds ({self.pending()} queries still pending)")
            self.step()

    def stats(self) -> dict:
        return {"submitted": self._next_rid,
                "pending": self.pending(),
                "coalesced": self.coalesced,
                "batches_started": self.batches_started,
                "chunks_run": self.chunks_run,
                "force_retired": self.force_retired,
                "chunk_retries": self.chunk_retries,
                "deadline_expired": self.deadline_expired,
                "admission_rejected": self.admission_rejected,
                "cache_errors": self.cache_errors,
                "failures": list(self._failures),
                "cache": self.cache.stats(),
                "waits": self._wait_stats()}

    def _wait_stats(self) -> dict:
        """``count`` of the kept waits and the nearest-rank p50 and p95
        of each kind, in ms, where there are any: ``queue`` from submit
        to slot, ``in_slot`` from slot to result. Cache hits, coalesced
        followers and failed queries never held a slot and are left
        out."""
        count = min(self._finished_waits, len(self._waits))
        out: dict = {"count": count}
        if count:
            waits = np.sort(self._waits[:count], axis=0)
            for q in (50, 95):
                row = waits[max(0, math.ceil(q / 100.0 * count) - 1)]
                out[f"queue_p{q}_ms"] = float(row[0])
                out[f"in_slot_p{q}_ms"] = float(row[1])
        return out

    # -- internals -------------------------------------------------------
    def _cache_lookup(self, ckey):
        """Guarded ResultCache lookup: a failing cache (injected or
        real) degrades to a miss; the query is recomputed, never
        dropped."""
        try:
            fault_point("service.cache.get")
            return self.cache.get(ckey)
        except (OSError, FaultInjected) as e:
            self.cache_errors += 1
            note("fallback.service.cache.get", error=type(e).__name__)
            return None

    def _cache_store(self, ckey, value):
        """Guarded ResultCache store: a failing put loses the cache
        entry (a later identical submit recomputes), not the result."""
        try:
            fault_point("service.cache.put")
            self.cache.put(ckey, value)
        except (OSError, FaultInjected) as e:
            self.cache_errors += 1
            note("fallback.service.cache.put", error=type(e).__name__)

    def _chunk_call(self, fn):
        """The ``service.chunk`` fault site and ``fn()``, with bounded
        retries of transient failures (injected faults, I/O, timeouts).
        Deterministic errors (a bad cell, bad kwargs) raise on the
        first attempt."""
        for attempt in range(self.max_chunk_retries + 1):
            try:
                fault_point("service.chunk")
                return fn()
            except (FaultInjected, OSError, TimeoutError,
                    ConnectionError) as e:
                if attempt >= self.max_chunk_retries:
                    raise
                self.chunk_retries += 1
                note("retry.service.chunk", attempt=attempt + 1,
                     error=type(e).__name__)

    def _waited_ms(self, rec) -> Optional[float]:
        """Elapsed ms since submit iff the record's deadline passed."""
        if rec.deadline_ms is None:
            return None
        waited = (self._clock() - rec.submitted_at) * 1e3
        return waited if waited > rec.deadline_ms else None

    def _reap_expired(self, ckey, where: str) -> bool:
        """Fail every deadline-expired rid waiting on ``ckey``; True if
        any live requester remains (the work is still wanted)."""
        rids = self._inflight.get(ckey)
        if not rids:
            return False
        alive = []
        for rid in rids:
            rec = self._records[rid]
            waited = self._waited_ms(rec)
            if waited is None:
                alive.append(rid)
                continue
            self.deadline_expired += 1
            rec.error = DeadlineExceeded(rid, rec.deadline_ms, waited,
                                         where)
            self._pending -= 1
            note("deadline.service", rid=rid, where=where)
            self._emit("service.deadline", rid=rid, where=where,
                       algorithm=rec.algorithm)
        if alive:
            self._inflight[ckey] = alive
            return True
        del self._inflight[ckey]
        return False

    def _finish(self, ckey, state, converged=True, cacheable=None):
        # force-retired batched states depend on scheduler timing, so
        # they are never cached; entries carry the convergence flag
        if cacheable is None:
            cacheable = converged
        if cacheable:
            self._cache_store(ckey, (state, converged))
        now = self._clock()
        first = True
        for rid in self._inflight.pop(ckey, ()):
            rec = self._records[rid]
            rec.state, rec.converged = state, converged
            rec.finished_at = now
            if rec.slotted_at is not None:
                self._waits[self._finished_waits % len(self._waits)] = (
                    (rec.slotted_at - rec.submitted_at) * 1e3,
                    (now - rec.slotted_at) * 1e3)
                self._finished_waits += 1
            # coalesced followers count as cache-served, for reproducible
            # (cacheable) results only
            rec.cached = cacheable and not first
            first = False
            self._pending -= 1
        self._evict_records()

    def _fail(self, ckey, exc: Exception, *, slot=None, chunk=None):
        """Serving these queries failed: record the error and where it
        happened, and release their bookkeeping."""
        for rid in self._inflight.pop(ckey, ()):
            rec = self._records[rid]
            rec.error = exc
            self._pending -= 1
            self._failures.append(
                {"rid": rid, "algorithm": rec.algorithm,
                 "error": type(exc).__name__, "slot": slot,
                 "chunk": chunk})

    def _evict_records(self):
        if len(self._records) <= self.max_records:
            return
        for rid in list(self._records):
            if len(self._records) <= self.max_records:
                break
            if self._records[rid].done:
                del self._records[rid]

    def _start_next_group(self) -> bool:
        """Start the group whose head request is oldest (FIFO by rid), so
        a steady stream for one group never starves another."""
        gkey = min((k for k, q in self._queues.items() if q),
                   key=lambda k: self._queues[k][0][0], default=None)
        if gkey is None:
            return False
        algorithm, policy, backend, _ = gkey
        queue = self._queues[gkey]
        if algorithm not in batchable():
            rid, ckey, source, params = queue.popleft()
            if not queue:
                del self._queues[gkey]
            if not self._reap_expired(ckey, "queued"):
                return True      # every requester timed out while queued
            if source is not None:
                params[_source_kwarg(algorithm)] = source
            self._records[rid].slotted_at = self._clock()
            try:
                r = self._chunk_call(
                    lambda: api.solve(self.g, algorithm, policy=policy,
                                      backend=backend,
                                      telemetry=self.telemetry, **params))
            except Exception as e:            # bad cell / bad kwargs
                self._fail(ckey, e)
                return True
            # a single solve is deterministic given its params, so the
            # result is cacheable even at its step bound
            self._finish(ckey, r.state, converged=bool(r.converged),
                         cacheable=True)
            return True
        bspec = get_batch_spec(algorithm)
        width = min(self.slots, len(queue))
        taken = [queue.popleft() for _ in range(width)]
        if not queue:
            del self._queues[gkey]
        taken = [t for t in taken if self._reap_expired(t[1], "queued")]
        if not taken:
            return True          # the whole head timed out while queued
        now = self._clock()
        for t in taken:
            self._records[t[0]].slotted_at = now
        width = len(taken)
        params = dict(taken[0][3])
        try:
            state, frontier = bspec.init(
                self.g, [t[2] for t in taken], **params)
            step_bound = default_step_bound(
                self.g, algorithm, width, policy=policy,
                backend=backend, **params)
        except Exception as e:   # unsupported cell, bad kwargs, ...
            for j, t in enumerate(taken):
                self._fail(t[1], e, slot=j)
            return True
        self._active = _Active(
            group=gkey, algorithm=algorithm, policy=policy,
            backend=backend, params=params, width=width, state=state,
            frontier=frontier, slot_rids=[(t[0], t[1]) for t in taken],
            slot_chunks=[0] * width, step_bound=step_bound,
            slot_steps0=[0] * width)
        self.batches_started += 1
        self._emit("service.batch_start", algorithm=algorithm, width=width)
        return True

    def _run_chunk(self) -> int:
        act = self._active
        bspec = get_batch_spec(act.algorithm)
        # chunks never exceed the unchunked run's own step budget
        t0 = (self.telemetry.now_us() if self.telemetry is not None
              else 0.0)
        with region("service.chunk"):
            try:
                res, done = self._chunk_call(
                    lambda: run_chunk(
                        self.g, act.algorithm, act.width, state=act.state,
                        frontier=act.frontier, policy=act.policy,
                        backend=act.backend,
                        max_steps=min(self.chunk_steps, act.step_bound),
                        **act.params))
            except Exception as e:
                for i, slot in enumerate(act.slot_rids):
                    if slot is not None:
                        self._fail(slot[1], e, slot=i,
                                   chunk=act.slot_chunks[i])
                self._active = None
                return 0
            self.chunks_run += 1
            act.state = res.state
            # lockstep batches consume the program's bound unit together;
            # each query's budget counts from its admission
            act.total_steps += int(res.epochs
                                   if bspec.bound_unit == "epochs"
                                   else res.steps)
            done = (done | bool(res.converged)).cpu().tolist()
        if self.telemetry is not None:
            # the done mask's host read synchronized the chunk, so the
            # span covers its execution; it bears the range's name
            self.telemetry.emit(
                "span", "service.chunk", ts_us=t0,
                dur_us=round(self.telemetry.now_us() - t0, 3),
                algorithm=act.algorithm, width=act.width, steps=res.steps)
        with region("service.retire"):
            finished = 0
            queue = self._queues.get(act.group, deque())
            # refill only a full-width batch with no other group waiting:
            # an under-width batch drains and restarts wider, and a
            # waiting group gets the slots once this batch drains
            others_waiting = any(q for k, q in self._queues.items()
                                 if k != act.group and q)
            can_refill = act.width >= self.slots and not others_waiting
            for i in range(act.width):
                if act.slot_rids[i] is not None:
                    # mid-batch deadline check: a slot nobody wants
                    # anymore is abandoned (its column keeps stepping,
                    # unread)
                    if not self._reap_expired(act.slot_rids[i][1],
                                              "running"):
                        act.slot_rids[i] = None
                        finished += 1
                if act.slot_rids[i] is not None:
                    act.slot_chunks[i] += 1
                    consumed = act.total_steps - act.slot_steps0[i]
                    exhausted = (act.slot_chunks[i]
                                 >= self.max_chunks_per_query
                                 or consumed >= act.step_bound)
                    if exhausted and not done[i]:
                        self.force_retired += 1
                        self._emit("service.force_retire",
                                   rid=act.slot_rids[i][0],
                                   algorithm=act.algorithm)
                    if done[i] or exhausted:
                        _, ckey = act.slot_rids[i]
                        self._finish(ckey,
                                     bspec.extract(self.g, act.state, i),
                                     converged=bool(done[i]))
                        act.slot_rids[i] = None
                        finished += 1
                if act.slot_rids[i] is None and queue and can_refill:
                    rid, ckey, source, params = queue.popleft()
                    act.state, act.frontier = bspec.admit(
                        self.g, act.state, None, i, source, **act.params)
                    act.slot_rids[i] = (rid, ckey)
                    self._records[rid].slotted_at = self._clock()
                    act.slot_chunks[i] = 0
                    act.slot_steps0[i] = act.total_steps
            act.frontier = bspec.frontier_of(self.g, act.state)
        if not queue:
            self._queues.pop(act.group, None)
        if all(s is None for s in act.slot_rids):
            self._active = None
            if self.telemetry is not None:
                from ..obs.metrics import collect_resilience, collect_service
                collect_service(self.telemetry, self)
                collect_resilience(self.telemetry)
        return finished
