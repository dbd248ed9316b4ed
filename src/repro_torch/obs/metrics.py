"""The namespaced counter registry and its collectors. PyTorch port of
``repro.obs.metrics``.

One schema for the numbers every layer computes:

    engine.cost.reads / writes / atomics / locks / messages /
        collective_bytes / barriers / iterations   — §4 model totals
    engine.runs / steps / push_steps / pull_steps / trace_overflow
    backend.CudaBackend.kernel_pull / kernel_push / kernel_pull_frontier
        / skip_empty_pull / fallback_pull / fallback_push / pull_edges
    tuner.mem_hits / disk_hits / misses / probes / writes /
        write_errors / probe_retries / probe_failures /
        probe_timeouts / probe_degraded
    service.coalesced / batches_started / chunks_run / force_retired /
        chunk_retries / deadline_expired / admission_rejected /
        cache_errors
    service.cache.size / capacity / hits / misses
    resilience.injected.<site> / retry.* / timeout.* / degraded.* /
        fallback.* / resume.*   — injected faults and what each
        recovery seam did about them

Counters are monotone totals over a handle's life; per-run values live
in the ``run`` and ``step`` events. :func:`record_solve` folds one
``EngineResult`` into a handle: one ``step`` event per traced step (the
``StepTrace`` columns, with the predicted push and pull prices) and one
``run`` event, the rows the decision audit and the counter table are
rendered from.
"""

from __future__ import annotations

from typing import Any, Mapping

__all__ = ["MetricRegistry", "record_solve", "collect_backend",
           "collect_tuner", "collect_service", "collect_resilience"]


class MetricRegistry:
    """A flat ``dotted.name -> number`` accumulator: ``add`` accumulates
    (counters), ``put`` overwrites (gauges), ``as_dict`` snapshots in
    sorted-name order so exports are stable."""

    def __init__(self) -> None:
        self._vals: dict[str, float] = {}

    def add(self, name: str, value: float = 1) -> None:
        self._vals[name] = self._vals.get(name, 0) + value

    def put(self, name: str, value: float) -> None:
        self._vals[name] = value

    def get(self, name: str, default: float = 0) -> float:
        return self._vals.get(name, default)

    def as_dict(self) -> dict[str, float]:
        return {k: self._vals[k] for k in sorted(self._vals)}

    def add_all(self, prefix: str, values: Mapping[str, Any]) -> None:
        for k, v in values.items():
            self.add(f"{prefix}.{k}", float(v))

    def __len__(self) -> int:
        return len(self._vals)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"MetricRegistry({self._vals!r})"


def _residual_l1(xstate: Any) -> float | None:
    """Total |error feedback| left in a compression exchange state."""
    from ..models.common import tree_leaves
    leaves = [x for x in tree_leaves(xstate) if x.dtype.is_floating_point]
    if not leaves:
        return None
    return float(sum(float(x.abs().sum()) for x in leaves))


def record_solve(tel, *, algorithm: str, policy, backend, result,
                 run: int | None = None,
                 step_times: Mapping[int, float] | None = None,
                 t0_us: float | None = None,
                 converged: bool | None = None) -> int:
    """Fold one engine result into ``tel``; returns the run id.

    Emits one ``step`` event per traced step (counter deltas, the
    predictor's push and pull prices, wire-byte charges and, when the
    stepwise loop timed them, the measured ``us``), then one ``run``
    event with the §4 totals, and adds them to ``tel.counters``.
    ``step_times`` maps step index to host microseconds from
    ``PushPullEngine.run_stepwise``; ``t0_us`` anchors the step timeline
    for the Chrome exporter (default: now).
    """
    if run is None:
        run = tel.new_run()
    steps = int(result.steps)
    pushes = int(result.push_steps)
    cost = result.cost.as_dict()
    pol = policy if isinstance(policy, str) else getattr(
        policy, "name", type(policy).__name__)
    bname = getattr(backend, "name", None) or type(backend).__name__

    overflow = 0
    cursor = tel.now_us() if t0_us is None else t0_us
    trace = getattr(result, "trace", None)
    if trace is not None:
        rows = trace.as_dict(steps)
        overflow = int(rows.pop("overflow", 0))
        # trace slot i holds step i, so the row index is the step number
        for i in range(len(rows.get("pushed", ()))):
            us = None if step_times is None else step_times.get(i)
            ev = {"step": i}
            ev.update((key, rows[key][i]) for key in rows)
            if us is not None:
                ev["us"] = round(us, 3)
            tel.emit("step", run=run, ts_us=cursor, **ev)
            cursor += us or 0.0

    tel.emit("run", run=run, algorithm=algorithm, policy=pol,
             backend=bname, steps=steps, push_steps=pushes,
             pull_steps=steps - pushes, epochs=int(result.epochs),
             converged=bool(result.converged if converged is None
                            else converged),
             trace_overflow=overflow, counters=cost,
             weighted_total=float(result.cost.weighted_total()))

    c = tel.counters
    c.add_all("engine.cost", cost)
    c.add("engine.runs")
    c.add("engine.steps", steps)
    c.add("engine.push_steps", pushes)
    c.add("engine.pull_steps", steps - pushes)
    c.add("engine.trace_overflow", overflow)

    residual = _residual_l1(getattr(result, "xstate", ()))
    if residual is not None:
        c.add("backend.shard.compression_residual_l1", residual)
    collect_backend(tel, backend)
    return run


def collect_backend(tel, backend) -> dict[str, float]:
    """Snapshot a backend's
    :meth:`~repro_torch.core.backend.ExchangeBackend.telemetry_counters`
    into the registry as ``backend.<name>.*`` gauges (the backend
    already keeps totals, so repeated calls never double-count)."""
    if backend is None:
        return {}
    counters = getattr(backend, "telemetry_counters", lambda: {})()
    bname = getattr(backend, "name", None) or type(backend).__name__
    for k, v in counters.items():
        tel.counters.put(f"backend.{bname}.{k}", float(v))
    return counters


def collect_tuner(tel) -> dict[str, int]:
    """Fold the tuner's process-wide probe and cache outcomes into
    ``tel`` as ``tuner.*`` gauges."""
    from ..kernels import tune
    stats = tune.tune_stats()
    for k, v in stats.items():
        tel.counters.put(f"tuner.{k}", float(v))
    return stats


def collect_resilience(tel) -> dict[str, float]:
    """Fold the resilience layer into ``tel``: the process-wide fault
    and recovery counters become ``resilience.*`` gauges, and every
    queued fault, retry, timeout or resume event drains into the ring
    (kind ``event``, names such as ``resilience.fault``)."""
    from ..resilience import drain_events, resilience_stats
    stats = resilience_stats()
    for k, v in stats.items():
        tel.counters.put(f"resilience.{k}", float(v))
    for ev in drain_events():
        fields = dict(ev)
        name = fields.pop("name", "resilience.event")
        # "kind" and "ts_us" are the envelope's own keys: rename any
        # payload field that would collide with emit()'s signature
        for reserved in ("kind", "ts_us"):
            if reserved in fields:
                fields[f"f_{reserved}"] = fields.pop(reserved)
        tel.emit("event", name, **fields)
    return stats


def collect_service(tel, service) -> dict[str, Any]:
    """Fold a ``QueryService``'s scheduler and cache stats into ``tel``
    as ``service.*`` gauges."""
    stats = service.stats()
    for k, v in stats.items():
        if isinstance(v, Mapping):
            for kk, vv in v.items():
                tel.counters.put(f"service.{k}.{kk}", float(vv))
        elif isinstance(v, (int, float)):
            tel.counters.put(f"service.{k}", float(v))
    return stats
