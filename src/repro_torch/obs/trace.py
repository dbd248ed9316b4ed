"""The program's ranges, the span and timer API and the bounded event
ring. PyTorch port of ``repro.obs.trace``.

1. **One flag read when no profiler records.** :func:`region` marks a
   layer boundary of the port (``repro.engine.step``,
   ``repro.backend.pull``, ...). While a ``torch.profiler`` records, it
   opens a range there, so the range lands in the same kineto trace as
   the kernels and shares the device trace's clock. Otherwise it returns
   a shared ``nullcontext`` after one read of the profiler's enabled
   flag. It never synchronizes, never reads a device value and needs no
   handle. A :class:`Telemetry` handle is what the caller passes for
   more: ``api.solve(..., telemetry=None)`` runs ``PushPullEngine.run``
   unchanged, with no event ring.
2. **Times execution, not launches.** PyTorch returns before the card
   finishes, so a host clock read right after a launch times the
   launch. Step times come from the engine's
   :meth:`~repro_torch.core.engine.PushPullEngine.run_stepwise`, which
   ends each step with ``torch.cuda.synchronize``; a :meth:`Telemetry.span`
   given the ``device`` it wraps work on ends with the same. The exact
   §4 counters ride the engine's
   :class:`~repro_torch.core.cost_model.StepTrace` and are merged in by
   :func:`repro_torch.obs.metrics.record_solve`.
3. **Bounded.** The ring holds at most ``capacity`` events; later ones
   are dropped and counted in :attr:`Telemetry.dropped`.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Iterator

import torch
from torch.autograd import profiler as _profiler

from .metrics import MetricRegistry

__all__ = ["Telemetry", "region"]

#: The prefix of every range the program opens in a profiler trace.
RANGE_PREFIX = "repro."
_NO_RANGE = contextlib.nullcontext()


def region(name: str):
    """A context manager around one layer boundary of the port: a range
    named ``"repro." + name`` while a profiler records, else a shared
    ``nullcontext``.

        with region("engine.step"):
            st = self._step(g, ph, st)

    The range is a function-scope ``RecordFunction``
    (``_RecordFunctionFast``), which the profiler records as a host
    operation. A ``torch.profiler.record_function`` range would be a user
    annotation, which kineto mirrors on the device's timeline, and a
    reader of kineto events without ``activity_type`` (torch 2.11) takes
    that mirror for a kernel.
    """
    if not _profiler._is_profiler_enabled:
        return _NO_RANGE
    return torch._C._profiler._RecordFunctionFast(RANGE_PREFIX + name)


class Telemetry:
    """A per-session telemetry handle: event ring and counter registry.

    Pass one to ``api.solve``, ``api.solve_batch`` or ``QueryService``
    and every layer appends structured events to it:

        >>> tel = Telemetry()
        >>> r = api.solve(g, "bfs", root=0, policy="auto",
        ...               backend="cuda", telemetry=tel)  # doctest: +SKIP
        >>> [e["kind"] for e in tel.events][:3]         # doctest: +SKIP
        ['step', 'step', 'step']

    Events are plain dicts with at least ``ts_us`` (microseconds since
    this handle's creation) and ``kind`` (``meta | span | run | step |
    counter | event | audit``; ``benchmarks/obs_schema.json`` is the
    contract). ``counters`` is a
    :class:`~repro_torch.obs.metrics.MetricRegistry` of namespaced
    totals across runs; the exporters append its snapshot as
    ``counter`` events.
    """

    def __init__(self, *, capacity: int = 65536,
                 step_timing: bool = True) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        #: When True (default), ``api.solve`` runs flat programs through
        #: the engine's stepwise loop so ``step`` events carry measured
        #: ``us`` (the decision audit's wall basis). False keeps
        #: ``run`` and gives predicted-basis audits only.
        self.step_timing = bool(step_timing)
        self.events: list[dict[str, Any]] = []
        self.dropped = 0
        self.counters = MetricRegistry()
        self._runs = 0
        self._t0 = time.perf_counter()
        #: The wall clock (``time.time_ns``) at the moment ``ts_us`` is 0:
        #: ``epoch_ns + 1000 * ts_us`` puts an event on the clock a
        #: ``torch.profiler`` trace stamps its events with.
        self.epoch_ns = time.time_ns()

    # -- clock -----------------------------------------------------------
    def now_us(self) -> float:
        """Microseconds since this handle was created (host clock)."""
        return (time.perf_counter() - self._t0) * 1e6

    # -- event ring ------------------------------------------------------
    def emit(self, kind: str, name: str = "", *,
             ts_us: float | None = None, **fields: Any) -> None:
        """Append one event; drop (and count) once the ring is full."""
        if len(self.events) >= self.capacity:
            self.dropped += 1
            return
        ev: dict[str, Any] = {
            "ts_us": round(self.now_us() if ts_us is None else ts_us, 3),
            "kind": kind}
        if name:
            ev["name"] = name
        ev.update(fields)
        self.events.append(ev)

    def new_run(self) -> int:
        """Allocate the next run id (events of one solve share it)."""
        run = self._runs
        self._runs = run + 1
        return run

    @property
    def last_run(self) -> int | None:
        """Id of the most recently started run, or None before any."""
        return self._runs - 1 if self._runs else None

    def events_for(self, run: int, kind: str | None = None
                   ) -> list[dict[str, Any]]:
        """All events of one run (optionally one kind), in emit order."""
        return [e for e in self.events if e.get("run") == run
                and (kind is None or e["kind"] == kind)]

    # -- spans -----------------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str, *, device=None,
             **fields: Any) -> Iterator[dict[str, Any]]:
        """Time a region; emits one ``span`` event on exit.

        The yielded dict is live — set keys on it to attach results::

            with tel.span("solve", device=g.device) as sp:
                r = engine.run(...)
                sp["steps"] = r.steps

        ``ts_us`` is the span's start and ``dur_us`` its wall time, the
        pair the Chrome ``"X"`` exporter needs. With a CUDA ``device``
        the span ends with ``torch.cuda.synchronize(device)``, so it
        times the work it launched, not the launches. The span is also a
        :func:`region` of the same name.
        """
        with region(name):
            t0 = self.now_us()
            sp = dict(fields)
            try:
                yield sp
            finally:
                if (device is not None
                        and torch.device(device).type == "cuda"):
                    torch.cuda.synchronize(device)
                sp.setdefault("dur_us", round(self.now_us() - t0, 3))
                self.emit("span", name, ts_us=t0, **sp)
