"""Seeded, deterministic fault injection for chaos testing. PyTorch
port of ``repro.resilience.faults``; one plan JSON serves both packages.

A :class:`FaultPlan` names *where* faults fire (registered sites wired
into real seams: tuner probes, the tuner's disk cache, service chunks,
the result cache, the stepwise engine loop), *when* (a deterministic
per-site schedule: periodic ``every``/``start``/``count`` or a seeded
pseudo-random ``rate``), and *what* (transient or permanent, and the
error class raised, so a seam that recovers from ``OSError`` is probed
with an ``OSError``).

The injector is process-global and off by default: every seam calls
:func:`fault_point`, which is one module-global read and a ``None``
check when no plan is active. Activate a plan with :func:`install` or
the :func:`inject` context manager, or through ``$REPRO_FAULT_PLAN`` (a
named plan such as ``ci-default``, or a path to a plan JSON), read once
at import.

Determinism: a site's Nth invocation faults or not as a pure function
of (plan, site, N), the same function as the JAX package's, so hit N
faults in one package exactly when it faults in the other. Transient
schedules leave the next invocation clean, so retry loops recover.

Not every site has a seam here. ``pallas.pull`` and ``pallas.push``
guard the JAX package's kernel dispatch, whose only use is to give way
quietly from a failing kernel to the plain path; the port's
``CudaBackend`` raises instead, so those two sites never fire, by
design. They stay in :data:`SITES` so that every plan loads. The
sharded engine's ``shard.exchange.push`` and ``shard.exchange.pull``
wrap each exchange in :func:`resilient_call`, as the JAX package's do.

Recovery bookkeeping lives here too: seams report what they did about
a failure (:func:`note`), and :func:`resilience_stats` and
:func:`drain_events` hand it to ``repro_torch.obs`` as ``resilience.*``
counters and events.
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
import zlib
from collections import deque
from typing import Optional

from .errors import FaultInjected

__all__ = ["SITES", "FaultSpec", "FaultPlan", "FaultInjector",
           "fault_point", "install", "deactivate", "active_plan",
           "inject", "named_plans", "resilient_call", "note",
           "record_event", "resilience_stats", "drain_events",
           "clear_resilience_stats"]

# Every wired injection seam. fault_point() rejects unknown names so a
# renamed seam cannot silently orphan a plan.
SITES = (
    "pallas.pull",          # the JAX package's kernel dispatch (no seam)
    "pallas.push",          # the JAX package's kernel dispatch (no seam)
    "tune.probe",           # autotuner probe
    "tune.cache.load",      # tune.json disk read
    "tune.cache.write",     # tune.json disk write
    "shard.exchange.push",  # sharded push exchange (resilient_call)
    "shard.exchange.pull",  # sharded pull exchange (resilient_call)
    "service.chunk",        # QueryService chunk / unbatchable solve
    "service.cache.get",    # ResultCache lookup
    "service.cache.put",    # ResultCache store
    "engine.step",          # stepwise engine loop iteration
)

_ERROR_CLASSES = {
    "FaultInjected": FaultInjected,
    "RuntimeError": RuntimeError,
    "OSError": OSError,
    "ValueError": ValueError,
    "TimeoutError": TimeoutError,
}


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One site's fault schedule.

    kind:
        ``"transient"`` — scheduled hits fault, the rest succeed (a
        retry of the same operation lands on the next, clean hit).
        ``"permanent"`` — every hit from ``start`` on faults (the
        degraded path must carry the workload).
    Periodic schedule (default): 1-based hits ``start``, ``start +
    every``, ... fault, ``count`` consecutive hits at a time.
    Seeded schedule: ``rate > 0`` makes each hit fault iff a hash of
    (plan seed, site, hit) falls below ``rate`` — scattered but fully
    deterministic.
    error: raised class name (see keys of the module's error table);
    ``FaultInjected`` by default, or the exact class a seam's recovery
    handles (``OSError`` for the disk-cache sites).
    """
    site: str
    kind: str = "transient"
    every: int = 3
    start: int = 1
    count: int = 1
    rate: float = 0.0
    error: str = "FaultInjected"
    message: str = ""

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(
                f"unknown fault site {self.site!r}; registered: {SITES}")
        if self.kind not in ("transient", "permanent"):
            raise ValueError(
                f"kind must be 'transient' or 'permanent', "
                f"got {self.kind!r}")
        if self.error not in _ERROR_CLASSES:
            raise ValueError(
                f"unknown error class {self.error!r}; valid: "
                f"{sorted(_ERROR_CLASSES)}")
        if self.every < 1 or self.start < 1 or self.count < 1:
            raise ValueError("every/start/count must be >= 1")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A named, seeded set of :class:`FaultSpec` — the unit tests and
    CI select (``$REPRO_FAULT_PLAN``), serialize, and replay."""
    specs: tuple = ()
    name: str = "custom"
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "specs", tuple(self.specs))
        seen = set()
        for s in self.specs:
            if not isinstance(s, FaultSpec):
                raise TypeError(f"specs must be FaultSpec, got {s!r}")
            if s.site in seen:
                raise ValueError(f"duplicate spec for site {s.site!r}")
            seen.add(s.site)

    def to_json(self) -> str:
        return json.dumps(
            {"name": self.name, "seed": self.seed,
             "specs": [dataclasses.asdict(s) for s in self.specs]},
            indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        data = json.loads(text)
        return cls(name=data.get("name", "custom"),
                   seed=int(data.get("seed", 0)),
                   specs=tuple(FaultSpec(**s)
                               for s in data.get("specs", ())))


def named_plans() -> dict[str, FaultPlan]:
    """The built-in plans ``$REPRO_FAULT_PLAN`` can select by name."""
    recoverable = [s for s in SITES]
    return {
        # one transient fault on the first hit of every site, then every
        # 3rd: every recovery seam gets exercised, every retry lands on
        # a clean hit, and results must match the fault-free run
        "ci-default": FaultPlan(
            name="ci-default", seed=7,
            specs=tuple(FaultSpec(site=s, kind="transient", every=3,
                                  start=1,
                                  error=("OSError"
                                         if ".cache." in s
                                         else "FaultInjected"))
                        for s in recoverable)),
        # permanent kernel-dispatch failure: in the JAX package its
        # fallback ladder carries every solve; the port has no such
        # seam (a failing kernel raises), so this plan injects nothing
        "kernels-down": FaultPlan(
            name="kernels-down", seed=7,
            specs=(FaultSpec(site="pallas.pull", kind="permanent"),
                   FaultSpec(site="pallas.push", kind="permanent"))),
        # scattered transient faults at a seeded 20% rate across the
        # retryable sites — the soak-style schedule
        "soak": FaultPlan(
            name="soak", seed=1234,
            specs=tuple(FaultSpec(site=s, kind="transient", rate=0.2,
                                  error=("OSError" if ".cache." in s
                                         else "FaultInjected"))
                        for s in ("pallas.pull", "pallas.push",
                                  "tune.cache.load", "tune.cache.write",
                                  "service.cache.get",
                                  "service.cache.put"))),
    }


class FaultInjector:
    """Deterministic executor of one :class:`FaultPlan`.

    Thread-safe: per-site hit counters advance under a lock.
    ``check(site)`` either returns or raises the spec's error class;
    the decision depends only on the plan and the site's 1-based hit
    index.
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._by_site = {s.site: s for s in plan.specs}
        self._hits: dict[str, int] = {}
        self._injected: dict[str, int] = {}
        self._lock = threading.Lock()

    def _should_fault(self, spec: FaultSpec, hit: int) -> bool:
        if spec.kind == "permanent":
            return hit >= spec.start
        if spec.rate > 0.0:
            h = zlib.crc32(
                f"{self.plan.seed}:{spec.site}:{hit}".encode())
            return (h / 0xFFFFFFFF) < spec.rate
        if hit < spec.start:
            return False
        return (hit - spec.start) % spec.every < spec.count

    def check(self, site: str) -> None:
        if site not in SITES:
            raise ValueError(
                f"unknown fault site {site!r}; registered: {SITES}")
        spec = self._by_site.get(site)
        if spec is None:
            return
        with self._lock:
            hit = self._hits.get(site, 0) + 1
            self._hits[site] = hit
            fire = self._should_fault(spec, hit)
            if fire:
                self._injected[site] = self._injected.get(site, 0) + 1
        if fire:
            record_event("resilience.fault", site=site, hit=hit,
                         fault_kind=spec.kind)
            note(f"injected.{site}", emit=False)
            cls = _ERROR_CLASSES[spec.error]
            if cls is FaultInjected:
                raise FaultInjected(site, hit, spec.message)
            raise cls(spec.message
                      or f"injected {spec.error} at {site!r} "
                         f"(hit #{hit})")

    def stats(self) -> dict:
        with self._lock:
            return {"hits": dict(self._hits),
                    "injected": dict(self._injected)}


# -- the global seam -----------------------------------------------------
_ACTIVE: Optional[FaultInjector] = None


def fault_point(site: str) -> None:
    """The seam every wired subsystem calls. With no active plan this
    is one global read and a None check: no lock, no allocation."""
    inj = _ACTIVE
    if inj is not None:
        inj.check(site)


def install(plan: Optional[FaultPlan]) -> Optional[FaultInjector]:
    """Activate ``plan`` process-wide (None deactivates). Returns the
    new injector (or None)."""
    global _ACTIVE
    _ACTIVE = FaultInjector(plan) if plan is not None else None
    return _ACTIVE


def deactivate() -> None:
    install(None)


def active_plan() -> Optional[FaultPlan]:
    inj = _ACTIVE
    return inj.plan if inj is not None else None


class inject:
    """Context manager: run a block under ``plan``, restoring whatever
    injector (possibly an env-selected one) was active before.

        with inject(plan) as inj:
            api.solve(...)
        inj.stats()["injected"]
    """

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.injector: Optional[FaultInjector] = None

    def __enter__(self) -> FaultInjector:
        global _ACTIVE
        self._prev = _ACTIVE
        self.injector = FaultInjector(self.plan)
        _ACTIVE = self.injector
        return self.injector

    def __exit__(self, *exc):
        global _ACTIVE
        _ACTIVE = self._prev
        return False


def _install_from_env() -> None:
    """``$REPRO_FAULT_PLAN``: a built-in plan name or a path to a plan
    JSON. Read once at import; a bad value fails loudly (a chaos CI job
    silently running fault-free would defeat its purpose)."""
    sel = os.environ.get("REPRO_FAULT_PLAN", "").strip()
    if not sel:
        return
    plans = named_plans()
    if sel in plans:
        install(plans[sel])
        return
    if os.path.exists(sel):
        with open(sel) as f:
            install(FaultPlan.from_json(f.read()))
        return
    raise ValueError(
        f"REPRO_FAULT_PLAN={sel!r} is neither a built-in plan "
        f"({sorted(plans)}) nor a readable plan JSON path")


# -- recovery bookkeeping (counters + events for repro_torch.obs) --------
_LOCK = threading.Lock()
_RSTATS: dict[str, int] = {}
_EVENTS: deque = deque(maxlen=512)


def note(name: str, n: int = 1, emit: bool = True, **fields) -> None:
    """Count one recovery action (``retry.service.chunk``,
    ``timeout.tune.probe``, ``resume.engine.step``, ...) and, unless
    ``emit=False``, queue a ``resilience.<name>`` event for the next
    telemetry drain."""
    with _LOCK:
        _RSTATS[name] = _RSTATS.get(name, 0) + n
    if emit:
        record_event(f"resilience.{name}", **fields)


def record_event(name: str, **fields) -> None:
    with _LOCK:
        _EVENTS.append({"name": name, **fields})


def resilience_stats() -> dict[str, int]:
    """Merged snapshot: seam recovery counters plus the active
    injector's per-site injection counts (``injected.<site>``)."""
    with _LOCK:
        out = dict(_RSTATS)
    inj = _ACTIVE
    if inj is not None:
        for site, k in inj.stats()["injected"].items():
            out[f"injected.{site}"] = max(out.get(f"injected.{site}", 0),
                                          k)
    return out


def drain_events(limit: Optional[int] = None) -> list[dict]:
    """Pop queued resilience events (oldest first) for telemetry."""
    out = []
    with _LOCK:
        while _EVENTS and (limit is None or len(out) < limit):
            out.append(_EVENTS.popleft())
    return out


def clear_resilience_stats() -> None:
    with _LOCK:
        _RSTATS.clear()
        _EVENTS.clear()


def resilient_call(site: str, fn, retries: int = 2,
                   backoff_s: float = 0.0):
    """``fault_point(site)`` + ``fn()`` with bounded retries.

    The retry loop is the recovery seam for *stateless* call sites
    (functional chunk runs): each attempt
    advances the site's hit counter, so a transient schedule fails the
    scheduled hit and succeeds on the retry. Exhausted attempts
    re-raise the last error — the caller's degraded path (or the user)
    takes over.
    """
    import time as _time
    last = None
    for attempt in range(retries + 1):
        try:
            fault_point(site)
            return fn()
        except Exception as e:            # noqa: BLE001 — chaos seam
            last = e
            if attempt >= retries:
                raise
            note(f"retry.{site}", site=site, attempt=attempt + 1,
                 error=type(e).__name__)
            if backoff_s > 0.0:
                _time.sleep(backoff_s * (2 ** attempt))
    raise last  # pragma: no cover — unreachable


_install_from_env()
