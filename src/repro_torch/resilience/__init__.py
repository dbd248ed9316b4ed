"""repro_torch.resilience — deterministic fault injection and recovery.
PyTorch port of ``repro.resilience``:

  * :mod:`~repro_torch.resilience.faults` — the seeded
    :class:`FaultPlan`/:class:`FaultInjector` and the :func:`fault_point`
    seam wired into the tuner, serving, the caches and the stepwise
    engine loop; plus the ``resilience.*`` counter and event
    bookkeeping ``repro_torch.obs`` drains.
  * :mod:`~repro_torch.resilience.errors` — structured failure types
    (:class:`DivergenceError`, :class:`DeadlineExceeded`,
    :class:`AdmissionError`, :class:`SolveInterrupted`, ...).

The JAX package's ``CircuitBreaker`` is not ported, by design: its only
use is the fallback from a failing Pallas kernel to the plain path, and
the port's ``CudaBackend`` raises when a kernel fails.
"""

from .errors import (AdmissionError, DeadlineExceeded, DivergenceError,
                     FaultInjected, ProbeTimeout, SolveInterrupted)
from .faults import (SITES, FaultInjector, FaultPlan, FaultSpec,
                     active_plan, clear_resilience_stats, deactivate,
                     drain_events, fault_point, inject, install,
                     named_plans, note, record_event, resilience_stats,
                     resilient_call)

__all__ = [
    "SITES", "FaultSpec", "FaultPlan", "FaultInjector", "fault_point",
    "install", "deactivate", "active_plan", "inject", "named_plans",
    "resilient_call", "note", "record_event", "resilience_stats",
    "drain_events", "clear_resilience_stats",
    "FaultInjected", "DivergenceError", "ProbeTimeout",
    "DeadlineExceeded", "AdmissionError", "SolveInterrupted",
]
