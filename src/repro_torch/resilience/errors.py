"""Named error types, so callers and tests match on the class instead
of parsing messages. A copy of ``repro.resilience.errors``:

  * :class:`FaultInjected` — raised by the injector at a fault site.
    Subclasses ``RuntimeError`` so unwired sites fail loudly; the
    recovery seams catch it beside the real error class they handle
    (``OSError`` at the disk-cache sites).
  * :class:`DivergenceError` — the engine's non-finite detector: a
    float leaf went NaN (or ±Inf in strict mode) at a known step.
  * :class:`ProbeTimeout` — a tuner probe exceeded its wall deadline.
  * :class:`DeadlineExceeded` — a query's ``deadline_ms`` elapsed
    before it finished (queued or mid-solve).
  * :class:`AdmissionError` — the service's bounded queue refused a
    new request (back-pressure, not failure).
  * :class:`SolveInterrupted` — a checkpointed stepwise solve died
    mid-loop; carries the last :attr:`checkpoint` so the caller can
    resume instead of restarting.
"""

from __future__ import annotations

__all__ = ["FaultInjected", "DivergenceError", "ProbeTimeout",
           "DeadlineExceeded", "AdmissionError", "SolveInterrupted"]


class FaultInjected(RuntimeError):
    """An injected fault from an active plan.

    Attributes:
        site: the fault-site name that fired.
        hit: 1-based invocation index of the site when it fired.
    """

    def __init__(self, site: str, hit: int, message: str = ""):
        self.site = site
        self.hit = hit
        super().__init__(
            message or f"injected fault at {site!r} (hit #{hit})")


class DivergenceError(RuntimeError):
    """A solve produced non-finite state, and was stopped instead of
    spending the rest of its step budget on poisoned values.

    Attributes:
        step: the engine step after which the check tripped.
        mode: ``"nan"`` (NaN only) or ``"all"`` (NaN or ±Inf).
    """

    def __init__(self, step: int, mode: str = "nan", detail: str = ""):
        self.step = step
        self.mode = mode
        super().__init__(
            f"non-finite state detected after step {step} "
            f"(check_finite={mode!r}){': ' + detail if detail else ''}")


class ProbeTimeout(RuntimeError):
    """A tuner probe passed its wall-clock deadline; the tuner falls
    back to the default candidate."""

    def __init__(self, kernel: str, deadline_s: float):
        self.kernel = kernel
        self.deadline_s = deadline_s
        super().__init__(
            f"tuner probe for {kernel!r} exceeded its {deadline_s:g}s "
            f"deadline")


class DeadlineExceeded(RuntimeError):
    """A query's ``deadline_ms`` elapsed before it could be served."""

    def __init__(self, rid: int, deadline_ms: float, waited_ms: float,
                 where: str = "queued"):
        self.rid = rid
        self.deadline_ms = deadline_ms
        self.waited_ms = waited_ms
        self.where = where
        super().__init__(
            f"query {rid} missed its {deadline_ms:g}ms deadline "
            f"({waited_ms:.1f}ms elapsed, {where})")


class AdmissionError(RuntimeError):
    """The service's bounded queue refused a new request — back-pressure
    the caller should respond to (shed load, retry later)."""

    def __init__(self, queued: int, max_queue: int):
        self.queued = queued
        self.max_queue = max_queue
        super().__init__(
            f"admission refused: {queued} requests already queued "
            f"(max_queue={max_queue})")


class SolveInterrupted(RuntimeError):
    """A checkpointed stepwise solve was interrupted mid-loop.

    Attributes:
        checkpoint: the last :class:`repro_torch.core.engine.Checkpoint`
            taken before the failure (None when the failure predates
            the first snapshot).
        step: the step index the loop was on when it died.

    ``__cause__`` carries the original error. ``api.solve`` catches
    this and resumes from the checkpoint (a bounded number of stalled
    resumes); other callers pass ``checkpoint`` back through
    ``run_stepwise(..., resume_from=...)``.
    """

    def __init__(self, step: int, checkpoint=None):
        self.step = step
        self.checkpoint = checkpoint
        at = (f"resumable from step {checkpoint.step}"
              if checkpoint is not None else "no checkpoint taken")
        super().__init__(
            f"stepwise solve interrupted at step {step} ({at})")
