"""Named error types, so callers and tests match on the class instead
of parsing messages. A copy of three classes of
``repro.resilience.errors``:

  * :class:`ProbeTimeout` — a tuner probe exceeded its wall deadline.
  * :class:`DeadlineExceeded` — a query's ``deadline_ms`` elapsed
    before it finished (queued or mid-solve).
  * :class:`AdmissionError` — the service's bounded queue refused a
    new request (back-pressure, not failure).
"""

from __future__ import annotations

__all__ = ["ProbeTimeout", "DeadlineExceeded", "AdmissionError"]


class ProbeTimeout(RuntimeError):
    """A tuner probe blew its wall-clock deadline."""

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
