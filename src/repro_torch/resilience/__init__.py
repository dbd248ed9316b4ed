"""Structured errors of the serving path (PyTorch port of the part of
``repro.resilience`` the service needs; fault injection, the breaker and
retries are not ported yet)."""

from .errors import AdmissionError, DeadlineExceeded, ProbeTimeout

__all__ = ["AdmissionError", "DeadlineExceeded", "ProbeTimeout"]
