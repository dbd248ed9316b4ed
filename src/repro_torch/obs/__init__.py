"""repro_torch.obs — telemetry: spans, counters, traces, reports.
PyTorch port of ``repro.obs``; the paper argues push against pull from
counters and times taken step by step, and this package is where the
port makes them visible:

  * :mod:`~repro_torch.obs.trace`: the :class:`Telemetry` handle, a
    span and timer API over a bounded event ring. With
    ``api.solve(..., telemetry=None)`` nothing of it runs.
  * :mod:`~repro_torch.obs.metrics`: the namespaced counter registry
    and the collectors of the engine's ``StepTrace`` and ``Cost``
    totals, the backend's dispatch counts, the tuner's probes, the
    ``QueryService``'s stats and the resilience layer's faults.
  * :mod:`~repro_torch.obs.export`: JSONL and Chrome-trace exporters
    and the event schema, with a validator.
  * :mod:`~repro_torch.obs.report`: ``python -m repro_torch.obs.report``
    renders a markdown report, the counter table and the AutoSwitch
    decision audit (predicted push and pull cost, chosen direction,
    measured step time, mispredicted steps flagged).

Typical use, on the card::

    from repro_torch.obs import Telemetry, write_chrome_trace, write_jsonl
    tel = Telemetry()
    r = api.solve(g, "bfs", root=0, policy="auto", backend="cuda",
                  telemetry=tel)
    write_jsonl(tel, "trace.jsonl")          # one event per line
    write_chrome_trace(tel, "trace.json")    # open in Perfetto
"""

from .export import (load_jsonl, validate_events, validate_trace_file,
                     write_chrome_trace, write_jsonl)
from .metrics import (MetricRegistry, collect_backend,
                      collect_resilience, collect_service,
                      collect_tuner, record_solve)
from .report import decision_audit, render_report
from .trace import Telemetry

__all__ = ["Telemetry", "MetricRegistry", "record_solve",
           "collect_backend", "collect_service", "collect_tuner",
           "collect_resilience", "write_jsonl", "write_chrome_trace",
           "load_jsonl", "validate_events", "validate_trace_file",
           "decision_audit", "render_report"]
