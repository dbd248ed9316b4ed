"""JSONL and Chrome-trace exporters and the event schema. PyTorch port
of ``repro.obs.export``.

Two formats from the same event ring:

* **JSONL** (:func:`write_jsonl`): one event per line. Line 1 is a
  ``meta`` event with the schema id, the ring's drop count and
  ``epoch_ns``, the wall clock at ``ts_us`` 0 (the clock of a
  ``torch.profiler`` trace, so the ring can be laid over one); the tail
  appends one ``counter`` event per registry entry, so the file stands
  alone.
* **Chrome trace events** (:func:`write_chrome_trace`): the
  ``{"traceEvents": [...]}`` JSON that chrome://tracing and Perfetto
  load: spans and timed steps become ``"X"`` complete events, untimed
  steps ``"i"`` instants, the §4 counter totals a ``"C"`` track.

The JSONL contract is :data:`OBS_EVENT_SCHEMA`, this package's own copy
of the JAX package's (a test holds the two, and the committed
``benchmarks/obs_schema.json``, equal), so a trace from either package
validates against one contract. :func:`validate_events` checks it with
a hand-rolled draft-07 subset, no jsonschema dependency.
"""

from __future__ import annotations

import json
from typing import Any, Iterable

__all__ = ["OBS_EVENT_SCHEMA", "write_jsonl", "load_jsonl",
           "write_chrome_trace", "validate_events",
           "validate_trace_file"]

SCHEMA_ID = "repro.obs/v1"

#: Contract for one JSONL trace line. Top-level constraints apply to
#: every event; ``definitions[kind]`` adds the per-kind required keys.
OBS_EVENT_SCHEMA: dict[str, Any] = {
    "$schema": "http://json-schema.org/draft-07/schema#",
    "title": "repro.obs trace event (one JSONL line)",
    "type": "object",
    "required": ["ts_us", "kind"],
    "properties": {
        "ts_us": {"type": "number", "minimum": 0},
        "kind": {"type": "string",
                 "enum": ["meta", "span", "run", "step", "counter",
                          "event", "audit"]},
        "name": {"type": "string"},
        "run": {"type": "integer", "minimum": 0},
        # meta
        "schema": {"type": "string"},
        "dropped": {"type": "integer", "minimum": 0},
        # span
        "dur_us": {"type": "number", "minimum": 0},
        # run
        "algorithm": {"type": "string"},
        "policy": {"type": "string"},
        "backend": {"type": "string"},
        "steps": {"type": "integer", "minimum": 0},
        "push_steps": {"type": "integer", "minimum": 0},
        "pull_steps": {"type": "integer", "minimum": 0},
        "epochs": {"type": "integer", "minimum": 0},
        "converged": {"type": "boolean"},
        "trace_overflow": {"type": "integer", "minimum": 0},
        "counters": {"type": "object"},
        "weighted_total": {"type": "number"},
        # step (StepTrace columns)
        "step": {"type": "integer", "minimum": 0},
        "pushed": {"type": "boolean"},
        "frontier_vertices": {"type": "integer", "minimum": 0},
        "frontier_edges": {"type": "integer", "minimum": 0},
        "pull_touched_edges": {"type": "integer", "minimum": 0},
        "reads": {"type": "integer", "minimum": 0},
        "writes": {"type": "integer", "minimum": 0},
        "atomics": {"type": "integer", "minimum": 0},
        "locks": {"type": "integer", "minimum": 0},
        "predicted_push": {"type": "number", "minimum": 0},
        "predicted_pull": {"type": "number", "minimum": 0},
        "push_wire_bytes": {"type": "integer", "minimum": 0},
        "pull_wire_bytes": {"type": "integer", "minimum": 0},
        "us": {"type": "number", "minimum": 0},
        # counter
        "value": {"type": "number"},
        # audit (summary; per-step rows stay in the report)
        "basis": {"type": "string", "enum": ["wall", "predicted"]},
        "audited_steps": {"type": "integer", "minimum": 0},
        "flagged": {"type": "integer", "minimum": 0},
        "mispredict_rate": {"type": "number", "minimum": 0,
                            "maximum": 1},
    },
    "definitions": {
        "meta": {"type": "object", "required": ["schema"]},
        "span": {"type": "object", "required": ["name", "dur_us"]},
        "run": {"type": "object",
                "required": ["run", "algorithm", "policy", "backend",
                             "steps", "push_steps", "counters",
                             "weighted_total"]},
        "step": {"type": "object",
                 "required": ["run", "step", "pushed", "reads",
                              "writes", "predicted_push",
                              "predicted_pull"]},
        "counter": {"type": "object", "required": ["name", "value"]},
        "event": {"type": "object", "required": ["name"]},
        "audit": {"type": "object",
                  "required": ["run", "basis", "audited_steps",
                               "flagged", "mispredict_rate"]},
    },
}


# ---------------------------------------------------------------------------
# validation — a draft-07 subset
# ---------------------------------------------------------------------------

_TYPES = {"object": dict, "array": list, "string": str,
          "boolean": bool, "integer": int}


def _check(obj: Any, schema: dict, path: str, errors: list[str]) -> None:
    t = schema.get("type")
    if t == "number":
        if not isinstance(obj, (int, float)) or isinstance(obj, bool):
            errors.append(f"{path}: expected number, got {type(obj).__name__}")
            return
    elif t is not None:
        pytype = _TYPES[t]
        if not isinstance(obj, pytype) or (
                t == "integer" and isinstance(obj, bool)):
            errors.append(f"{path}: expected {t}, got {type(obj).__name__}")
            return
    if "enum" in schema and obj not in schema["enum"]:
        errors.append(f"{path}: {obj!r} not in {schema['enum']}")
    if isinstance(obj, bool):
        return
    if isinstance(obj, (int, float)):
        if "minimum" in schema and obj < schema["minimum"]:
            errors.append(f"{path}: {obj} < minimum {schema['minimum']}")
        if "maximum" in schema and obj > schema["maximum"]:
            errors.append(f"{path}: {obj} > maximum {schema['maximum']}")
    if isinstance(obj, dict):
        for req in schema.get("required", ()):
            if req not in obj:
                errors.append(f"{path}: missing required key {req!r}")
        props = schema.get("properties", {})
        for k, sub in props.items():
            if k in obj:
                _check(obj[k], sub, f"{path}.{k}", errors)


def validate_events(events: Iterable[dict[str, Any]],
                    schema: dict[str, Any] | None = None) -> list[str]:
    """Check events against the contract; returns a list of errors
    (empty = valid). Each event is checked against the top-level
    schema, then against its kind's ``definitions`` entry."""
    schema = schema or OBS_EVENT_SCHEMA
    defs = schema.get("definitions", {})
    errors: list[str] = []
    for i, ev in enumerate(events):
        path = f"event[{i}]"
        if not isinstance(ev, dict):
            errors.append(f"{path}: expected object, got "
                          f"{type(ev).__name__}")
            continue
        _check(ev, schema, path, errors)
        kind = ev.get("kind")
        if isinstance(kind, str) and kind in defs:
            _check(ev, defs[kind], f"{path}<{kind}>", errors)
    return errors


def validate_trace_file(path, schema: dict[str, Any] | None = None) -> int:
    """Validate a JSONL trace file; returns the event count, raises
    ``ValueError`` listing every violation otherwise."""
    events = load_jsonl(path)
    errors = validate_events(events, schema)
    if errors:
        raise ValueError(f"{path}: {len(errors)} schema violation(s):\n  "
                         + "\n  ".join(errors[:20]))
    return len(events)


# ---------------------------------------------------------------------------
# JSONL
# ---------------------------------------------------------------------------

def _final_events(tel) -> list[dict[str, Any]]:
    """meta header + ring + counter snapshot, ready to serialize."""
    now = round(tel.now_us(), 3)
    out: list[dict[str, Any]] = [
        {"ts_us": 0.0, "kind": "meta", "schema": SCHEMA_ID,
         "dropped": tel.dropped, "epoch_ns": tel.epoch_ns}]
    out.extend(tel.events)
    for name, value in tel.counters.as_dict().items():
        out.append({"ts_us": now, "kind": "counter", "name": name,
                    "value": value})
    return out


def write_jsonl(tel, path) -> int:
    """Write a handle's events as JSONL; returns lines written."""
    events = _final_events(tel)
    with open(path, "w") as fh:
        for ev in events:
            fh.write(json.dumps(ev, sort_keys=True) + "\n")
    return len(events)


def load_jsonl(path) -> list[dict[str, Any]]:
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


# ---------------------------------------------------------------------------
# Chrome trace events (Perfetto-loadable)
# ---------------------------------------------------------------------------

_SKIP_ARGS = {"ts_us", "kind", "name", "dur_us", "counters"}


def _args(ev: dict[str, Any]) -> dict[str, Any]:
    return {k: v for k, v in ev.items() if k not in _SKIP_ARGS}


def write_chrome_trace(tel_or_events, path) -> int:
    """Render events as Chrome trace-event JSON; returns event count.

    Load the output in chrome://tracing or Perfetto: spans and
    wall-timed steps appear as nested slices on one track per run,
    counter totals as a value track. Accepts a
    :class:`~repro_torch.obs.trace.Telemetry` handle or an event list
    (e.g. from :func:`load_jsonl`).
    """
    events = (_final_events(tel_or_events)
              if hasattr(tel_or_events, "events") else list(tel_or_events))
    pid = 1
    head: dict[str, Any] = {"name": "repro_torch"}
    meta = next((ev for ev in events if ev.get("kind") == "meta"), {})
    if "epoch_ns" in meta:          # the ring's wall-clock anchor
        head["epoch_ns"] = meta["epoch_ns"]
    out: list[dict[str, Any]] = [
        {"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
         "args": head}]
    for ev in events:
        kind, ts = ev.get("kind"), ev.get("ts_us", 0.0)
        tid = int(ev.get("run", -1)) + 1  # run n -> track n+1, misc on 0
        if kind == "span":
            out.append({"ph": "X", "name": ev.get("name", "span"),
                        "cat": "span", "ts": ts,
                        "dur": ev.get("dur_us", 0.0), "pid": pid,
                        "tid": tid, "args": _args(ev)})
        elif kind == "step":
            name = (f"step {ev.get('step', '?')} "
                    f"[{'push' if ev.get('pushed') else 'pull'}]")
            base = {"name": name, "cat": "step", "ts": ts, "pid": pid,
                    "tid": tid, "args": _args(ev)}
            if "us" in ev:
                out.append({"ph": "X", "dur": ev["us"], **base})
            else:
                out.append({"ph": "i", "s": "t", **base})
        elif kind == "run":
            counters = ev.get("counters", {})
            out.append({"ph": "C", "name": "engine.cost", "ts": ts,
                        "pid": pid, "tid": tid,
                        "args": {k: counters[k]
                                 for k in ("reads", "writes", "atomics",
                                           "locks") if k in counters}})
        elif kind in ("event", "audit", "counter"):
            out.append({"ph": "i", "s": "t",
                        "name": ev.get("name", kind), "cat": kind,
                        "ts": ts, "pid": pid, "tid": tid,
                        "args": _args(ev)})
    with open(path, "w") as fh:
        json.dump({"traceEvents": out, "displayTimeUnit": "ms"}, fh)
    return len(out)
