"""Markdown run reports and the AutoSwitch decision audit. PyTorch port
of ``repro.obs.report``.

``python -m repro_torch.obs.report TRACE.jsonl`` renders, from one JSONL
trace (:mod:`repro_torch.obs.export`):

* the **counter table**: reads, writes, atomics and locks per algorithm
  and direction mix, the paper's §5 presentation;
* the **decision audit**: per step, the predicted push cost, the
  predicted pull cost, the chosen direction and the measured wall time,
  with mispredicted steps flagged and a misprediction rate per run.

The audit asks "was the cost model right?" on one of two bases:

* ``wall``: when the stepwise loop timed steps of both directions, each
  direction gets a rate (the median of measured µs per predicted cost
  unit over its own steps); a step is flagged when the other
  direction's predicted cost at the other direction's rate is strictly
  below the step's measured time. Medians keep one straggler from
  recalibrating the run.
* ``predicted``: when wall times are missing or one-sided, a step is
  flagged when the unchosen direction's predicted cost is strictly
  below the chosen one's (the policy overrode the prediction:
  hysteresis, or a fixed policy).
"""

from __future__ import annotations

import argparse
import statistics
import sys
from typing import Any, Iterable

from .export import load_jsonl, validate_events

__all__ = ["decision_audit", "counter_table", "render_report", "main"]


# ---------------------------------------------------------------------------
# decision audit
# ---------------------------------------------------------------------------

def decision_audit(events: Iterable[dict[str, Any]],
                   run: int | None = None) -> dict[str, Any] | None:
    """Audit one run's direction decisions; None if it has no steps.

    ``events`` may be a whole trace (``run`` selects which solve; the
    default is the first run with step events) or just its step events.
    Returns ``{"run", "basis", "audited_steps", "flagged",
    "mispredict_rate", "steps": [per-step rows]}`` — the summary half
    is what ``api.solve`` emits as the ``audit`` event.
    """
    steps = [e for e in events if e.get("kind", "step") == "step"
             and "pushed" in e]
    if run is None:
        runs = sorted({e.get("run", 0) for e in steps})
        if not runs:
            return None
        run = runs[0]
    steps = [e for e in steps if e.get("run", run) == run]
    if not steps:
        return None

    timed_push = [e for e in steps if e.get("us") is not None
                  and e["pushed"]]
    timed_pull = [e for e in steps if e.get("us") is not None
                  and not e["pushed"]]

    def _rate(rows: list[dict], key: str) -> float:
        return statistics.median(
            e["us"] / max(e[key], 1.0) for e in rows)

    wall = bool(timed_push and timed_pull)
    if wall:
        rate = {True: _rate(timed_push, "predicted_push"),
                False: _rate(timed_pull, "predicted_pull")}

    rows = []
    flagged = 0
    for e in steps:
        pushed = bool(e["pushed"])
        pp, pl = float(e["predicted_push"]), float(e["predicted_pull"])
        chosen, other = (pp, pl) if pushed else (pl, pp)
        if wall and e.get("us") is not None:
            # counterfactual wall time of the unchosen direction
            alt_us = other * rate[not pushed]
            mis = alt_us < e["us"]
        else:
            mis = other < chosen
        flagged += mis
        rows.append({"step": int(e["step"]), "pushed": pushed,
                     "predicted_push": pp, "predicted_pull": pl,
                     "us": e.get("us"), "mispredict": bool(mis)})
    return {"run": int(run), "basis": "wall" if wall else "predicted",
            "audited_steps": len(rows), "flagged": int(flagged),
            "mispredict_rate": flagged / len(rows), "steps": rows}


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------

def _direction(run_ev: dict[str, Any]) -> str:
    steps, pushes = run_ev.get("steps", 0), run_ev.get("push_steps", 0)
    if steps == 0 or pushes == steps:
        return "push"
    if pushes == 0:
        return "pull"
    return f"mixed ({pushes}p/{steps - pushes}l)"


def counter_table(events: Iterable[dict[str, Any]]) -> list[str]:
    """Paper-style §5 table: one row per run, §4 counters as columns."""
    runs = [e for e in events if e.get("kind") == "run"]
    if not runs:
        return []
    lines = [
        "| run | algorithm | policy | backend | direction | steps "
        "| reads | writes | atomics | locks | msgs | wire B | weighted |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|---|"]
    for e in runs:
        c = e.get("counters", {})
        lines.append(
            f"| {e.get('run', 0)} | {e.get('algorithm', '?')} "
            f"| {e.get('policy', '?')} | {e.get('backend', '?')} "
            f"| {_direction(e)} | {e.get('steps', 0)} "
            f"| {int(c.get('reads', 0))} | {int(c.get('writes', 0))} "
            f"| {int(c.get('atomics', 0))} | {int(c.get('locks', 0))} "
            f"| {int(c.get('messages', 0))} "
            f"| {int(c.get('collective_bytes', 0))} "
            f"| {e.get('weighted_total', 0):.0f} |")
    return lines


def _audit_table(audit: dict[str, Any]) -> list[str]:
    lines = [
        "| step | chosen | predicted push | predicted pull | wall µs "
        "| mispredict |",
        "|---|---|---|---|---|---|"]
    for r in audit["steps"]:
        us = "—" if r["us"] is None else f"{r['us']:.1f}"
        lines.append(
            f"| {r['step']} | {'push' if r['pushed'] else 'pull'} "
            f"| {r['predicted_push']:.0f} | {r['predicted_pull']:.0f} "
            f"| {us} | {'⚠️' if r['mispredict'] else ''} |")
    return lines


def render_report(events: Iterable[dict[str, Any]],
                  title: str = "repro.obs run report") -> str:
    """Render a full markdown report from a trace's events."""
    events = list(events)
    out = [f"# {title}", ""]

    meta = next((e for e in events if e.get("kind") == "meta"), None)
    if meta:
        out.append(f"Schema `{meta.get('schema', '?')}` · "
                   f"{len(events)} events · "
                   f"{meta.get('dropped', 0)} dropped by the ring.")
        out.append("")

    table = counter_table(events)
    if table:
        out += ["## Counter totals (paper §5 style)", "",
                "Exact §4 model charges per run — the counters the "
                "paper's push-vs-pull argument is made in.", ""]
        out += table + [""]

    overflows = [e for e in events if e.get("kind") == "run"
                 and e.get("trace_overflow", 0) > 0]
    if overflows:
        out += ["## Trace overflow", ""]
        for e in overflows:
            out.append(f"- run {e.get('run', 0)} "
                       f"({e.get('algorithm', '?')}): "
                       f"{e['trace_overflow']} step(s) beyond the "
                       f"trace capacity were dropped — raise "
                       f"`trace=`/`_DEFAULT_TRACE_CAPACITY` to audit "
                       f"them.")
        out.append("")

    run_ids = sorted({e.get("run") for e in events
                      if e.get("kind") == "step"
                      and e.get("run") is not None})
    audits = [a for a in (decision_audit(events, run=r)
                          for r in run_ids) if a]
    if audits:
        out += ["## Decision audit", ""]
        by_run = {e.get("run"): e for e in events
                  if e.get("kind") == "run"}
        for a in audits:
            rv = by_run.get(a["run"], {})
            out.append(
                f"### run {a['run']} — {rv.get('algorithm', '?')} / "
                f"{rv.get('policy', '?')}")
            out.append("")
            out.append(
                f"{a['flagged']}/{a['audited_steps']} steps "
                f"mispredicted ({a['mispredict_rate']:.1%}, "
                f"{a['basis']} basis).")
            out.append("")
            out += _audit_table(a) + [""]

    res_counters = [e for e in events if e.get("kind") == "counter"
                    and str(e.get("name", "")).startswith("resilience.")]
    res_events = [e for e in events if e.get("kind") == "event"
                  and str(e.get("name", "")).startswith("resilience.")]
    if res_counters or res_events:
        out += ["## Resilience", ""]
        if res_counters:
            out += ["Fault-injection and recovery totals "
                    "(`resilience.*` namespace).", "",
                    "| counter | value |", "|---|---|"]
            for e in res_counters:
                out.append(f"| `{e.get('name', '?')}` | "
                           f"{e.get('value', 0):g} |")
            out.append("")
        if res_events:
            out += ["| event | details |", "|---|---|"]
            for e in res_events:
                detail = ", ".join(
                    f"{k}={v}" for k, v in sorted(e.items())
                    if k not in ("kind", "name", "ts_us", "pid", "tid"))
                out.append(f"| `{e.get('name', '?')}` | {detail} |")
            out.append("")

    counters = [e for e in events if e.get("kind") == "counter"]
    if counters:
        out += ["## Session counters", "", "| counter | value |",
                "|---|---|"]
        for e in counters:
            v = e.get("value", 0)
            out.append(f"| `{e.get('name', '?')}` | "
                       f"{v:g} |")
        out.append("")
    return "\n".join(out)


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Render a markdown report (counter table + "
                    "AutoSwitch decision audit) from a JSONL trace.")
    p.add_argument("trace", help="JSONL trace "
                                 "(repro_torch.obs.export.write_jsonl)")
    p.add_argument("--out", help="write markdown here (default: stdout)")
    p.add_argument("--no-validate", action="store_true",
                   help="skip schema validation before rendering")
    args = p.parse_args(argv)
    events = load_jsonl(args.trace)
    if not args.no_validate:
        errors = validate_events(events)
        if errors:
            print(f"{args.trace}: {len(errors)} schema violation(s)",
                  file=sys.stderr)
            for e in errors[:10]:
                print(f"  {e}", file=sys.stderr)
            return 1
    md = render_report(events)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(md + "\n")
    else:
        print(md)
    return 0


if __name__ == "__main__":  # pragma: no cover - exercised by subprocess
    sys.exit(main())
