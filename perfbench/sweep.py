"""Find the highest rate an open-loop cell's service sustains.

    python3 perfbench/sweep.py --workload <cell> --rates 60,80,100 \\
        [--seconds 15] [--seed N] [--out FILE]

One set-up, then for each offered rate the cell's own open loop (a fresh
service each time): one JSON line with the rate offered and served, the
median and 95th-percentile latency, the requests still outstanding when
arrivals stopped and how long the drain took. A rate is sustained when
the service completes what it is offered within the window and the
backlog does not grow. The cell's ``rate_per_s`` is set once, from such
a sweep, well below the highest sustained rate: the service is paced by
the host, a slower host sustains less, and a tail near capacity swings
with the host's speed. The benchmark's own runs never sweep.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from perfbench.run import _environment  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--seed", type=int, default=12345)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    _environment()
    import torch

    from perfbench import harness, reduce
    plan = harness.cell_plan(harness.load_benchmark(), args.workload)
    config = harness.load_json("configs", plan["cell"]["config"])
    traffic = harness.load_json("traffic", plan["cell"]["traffic"])
    ctx = harness.setup(config, traffic, torch.device("cuda"))
    out = open(args.out, "a") if args.out else None
    for rate in (float(r) for r in args.rates.split(",") if r):
        mix = dict(traffic, rate_per_s=rate)
        run = harness.Run(workload=args.workload, config=config,
                          traffic=mix, seed=args.seed, seconds=args.seconds)
        harness.measure(ctx, mix, run, False, time.perf_counter())
        lat = run.latencies_ms
        line = json.dumps({
            "workload": args.workload, "offered_per_s": rate,
            "requests": run.attempted, "failed": run.failed,
            "served_per_s": reduce.served_rate(run),
            "p50_ms": reduce.percentile(lat, 50) if lat else None,
            "p95_ms": reduce.latency_p95_ms(run),
            "backlog_at_end": run.backlog_end,
            "drain_s": run.window_s - args.seconds,
            "submit_lag_p95_ms": reduce.submit_lag_p95_ms(run)})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
