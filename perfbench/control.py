"""Readings that set a cell's correctness limits, at the cell's own size.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 1,2,3 [--seconds 3] [--out FILE]

One set-up, then for each seed a short window of the cell's own traffic
and load, and the numbers its ``limits`` compare, read on the sampled
answers against the reference; for each control seed also the same
numbers with the reference's control (``reference/<algorithm>.py``:
``control``) put in the program's place on the same sources. The lower
reading of a limit is the largest the program gives, the upper the
smallest the control gives. Each reading is one JSON line on standard
output (and in ``--out``). The benchmark's own runs never run this.
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
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    _environment()
    import torch

    from perfbench import harness
    plan = harness.cell_plan(harness.load_benchmark(), args.workload)
    config = harness.load_json("configs", plan["cell"]["config"])
    traffic = harness.load_json("traffic", plan["cell"]["traffic"])
    dev = torch.device("cuda")
    ctx = harness.setup(config, traffic, dev)
    edges = harness.reference_edges(ctx.edges, dev)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    out = open(args.out, "a") if args.out else None
    for seed in seeds:
        run = harness.Run(workload=args.workload, config=config,
                          traffic=traffic, seed=seed, seconds=args.seconds)
        items = harness.measure(ctx, traffic, run, False,
                                time.perf_counter())
        rows = [("program", harness.judge(traffic, edges, items))]
        if seed in controls:
            rows.append(("control", harness.judge(traffic, edges, items,
                                                  control=True)))
        for kind, readings in rows:
            line = json.dumps({"workload": args.workload, "seed": seed,
                               "kind": kind, "answers": len(items),
                               "completed": run.completed,
                               "failed": run.failed,
                               "readings": readings,
                               "limits": traffic["limits"]})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
