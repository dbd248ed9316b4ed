"""Run one benchmark cell of ``repro_torch`` once, on the card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Run from the root of a checkout. The cells, their metrics and bounds are
in ``BENCHMARK.json``; ``perfbench/harness.py`` says what a run does.
The last line on standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
also ``breakdown``; ``checks`` last: each compared number beside its
limit), and the last lines on standard error repeat the compared
numbers. A traced run (``--trace 1``) profiles a window of at most
``harness.TRACE_WINDOW_S`` seconds and reports the per-layer metrics.
Without a CUDA card, with fewer cards than the cell asks for,
or with JAX or the JAX package loaded once the window has closed, it
prints no result and exits with 1.

The tuner's cache (``REPRO_CACHE_DIR``) and any Triton or extension
build cache are pinned to ``perfbench/.cache/`` in the checkout; the
program builds its kernel libraries into ``build/repro_torch/`` there.
So only the first run of a cell in a checkout builds and probes.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = HERE / ".cache"


def _environment() -> None:
    for var, sub in (("REPRO_CACHE_DIR", "repro"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(CACHE / sub)
    (CACHE / "repro").mkdir(parents=True, exist_ok=True)
    # the script's own folder is no package root: its modules would
    # shadow the standard library's
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    from perfbench import harness
    bench = harness.load_benchmark()
    plan = harness.cell_plan(bench, args.workload)
    import torch
    need = int(plan["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: the cell needs {need} CUDA card(s), this "
              f"machine has {have}", file=sys.stderr)
        return 1
    result, lines = harness.run_cell(
        args.workload, args.seed, args.seconds, bool(args.trace),
        bench=bench, t_start=T_START)
    bad = harness.forbidden_modules(sys.modules)
    if bad:
        print(f"perfbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 1
    sys.stderr.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
