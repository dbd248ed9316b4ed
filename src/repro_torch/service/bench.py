"""Service throughput/latency harness — queries/sec vs batch width vs
policy. PyTorch port of ``repro.service.bench``.

For each (algorithm, direction policy, batch width) cell on an RMAT
graph, measures the sequential baseline (a loop of single-source
``api.solve`` calls) against ``api.solve_batch`` over the same sources,
and reports queries/sec for both plus the batched run's weighted
counter total (the scalar the batch-aware AutoSwitch minimizes). Rows
are named ``service_*`` with the reference's payload keys; the payload
names the backend the sweep ran (``"cuda"`` by default, on the card).

Walls are host clocks around calls that end in
``torch.cuda.synchronize()`` on the card: the median of three, after a
warm-up call.

    PYTHONPATH=src python -m repro_torch.service.bench [--smoke] \\
        [--json PATH] [--backend cuda] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..graphs.structure import resolve_device

__all__ = ["ALGORITHMS", "POLICIES", "sweep", "main"]

ALGORITHMS = {
    "bfs": {},
    "ppr": {"tol": 1e-6},
    "sssp_delta": {"delta": 2.0},
}
POLICIES = ("push", "pull", "auto")


def _timeit(fn, device: torch.device, warmup: int = 1,
            iters: int = 3) -> float:
    """Median wall-clock microseconds of ``fn()``, synchronising the card
    after each call."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(warmup):
        fn()
        sync()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        sync()
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2] * 1e6


def _graph(smoke: bool, device):
    from ..graphs import kronecker
    scale = 7 if smoke else 10
    return "rmat", kronecker(scale, edge_factor=8, seed=7, weighted=True,
                             device=device)


def _sources(g, width: int) -> list[int]:
    """Distinct query vertices, highest out-degree first (hubs reach the
    bulk of the graph, so every query does real work)."""
    order = np.argsort(-g.out_deg.cpu().numpy(), kind="stable")
    return [int(order[i % g.n]) for i in range(width)]


def sweep(smoke: bool = False, widths=None, backend: str = "cuda",
          device=None):
    """Yield ``(name, us_per_call, payload)`` service throughput rows.

    ``us_per_call`` is the batched run's wall time (one call serves the
    whole batch); the payload carries both sides of the comparison.
    ``backend`` is an ``api`` backend name; the graph lives on
    ``device`` (the card unless given).
    """
    from .. import api

    dev = resolve_device(device)
    gname, g = _graph(smoke, dev)
    if widths is None:
        widths = (2, 8) if smoke else (1, 2, 4, 8, 16)
    for alg, kw in ALGORITHMS.items():
        keys = api.get_spec(alg).runtime_keys
        src_kw = keys[0] if keys else "source"
        for policy in POLICIES:
            for width in widths:
                sources = _sources(g, width)

                last = {}

                def seq():
                    out = []
                    for s in sources:
                        r = api.solve(g, alg, policy=policy, backend=backend,
                                      **{src_kw: s}, **kw)
                        out.append(r.cost.reads)
                    return out

                def bat():
                    r = api.solve_batch(g, alg, sources=sources,
                                        policy=policy, backend=backend, **kw)
                    last["r"] = r       # reused for the counter payload
                    return r.cost.reads

                us_seq = _timeit(seq, dev)
                us_bat = _timeit(bat, dev)
                r = last["r"]
                payload = {
                    "algorithm": alg, "graph": gname,
                    "n": int(g.n), "m": int(g.m),
                    "policy": policy, "backend": backend,
                    "batch": width, "queries": width,
                    "us_per_query_batched": round(us_bat / width, 1),
                    "us_per_query_sequential": round(us_seq / width, 1),
                    "qps_batched": round(width / (us_bat * 1e-6), 1),
                    "qps_sequential": round(width / (us_seq * 1e-6), 1),
                    "speedup": round(us_seq / us_bat, 3),
                    "steps": int(r.steps),
                    "push_steps": int(r.push_steps),
                    "weighted_total": float(r.cost.weighted_total()),
                }
                yield (f"service_{alg}_{gname}_{policy}_b{width}",
                       us_bat, payload)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="service layer throughput/latency harness")
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized graph and width set")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the rows as a JSON report")
    ap.add_argument("--backend", default="cuda")
    ap.add_argument("--device", default=None,
                    help="where the graph lives (default: the card)")
    args = ap.parse_args(argv)

    rows = []
    for name, us, payload in sweep(smoke=args.smoke, backend=args.backend,
                                   device=args.device):
        print(f"{name},{us:.1f},{json.dumps(payload)}", flush=True)
        rows.append({"name": name, "us_per_call": round(us, 1),
                     "derived": payload})
    report = {"rows": rows, "failures": []}
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
        print(f"json report: {args.json} ({len(rows)} rows)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
