"""Where a solve's time goes on the card: wall time against device time.

    PYTHONPATH=src python -m repro_torch.profile_solve

Builds the two graphs ``chip_smoke.py`` runs (the full CA-road stand-in
and Kronecker scale 16) and, for each (graph, algorithm, policy), runs
the solve through the CUDA backend three times: once to warm up (bin
plans, tuner probes, library loads), once for the wall time, and once
under ``torch.profiler`` with CPU and CUDA activities. From the profiled
run it prints one JSON line: the wall times, the summed device time of
every kernel and copy on the card, the device's busy share of the
profiled wall, device operations per step, and the five names that took
the most device time. Needs a CUDA device; where the profiler records no
device activity it says so (``"device_events": 0``) instead of a share.
"""

from __future__ import annotations

import collections
import json
import sys
import time

import torch

from . import api
from .graphs import kronecker, standin

RUNS = {
    "rca": (("bfs", "gs"), ("bfs", "pull"), ("sssp_delta", "push"),
            ("sssp_delta", "pull"), ("pagerank", "pull"),
            ("pagerank", "push")),
    "kron16": (("pagerank", "pull"), ("pagerank", "push"), ("bfs", "auto"),
               ("sssp_delta", "push")),
}


def _kwargs(alg: str, gname: str) -> dict:
    return {"pagerank": {"iters": 20}, "bfs": {"root": 0},
            "sssp_delta": {"source": 0,
                           "delta": 8.0 if gname == "rca" else 2.0}}[alg]


def _solve(g, alg: str, policy: str, kw: dict):
    t0 = time.perf_counter()
    r = api.solve(g, alg, policy=policy, backend="cuda", **kw)
    torch.cuda.synchronize()
    return r, (time.perf_counter() - t0) * 1e3


def profile_run(gname: str, g, alg: str, policy: str) -> dict:
    kw = _kwargs(alg, gname)
    _solve(g, alg, policy, kw)                      # warm-up
    r, wall_ms = _solve(g, alg, policy, kw)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, prof_wall_ms = _solve(g, alg, policy, kw)
    per_name = collections.Counter()
    count = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per_name[e.name] += e.time_range.elapsed_us()
            count += 1
    device_ms = sum(per_name.values()) / 1e3
    return {"graph": gname, "alg": alg, "policy": policy, "steps": r.steps,
            "push_steps": r.push_steps, "wall_ms": wall_ms,
            "profiled_wall_ms": prof_wall_ms, "device_events": count,
            "device_ms": device_ms if count else None,
            "device_busy_share": (device_ms / prof_wall_ms if count
                                  else None),
            "device_ops_per_step": count / max(r.steps, 1),
            "top_device_ms": {name[:80]: us / 1e3 for name, us in
                              per_name.most_common(5)}}


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_solve: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    graphs = {"rca": standin("rca", scale=1.0, weighted=True, device=dev),
              "kron16": kronecker(16, edge_factor=16, seed=0, weighted=True,
                                  device=dev)}
    for gname, runs in RUNS.items():
        for alg, policy in runs:
            print(json.dumps(profile_run(gname, graphs[gname], alg, policy)),
                  flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
