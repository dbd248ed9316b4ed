#!/usr/bin/env python3
"""Time the port's full-scan ELL pull and scan push, and the graph walls
they carry, for one source tree of ``repro_torch``: a before/after (A/B)
comparison runs this once per tree, in turns, in one call on one card.

    python3 benchmarks/torch_graph_ab.py --src SRC --tag NAME [--out FILE]

``SRC`` is the ``src`` directory that holds the ``repro_torch`` to time
(a checkout of an earlier commit, or this one's); its kernels build into
that checkout's own ``build/``. On the full CA-road stand-in (``rca``)
and Kronecker scale 16 (``kron16``), the graphs of ``chip_smoke.py``, it
prints one JSON line per measurement:

  * ``"kernel"``: ``ell_spmv`` (PageRank pull: f32, sum, copy) at width
    1 and at the serving width (16 on rca, 32 on kron16), and
    ``coo_push`` strategy "scan" (every source active) at the same
    widths, with the blocks the tree's own tuner picks; median CUDA-event
    ms over launches after an L2 flush, beside ``torch.sparse.mm`` on
    the CSR of the same graph. The pull runs as the tree's backend calls
    it (over ``row_len = in_deg`` with its row plan where the tree has
    them).
  * ``"wall"``: on kron16, PageRank (20 iterations, pull) through the
    autotuned backend, batched PPR (B = 32, push) with the scan pinned
    and autotuned (wall and the push kernels' device ms), and a
    ``QueryService`` answering 48 requests (16 BFS, SSSP and PPR) at 32
    slots; each after one warm-up run (a fresh service for the service).

The first line is the card's ``nvidia-smi`` name and power limit. Needs
a CUDA device. Writes the same lines to ``--out`` when given.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

BATCH = {"rca": 16, "kron16": 32}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True)
    ap.add_argument("--tag", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_graph_ab: needs a CUDA device", file=sys.stderr)
        return 2
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    os.environ["REPRO_CACHE_DIR"] = str(
        src.parent / "build" / f"tune-ab-{os.getpid()}-{time.time_ns()}")
    from repro_torch import api
    from repro_torch.core import backend as backend_module
    from repro_torch.graphs import kronecker, standin
    from repro_torch.graphs.structure import pad_values
    from repro_torch.kernels.coo_push import coo_push
    from repro_torch.kernels.ell_spmv import ell_spmv
    from repro_torch.service import QueryService

    lines = []

    def emit(obj):
        obj = {"tag": args.tag, **obj}
        print(json.dumps(obj), flush=True)
        lines.append(obj)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    emit({"card": card, "src": str(src)})
    flush = torch.empty(1 << 28, dtype=torch.uint8, device="cuda")

    def time_ms(fn, reps=args.reps):
        fn()
        torch.cuda.synchronize()
        ev = []
        for _ in range(reps):
            flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            ev.append((s, e))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in ev)

    def wall_ms(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    row_len_api = "row_len" in inspect.signature(ell_spmv).parameters
    graphs = {
        "rca": standin("rca", scale=1.0, weighted=True, device="cuda"),
        "kron16": kronecker(16, edge_factor=16, seed=0, weighted=True,
                            device="cuda")}
    gen = torch.Generator(device="cuda").manual_seed(1)
    for gname, g in graphs.items():
        n, m = g.n, g.m
        auto = api.CudaBackend()
        scan = api.CudaBackend(push_strategy="scan")
        a = torch.sparse_csr_tensor(g.in_ptr, g.coo_src,
                                    torch.ones(m, device="cuda"), (n, n))
        active = torch.ones(n, dtype=torch.bool, device="cuda")
        for width in (1, BATCH[gname]):
            shape = (n, width) if width > 1 else (n,)
            xs = torch.rand(shape, generator=gen, device="cuda")
            xp = pad_values(xs)
            bn = auto._pull_block_n(g, xs, "sum", "copy")
            kw = {"block_n": bn}
            if row_len_api:
                kw.update(row_len=g.in_deg, plan=auto.pull_plan(g, width))
            lib = torch.sparse.mm(a, xs if width > 1 else xs[:, None])
            lib_ms = time_ms(lambda xs=xs: torch.sparse.mm(
                a, xs if xs.ndim == 2 else xs[:, None]))
            got = ell_spmv(xp, g.ell_idx, g.ell_w, "sum", "copy", **kw)
            err = float((got.double() - lib.reshape(got.shape).double())
                        .abs().max())
            emit({"kind": "kernel", "name": "ell_spmv", "graph": gname,
                  "width": width, "block_n": bn,
                  "ms": time_ms(lambda xp=xp, kw=kw: ell_spmv(
                      xp, g.ell_idx, g.ell_w, "sum", "copy", **kw)),
                  "sparse_mm_ms": lib_ms, "max_abs_err_vs_sparse_mm": err})
            be, bin_n, strat = scan.push_blocks(g, xs, "sum", "copy")
            plan = scan.push_plan(g, bin_n)
            pkw = dict(plan=plan, strategy=strat, block_e=be)
            got = coo_push(xs, active, g.coo_src, g.coo_dst, g.coo_w, n,
                           "sum", "copy", **pkw)
            err = float((got.double() - lib.reshape(got.shape).double())
                        .abs().max())
            emit({"kind": "kernel", "name": "coo_push", "graph": gname,
                  "width": width, "block_e": be, "bin_n": bin_n,
                  "ms": time_ms(lambda xs=xs, pkw=pkw: coo_push(
                      xs, active, g.coo_src, g.coo_dst, g.coo_w, n, "sum",
                      "copy", **pkw)),
                  "sparse_mm_ms": lib_ms, "max_abs_err_vs_sparse_mm": err})
        if gname != "kron16":
            continue
        r, ms = wall_ms(lambda: api.solve(g, "pagerank", policy="pull",
                                          backend=auto, iters=20))
        emit({"kind": "wall", "graph": gname, "run": "pagerank_pull",
              "wall_ms": ms, "steps": r.steps})
        order = torch.argsort(-g.out_deg.cpu(), stable=True)
        sources = [int(s) for s in order[:BATCH[gname]]]
        for way, be in (("scan", scan), ("auto", auto)):
            events = []
            real = backend_module.coo_push

            def timed(*a_, **k_):
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                out = real(*a_, **k_)
                e.record()
                events.append((s, e))
                return out
            backend_module.coo_push = timed
            try:
                api.solve_batch(g, "ppr", sources=sources, policy="push",
                                backend=be)
                torch.cuda.synchronize()
                events.clear()
                br, ms = wall_ms(lambda: api.solve_batch(
                    g, "ppr", sources=sources, policy="push", backend=be))
            finally:
                backend_module.coo_push = real
            # wall_ms ran the solve twice; keep the timed run's pushes
            push_ms = sum(s.elapsed_time(e) for s, e in
                          events[len(events) // 2:])
            x0 = torch.zeros((n, len(sources)), device="cuda")
            emit({"kind": "wall", "graph": gname, "run": f"ppr_batch_{way}",
                  "B": len(sources), "wall_ms": ms, "push_device_ms": push_ms,
                  "push_blocks": list(be.push_blocks(g, x0, "sum", "copy")),
                  "steps": br.steps})
        reqs = [(alg, s) for alg in ("bfs", "sssp_delta", "ppr")
                for s in sources[:16]]
        for _ in range(2):       # the first service pays the tuner probes
            svc = QueryService(g, backend=auto, slots=BATCH[gname])
            t0 = time.perf_counter()
            for alg, s in reqs:
                svc.submit(alg, s, **({"delta": 2.0} if alg == "sssp_delta"
                                      else {}))
            while svc.pending():
                svc.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        emit({"kind": "wall", "graph": gname, "run": "serve",
              "requests": len(reqs), "wall_s": wall,
              "qps": len(reqs) / wall})
    if args.out:
        with open(args.out, "a") as f:
            for obj in lines:
                f.write(json.dumps(obj) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
