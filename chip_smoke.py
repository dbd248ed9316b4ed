#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure raises and exits
non-zero:

  1. The card (``nvidia-smi``), then the build of every CUDA kernel from
     ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, all
     started together).
  2. Kernel grid: each kernel against its plain PyTorch version on the
     card, over combine {sum, min, max} × dtype {f32, f64, i32, i64} ×
     msg {copy, mul, add} × payload [n] / [n, 3], on small ragged graphs
     (a hub, empty rows, self loops, duplicate edges, m = 0). Integers,
     min and max must agree bit for bit, float sums to rtol = atol =
     1e-5.
  3. Main path: ``solve(..., backend="cuda")`` on the full CA-road
     stand-in (n = 1.96 M) and on Kronecker scale 16 (d_ell ≈ 9.8 k):
     PageRank (pull, push), BFS (gs, pull, auto) and Δ-stepping SSSP
     (push, pull). Launch counts are zeroed just before these runs and
     read just after; every kernel must have launched and no step may
     have fallen back to the plain primitives.
  4. Checks of the main path's answers: each against the port's "dense"
     backend on the card (ints and min/max exact, PageRank 1e-5), and
     against an independent host solver (scipy's Dijkstra / BFS, a
     float64 numpy power iteration).
  5. Each kernel at the main path's shapes: held against its plain
     version, then timed with CUDA events (L2 flushed before each
     launch) beside the plain version, the bound of the card and, for
     the sum pull, ``torch.sparse.mm`` on the CSR of the same graph
     (a yardstick the port never calls).

The line before the last is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import api  # noqa: E402
from repro_torch.graphs import build_graph, kronecker, standin  # noqa: E402
from repro_torch.graphs.structure import pad_values  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.coo_push import (build_push_plan,  # noqa: E402
                                          coo_push, coo_push_plain)
from repro_torch.kernels.ell_pull_frontier import (  # noqa: E402
    default_pull_cap, ell_pull_frontier, ell_pull_frontier_plain,
    frontier_rows)
from repro_torch.kernels.ell_spmv import ell_spmv, ell_spmv_plain  # noqa: E402
from repro_torch.sparse.segment import reduce_identity  # noqa: E402

KERNEL_INFO = {
    "ell_spmv": ("src/repro_torch/kernels/csrc/ell_spmv.cu",
                 "src/repro/kernels/ell_spmv.py:97"),
    "ell_pull_frontier": ("src/repro_torch/kernels/csrc/ell_pull_frontier.cu",
                          "src/repro/kernels/ell_pull_frontier.py:112"),
    "coo_push": ("src/repro_torch/kernels/csrc/coo_push.cu",
                 "src/repro/kernels/coo_push.py:312"),
}
COMBINES = ("sum", "min", "max")
DTYPES = (torch.float32, torch.float64, torch.int32, torch.int64)
MSGS = ("copy", "mul", "add")
WIDTHS = (None, 3)
SMALL_N = 24
SMALL_CASES = ("ragged", "empty_rows", "self_loops", "duplicate_edges",
               "edgeless")

# H100 SXM data-sheet peaks (dense, at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

MAIN_RUNS = (("pagerank", "pull"), ("pagerank", "push"), ("bfs", "gs"),
             ("bfs", "pull"), ("bfs", "auto"), ("sssp_delta", "push"),
             ("sssp_delta", "pull"))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise AssertionError(msg)


# -- small adversarial graphs ----------------------------------------------
def small_case_edges(case: str, seed: int = 0, n: int = SMALL_N):
    """Edge lists of the adversarial cases (the shapes of the test
    suite's ``graph_strategies``): a hub taking half the edges, rows with
    no in-edges, self loops, duplicate edges, and no edges at all."""
    rng = np.random.RandomState(1009 * seed + 131 * SMALL_CASES.index(case))
    if case == "edgeless":
        src = dst = np.zeros(0, dtype=np.int64)
    elif case == "ragged":
        m = 4 * n
        src = rng.randint(0, n, size=m)
        dst = np.where(rng.rand(m) < 0.5, 0, rng.randint(0, n, size=m))
    elif case == "empty_rows":
        m = 3 * n
        src = rng.randint(0, n, size=m)
        dst = rng.randint(0, max(n // 4, 1), size=m)
    elif case == "self_loops":
        src = rng.randint(0, n, size=2 * n)
        dst = rng.randint(0, n, size=2 * n)
        loops = rng.choice(n, size=n // 3, replace=False)
        src, dst = np.concatenate([src, loops]), np.concatenate([dst, loops])
    elif case == "duplicate_edges":
        m = 2 * n
        src = rng.randint(0, n, size=m)
        dst = rng.randint(0, n, size=m)
        dup = rng.choice(m, size=m // 2, replace=True)
        src = np.concatenate([src, src[dup], src[dup]])
        dst = np.concatenate([dst, dst[dup], dst[dup]])
    else:
        raise ValueError(case)
    w = rng.uniform(0.5, 2.0, size=src.shape[0]).astype(np.float32)
    return src, dst, w


def small_graphs(device) -> dict:
    out = {}
    for case in SMALL_CASES:
        src, dst, w = small_case_edges(case)
        out[case] = build_graph(src, dst, n=SMALL_N, weights=w,
                                device=device)
    return out


def payload(shape, dtype: torch.dtype, seed: int, device) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    if dtype.is_floating_point:
        a = rng.normal(size=shape)
    else:
        a = rng.integers(-50, 50, size=shape)
    return torch.from_numpy(a).to(dtype).to(device)


def max_abs_err(got: torch.Tensor, want: torch.Tensor, combine: str,
                what: str) -> float:
    """Hold ``got`` against ``want``: float sums to rtol = atol = 1e-5,
    everything else bit for bit. Returns the largest absolute gap."""
    if got.dtype != want.dtype or got.shape != want.shape:
        fail(f"{what}: {got.dtype}{tuple(got.shape)} vs plain "
             f"{want.dtype}{tuple(want.shape)}")
    if combine == "sum" and got.dtype.is_floating_point:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5,
                                   msg=lambda m: f"{what}: {m}")
    elif not torch.equal(got, want):
        bad = int((got != want).sum())
        fail(f"{what}: {bad} of {got.numel()} entries differ from the "
             "plain version (must be bit-exact)")
    if got.numel() == 0:
        return 0.0
    gap = torch.where(got == want, 0.0,
                      (got.double() - want.double()).abs())
    return float(gap.max())


def kernel_grid(device) -> dict:
    """Phase 2: every (combine, dtype, msg, width) cell of every kernel
    against its plain version on the small graphs."""
    errs = {k: 0.0 for k in KERNEL_INFO}
    cells = 0
    gen = torch.Generator(device=device).manual_seed(0)
    for case, g in small_graphs(device).items():
        plans = [build_push_plan(g.coo_src, g.coo_dst, g.coo_w, g.n, b,
                                 device=device)
                 for b in (8, 256)] if g.m else [None]
        touched = torch.rand(g.n, generator=gen, device=device) < 0.3
        rows = frontier_rows(touched, 16)
        active = torch.rand(g.n, generator=gen, device=device) < 0.5
        for c in COMBINES:
            for dt in DTYPES:
                for msg in MSGS:
                    for width in WIDTHS:
                        shape = (g.n + 1,) + (() if width is None
                                              else (width,))
                        x = payload(shape, dt, cells, device)
                        x[-1] = 0
                        tag = f"{case}/{c}/{dt}/{msg}/w{width}"
                        got = ell_spmv(x, g.ell_idx, g.ell_w, c, msg)
                        want = ell_spmv_plain(x, g.ell_idx, g.ell_w, c, msg)
                        errs["ell_spmv"] = max(errs["ell_spmv"], max_abs_err(
                            got, want, c, "ell_spmv " + tag))
                        got = ell_pull_frontier(x, g.ell_idx, g.ell_w, rows,
                                                c, msg)
                        want = ell_pull_frontier_plain(x, g.ell_idx, g.ell_w,
                                                       rows, c, msg)
                        errs["ell_pull_frontier"] = max(
                            errs["ell_pull_frontier"],
                            max_abs_err(got, want, c,
                                        "ell_pull_frontier " + tag))
                        for plan in plans:
                            got = coo_push(x[:-1], active, g.coo_src,
                                           g.coo_dst, g.coo_w, g.n, c, msg,
                                           plan=plan)
                            if plan is None:      # m == 0: the identity
                                want = torch.full_like(
                                    got, reduce_identity(c, got.dtype))
                            else:
                                want = coo_push_plain(x[:-1], active, plan,
                                                      g.n, c, msg)
                            errs["coo_push"] = max(
                                errs["coo_push"],
                                max_abs_err(got, want, c, "coo_push " + tag))
                        cells += 1
    torch.cuda.synchronize()
    emit({"phase": "kernel_grid", "cases": list(SMALL_CASES),
          "cells_per_case": cells // len(SMALL_CASES),
          "max_abs_err": errs})
    return errs


# -- the main path ---------------------------------------------------------
def main_graphs(device) -> dict:
    out = {}
    for name, make, delta in (
            ("rca", lambda: standin("rca", scale=1.0, weighted=True,
                                    device=device), 8.0),
            ("kron16", lambda: kronecker(16, edge_factor=16, seed=0,
                                         weighted=True, device=device), 2.0)):
        t0 = time.perf_counter()
        g = make()
        torch.cuda.synchronize()
        ell_gb = g.n * g.d_ell * 8 / 1e9
        emit({"phase": "graph", "graph": name, "n": g.n, "m": g.m,
              "d_ell": g.d_ell, "ell_slots_per_edge": g.n * g.d_ell / g.m,
              "ell_view_gb": ell_gb, "build_s": time.perf_counter() - t0})
        out[name] = (g, delta)
    return out


def run_kwargs(alg: str, delta: float) -> dict:
    return {"pagerank": {"iters": 20}, "bfs": {"root": 0},
            "sssp_delta": {"source": 0, "delta": delta}}[alg]


def main_path(graphs: dict) -> tuple[dict, dict]:
    """Phase 3: every main-path solve through the CUDA backend, with the
    launch counts zeroed just before and read just after."""
    be = api.BACKEND_SHORTHANDS["cuda"]
    for g, _ in graphs.values():                # set-up, not the path
        t0 = time.perf_counter()
        be.push_plan(g)
        torch.cuda.synchronize()
        emit({"phase": "push_plan", "n": g.n,
              "build_s": time.perf_counter() - t0})
    results = {}
    stats0 = dict(be.stats)
    _build.reset_launch_counts()
    for gname, (g, delta) in graphs.items():
        for alg, policy in MAIN_RUNS:
            before = _build.launch_counts()
            t0 = time.perf_counter()
            r = api.solve(g, alg, policy=policy, backend="cuda",
                          **run_kwargs(alg, delta))
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            after = _build.launch_counts()
            results[(gname, alg, policy)] = r
            emit({"phase": "solve", "graph": gname, "alg": alg,
                  "policy": policy, "backend": "cuda", "wall_ms": wall_ms,
                  "steps": r.steps, "push_steps": r.push_steps,
                  "epochs": r.epochs, "converged": r.converged,
                  "cost": r.cost.as_dict(),
                  "launches": {k: after[k] - before[k] for k in after}})
    counts = _build.launch_counts()
    stats = {k: be.stats[k] - stats0[k] for k in be.stats}
    emit({"phase": "main_path", "launches": counts, "dispatch": stats})
    for name in KERNEL_INFO:
        if counts[name] <= 0:
            fail(f"kernel {name} was never launched on the main path")
    for k in ("fallback_pull", "fallback_push"):
        if stats[k] != 0:
            fail(f"{stats[k]} main-path steps fell back ({k})")
    return results, counts


def host_reference(g, alg: str, kw: dict):
    """An independent host answer: scipy's Dijkstra and unweighted BFS,
    and a float64 numpy power iteration for PageRank."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra
    src = g.coo_src.cpu().numpy()
    dst = g.coo_dst.cpu().numpy()
    w = g.coo_w.cpu().numpy().astype(np.float64)
    if alg == "pagerank":
        deg = np.maximum(g.out_deg.cpu().numpy(), 1).astype(np.float64)
        r = np.full(g.n, 1.0 / g.n)
        for _ in range(kw["iters"]):
            contrib = np.bincount(dst, weights=(r / deg)[src], minlength=g.n)
            r = (1 - 0.85) / g.n + 0.85 * contrib
        return r
    a = csr_matrix((w, (src, dst)), shape=(g.n, g.n))
    if alg == "bfs":
        return dijkstra(a, indices=kw["root"], unweighted=True)
    return dijkstra(a, indices=kw["source"])


def check_answers(graphs: dict, results: dict) -> None:
    """Phase 4: the dense backend on the card and a host solver."""
    for (gname, alg, policy), r in results.items():
        g, delta = graphs[gname]
        kw = run_kwargs(alg, delta)
        dense = api.solve(g, alg, policy=policy, backend="dense", **kw)
        got = r.state if isinstance(r.state, dict) else {"rank": r.state}
        want = (dense.state if isinstance(dense.state, dict)
                else {"rank": dense.state})
        for key in sorted(want):
            a, b = got[key], want[key]
            if a.shape != (g.n,) or a.dtype != b.dtype:
                fail(f"{gname}/{alg}/{policy} {key}: {a.dtype}"
                     f"{tuple(a.shape)}, dense {b.dtype}{tuple(b.shape)}")
            if alg == "pagerank":
                torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
            elif not torch.equal(a, b):
                fail(f"{gname}/{alg}/{policy} {key}: "
                     f"{int((a != b).sum())} entries differ from dense")
        host = host_reference(g, alg, kw)
        if alg == "pagerank":
            mine = r.state.double().cpu().numpy()
            ok = np.isfinite(mine).all() and np.allclose(
                mine, host, rtol=1e-4, atol=1e-9)
        elif alg == "bfs":
            dist = r.state["dist"].cpu().numpy()
            reach = np.isfinite(host)
            ok = ((dist[reach] == host[reach]).all()
                  and (dist[~reach] == 2147483647).all())
        else:
            dist = r.state["dist"].double().cpu().numpy()
            reach = np.isfinite(host)
            ok = (np.allclose(dist[reach], host[reach], rtol=1e-5, atol=0)
                  and np.isinf(dist[~reach]).all())
        if not ok:
            fail(f"{gname}/{alg}/{policy}: disagrees with the host solver")
        emit({"phase": "check", "graph": gname, "alg": alg,
              "policy": policy, "equal_to_dense": True,
              "equal_to_host_solver": True})


# -- kernels at the main path's shapes -------------------------------------
def time_ms(fn, reps: int) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` launches, each after
    a 256 MB write that evicts the 50 MB L2 cache."""
    flush = torch.empty(1 << 28, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def shaped_kernels(gname: str, g, device) -> list:
    """Phase 5 on one graph: each kernel at the shape the main path gives
    it, checked against its plain version and timed. The main path's
    messages are all "copy" (PageRank and BFS), so the bounds count the
    int32 indices and not the weights, which a copy never reads."""
    gen = torch.Generator(device=device).manual_seed(1)
    out = []

    def record(name, shape, got, want, combine, kernel, plain, library,
               nbytes, ops, reps):
        err = max_abs_err(got, want, combine, f"{name} at {gname} {shape}")
        b_ms, b_by = bound(nbytes, ops)
        row = {"name": name, "route": "cuda", "source": KERNEL_INFO[name][0],
               "replaces": KERNEL_INFO[name][1], "graph": gname,
               "shape": shape, "max_abs_err": err,
               "ms": time_ms(kernel, reps),
               "plain_ms": time_ms(plain, max(3, reps // 4)),
               "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": (time_ms(library, reps) if library is not None
                              else None)}
        emit({"phase": "kernel_time", **row})
        out.append(row)

    n, m, d = g.n, g.m, g.d_ell
    reps = 20 if n * d < 1e8 else 8

    # ell_spmv: the PageRank pull (f32 contributions, sum, copy); the
    # yardstick is the unweighted CSR of the same graph times x
    x = pad_values(torch.rand(n, generator=gen, device=device))
    a = torch.sparse_csr_tensor(g.in_ptr, g.coo_src,
                                torch.ones(m, device=device), (n, n))
    record("ell_spmv", f"x f32[{n + 1}] idx[{n},{d}] sum/copy",
           ell_spmv(x, g.ell_idx, g.ell_w, "sum", "copy"),
           ell_spmv_plain(x, g.ell_idx, g.ell_w, "sum", "copy"), "sum",
           lambda: ell_spmv(x, g.ell_idx, g.ell_w, "sum", "copy"),
           lambda: ell_spmv_plain(x, g.ell_idx, g.ell_w, "sum", "copy"),
           lambda: torch.sparse.mm(a, x[:n, None]),
           nbytes=n * d * 4 + (n + 1) * 4 + n * 4, ops=m, reps=reps)

    # ell_pull_frontier: a BFS pull on the largest touched set that fits
    cap = default_pull_cap(n, m, d)
    cnt = min(cap, max(1, (m - 1) // d))
    touched = torch.zeros(n, dtype=torch.bool, device=device)
    touched[torch.randperm(n, generator=gen, device=device)[:cnt]] = True
    rows_n = max(8, 1 << (cnt - 1).bit_length())
    rows = frontier_rows(touched, rows_n)
    xi = pad_values(torch.randint(0, n + 8, (n,), generator=gen,
                                  device=device, dtype=torch.int32))
    live = rows[rows < n].long()
    srcs = g.ell_idx[live]
    distinct = int(torch.unique(srcs[srcs < n]).numel())
    record("ell_pull_frontier",
           f"x i32[{n + 1}] rows[{rows_n}] ({cnt} live) idx[{n},{d}] "
           "min/copy",
           ell_pull_frontier(xi, g.ell_idx, g.ell_w, rows, "min", "copy"),
           ell_pull_frontier_plain(xi, g.ell_idx, g.ell_w, rows, "min",
                                   "copy"), "min",
           lambda: ell_pull_frontier(xi, g.ell_idx, g.ell_w, rows, "min",
                                     "copy"),
           lambda: ell_pull_frontier_plain(xi, g.ell_idx, g.ell_w, rows,
                                           "min", "copy"),
           None, nbytes=cnt * d * 4 + rows_n * 4 + distinct * 4 + rows_n * 4,
           ops=int(g.in_deg[live].sum()), reps=reps)

    # coo_push: the PageRank push (f32, sum, copy, every source active)
    plan = api.BACKEND_SHORTHANDS["cuda"].push_plan(g)
    xs = torch.rand(n, generator=gen, device=device)
    active = torch.ones(n, dtype=torch.bool, device=device)
    args = (xs, active, g.coo_src, g.coo_dst, g.coo_w, n, "sum", "copy")
    record("coo_push",
           f"x f32[{n}] plan[{plan.nb},{plan.cap}] bin_n {plan.bin_n} "
           "sum/copy, all active",
           coo_push(*args, plan=plan),
           coo_push_plain(xs, active, plan, n, "sum", "copy"), "sum",
           lambda: coo_push(*args, plan=plan),
           lambda: coo_push_plain(xs, active, plan, n, "sum", "copy"),
           None, nbytes=m * 4 + plan.nb * (plan.bin_n + 1) * 4 + n * 9,
           ops=m, reps=reps)
    torch.cuda.synchronize()
    return out


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card "
              "and has no CPU mode", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    print(card_line(), flush=True)
    t0 = time.perf_counter()
    built = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_kernel_s": built, "flags": " ".join(_build.NVCC_FLAGS)})
    for name in _build.KERNELS:
        log = _build.lib_path(name).with_suffix(".log")
        if log.is_file():                    # ptxas -v, summarised
            text = log.read_text()
            regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
            spills = [int(s) for s in re.findall(r"(\d+) bytes spill", text)]
            emit({"phase": "ptxas", "kernel": name, "entries": len(regs),
                  "max_registers": max(regs, default=0),
                  "spill_bytes": sum(spills)})

    errs = kernel_grid(device)
    graphs = main_graphs(device)
    results, counts = main_path(graphs)
    check_answers(graphs, results)

    rows = []
    for gname, (g, _) in graphs.items():
        rows += shaped_kernels(gname, g, device)
    kernels = []
    for row in rows:
        if row["graph"] != "rca":
            continue
        name = row["name"]
        worst = max(errs[name], *(r["max_abs_err"] for r in rows
                                  if r["name"] == name))
        kernels.append({**row, "launches": counts[name],
                        "max_abs_err": worst})
    print(card_line(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
