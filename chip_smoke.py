#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure raises and exits
non-zero:

  1. The card (``nvidia-smi``), then the build of every CUDA kernel from
     ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, all
     started together). The tuner's cache points at a fresh directory
     under the git-ignored ``build/``, so every run probes the same way.
  2. Kernel grid: each kernel against its plain PyTorch version on the
     card, over combine {sum, min, max} × dtype {f32, f64, i32, i64} ×
     msg {copy, mul, add} × payload [n] / [n, 3], on small ragged graphs
     (a hub, empty rows, self loops, duplicate edges, m = 0); then
     ``"mxu_grid"``, the one-hot push against ``coo_push_mxu_plain`` over
     the same cells at B ∈ {1, 8, 32} on those graphs plus a star.
     Integers, min and max must agree bit for bit, float sums to
     rtol = atol = 1e-5.
  3. ``"tune"``: the tuner probes every push and full-scan pull key the
     two main paths below run, on the full CA-road stand-in (n = 1.96 M)
     and Kronecker scale 16; one line per probe (candidates timed,
     pruned, winner, seconds). Probes that happen later (frontier-pull
     row capacities) are printed after their phase, and their launches
     are not counted as the path's.
  4. Main path of slice 1: ``solve(..., backend="cuda")`` on both graphs:
     PageRank (pull, push), BFS (gs, pull, auto) and Δ-stepping SSSP
     (push, pull), then each answer against the port's "dense" backend
     on the card and an independent host solver (scipy's Dijkstra / BFS,
     a float64 numpy power iteration).
  5. Main path of slice 2, the serving path: ``"solve_batch"`` runs
     batched BFS, SSSP and personalized PageRank under push on rca
     (B = 16) and kron16 (B = 32) three ways — push strategy pinned to
     "scan", pinned to "mxu", and autotuned — which must agree; then
     ``"serve"``: a ``QueryService(g, backend="cuda")`` answers 48
     requests per graph (16 each, sources highest out-degree first), two
     per algorithm checked against a single-source ``solve`` on the card
     and a host solver, and a repeated request must hit the cache.
  6. Each kernel at its path's shapes: held against its plain version,
     then timed with CUDA events (L2 flushed before each launch) beside
     the plain version, the bound of the card and, where one PyTorch
     call computes the same function, ``torch.sparse.mm`` on the CSR of
     the same graph (a yardstick the port never calls).

Launch counts are zeroed just before each main path and read just after
it; every kernel of the path must have launched and no step may have
fallen back to the plain primitives. The line before the last is
``{"kernels": [...]}``; the last is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
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
from repro_torch.core import backend as backend_module  # noqa: E402
from repro_torch.graphs import (build_graph, kronecker, standin,  # noqa: E402
                                star)
from repro_torch.graphs.structure import pad_values  # noqa: E402
from repro_torch.kernels import _build, tune  # noqa: E402
from repro_torch.kernels.coo_push import (build_push_plan,  # noqa: E402
                                          coo_push, coo_push_mxu_plain,
                                          coo_push_plain)
from repro_torch.kernels.ell_pull_frontier import (  # noqa: E402
    default_pull_cap, ell_pull_frontier, ell_pull_frontier_plain,
    frontier_rows)
from repro_torch.kernels.ell_spmv import ell_spmv, ell_spmv_plain  # noqa: E402
from repro_torch.service import QueryService  # noqa: E402
from repro_torch.sparse.segment import reduce_identity  # noqa: E402

KERNEL_INFO = {
    "ell_spmv": ("src/repro_torch/kernels/csrc/ell_spmv.cu",
                 "src/repro/kernels/ell_spmv.py:97"),
    "ell_pull_frontier": ("src/repro_torch/kernels/csrc/ell_pull_frontier.cu",
                          "src/repro/kernels/ell_pull_frontier.py:112"),
    "coo_push": ("src/repro_torch/kernels/csrc/coo_push.cu",
                 "src/repro/kernels/coo_push.py:312"),
    "coo_push_mxu": ("src/repro_torch/kernels/csrc/coo_push_mxu.cu",
                     "src/repro/kernels/coo_push.py:241"),
}
# the push kernels, by the name of their device functions
PUSH_KERNELS = ("coo_push", "coo_push_mxu")
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
TF32_OPS_PER_S = 495e12

# batch width of the serving path per graph
BATCH = {"rca": 16, "kron16": 32}
SERVE_PER_ALG = 16

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
    errs = {k: 0.0 for k in ("ell_spmv", "ell_pull_frontier", "coo_push")}
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


def mxu_grid(device) -> float:
    """The one-hot push against ``coo_push_mxu_plain`` over combine ×
    dtype × msg × B ∈ {1, 8, 32} on the small graphs plus a star (one
    hub taking every edge of its bin), with bins of 8 and 256 and chunks
    of 64 and 1,024 slots. Returns the largest gap. The plain version
    sums float32 in float32, and two float32 sums of the hub's ~2,000
    terms agree to 1e-5 only when they do not cancel, so the star's float
    payloads are non-negative."""
    err, cells = 0.0, 0
    graphs = {**small_graphs(device), "star": star(3000, device=device)}
    gen = torch.Generator(device=device).manual_seed(5)
    for case, g in graphs.items():
        if not g.m:
            continue                  # m = 0 launches nothing (phase 2)
        plans = [build_push_plan(g.coo_src, g.coo_dst, g.coo_w, g.n, b,
                                 device=device) for b in (8, 256)]
        active = torch.rand(g.n, generator=gen, device=device) < 0.6
        for width in (None, 8, 32):
            for dt in DTYPES:
                for c in COMBINES:
                    for msg in MSGS:
                        shape = (g.n,) + (() if width is None else (width,))
                        x = payload(shape, dt, cells, device)
                        if case == "star" and dt.is_floating_point:
                            x = x.abs()
                        for plan in plans:
                            for block_e in (64, 1024):
                                got = coo_push(x, active, g.coo_src,
                                               g.coo_dst, g.coo_w, g.n, c,
                                               msg, plan=plan,
                                               strategy="mxu",
                                               block_e=block_e)
                                want = coo_push_mxu_plain(
                                    x, active, plan, g.n, c, msg, block_e)
                                err = max(err, max_abs_err(
                                    got, want, c,
                                    f"coo_push_mxu {case}/{c}/{dt}/{msg}/"
                                    f"w{width}/bin{plan.bin_n}/be{block_e}"))
                        cells += 1
    torch.cuda.synchronize()
    emit({"phase": "mxu_grid", "cases": sorted(graphs), "cells": cells,
          "max_abs_err": err})
    return err


# -- the tuner -------------------------------------------------------------
# (algorithm, payload dtype, combine, msg) of each relaxation the paths run
RELAX_KINDS = {"pagerank": (torch.float32, "sum", "copy"),
               "ppr": (torch.float32, "sum", "copy"),
               "bfs": (torch.int32, "min", "copy"),
               "sssp_delta": (torch.float32, "min", "add")}


def serve_width(gname: str) -> int:
    return min(BATCH[gname], SERVE_PER_ALG)


def tune_phase(graphs: dict, backends: list) -> None:
    """Probe every push and full-scan pull key of the two main paths
    (widths 1 and the batch widths), then build the bin plans those
    choices need in every backend the paths use: set-up, not the path."""
    tune.clear_stats()
    t0 = time.perf_counter()
    for gname, (g, _) in graphs.items():
        for width in sorted({1, BATCH[gname], serve_width(gname)}):
            for dtype, combine, mode in set(RELAX_KINDS.values()):
                shape = (g.n,) if width == 1 else (g.n, width)
                x = torch.zeros(shape, dtype=dtype, device=g.device)
                for be in backends:
                    be._pull_block_n(g, x, combine, mode)
                    be.push_plan(g, be.push_blocks(g, x, combine, mode)[1])
    torch.cuda.synchronize()
    probe_lines("tune")
    emit({"phase": "tune_total", "seconds": time.perf_counter() - t0,
          "cache": str(tune._cache_path())})


def probe_lines(during: str) -> dict:
    """Print the probes since the last call; return their launches."""
    launches = {k: 0 for k in _build.KERNELS}
    for rec in tune.probe_records():
        emit({"phase": "tune", "during": during, "key": rec["key"],
              "timed": rec["timed"], "pruned": rec["pruned"],
              "winner": rec["winner"], "seconds": rec["seconds"]})
        for k, v in rec["launches"].items():
            launches[k] += v
    tune.clear_stats()
    return launches


def path_launches(before: dict, probes: dict) -> dict:
    """Launches since ``before``, less those the tuner's probes made."""
    now = _build.launch_counts()
    return {k: now[k] - before[k] - probes[k] for k in now}


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
    """Slice 1's main path: every solve through the CUDA backend, with
    the launch counts zeroed just before and read just after."""
    be = api.BACKEND_SHORTHANDS["cuda"]
    results = {}
    stats0 = dict(be.stats)
    _build.reset_launch_counts()
    tune.clear_stats()
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
    counts = path_launches({k: 0 for k in _build.KERNELS},
                           probe_lines("main_path"))
    stats = {k: be.stats[k] - stats0[k] for k in be.stats}
    emit({"phase": "main_path", "launches": counts, "dispatch": stats})
    for name in ("ell_spmv", "ell_pull_frontier"):
        if counts[name] <= 0:
            fail(f"kernel {name} was never launched on the main path")
    if sum(counts[k] for k in PUSH_KERNELS) <= 0:
        fail("no push kernel was launched on the main path")
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


# -- the serving path ------------------------------------------------------
def top_sources(g, k: int) -> list[int]:
    """Distinct query vertices, highest out-degree first."""
    order = np.argsort(-g.out_deg.cpu().numpy(), kind="stable")
    return [int(order[i % g.n]) for i in range(k)]


def batch_kwargs(alg: str, delta: float) -> dict:
    return {"sssp_delta": {"delta": delta}}.get(alg, {})


class PushTimer:
    """CUDA events around every push kernel call the backend makes: the
    push kernels' device time of a run (the span holds the wrapper's
    launch and no other device work)."""

    def __init__(self):
        self.events = []
        self._real = backend_module.coo_push

    def __enter__(self):
        def timed(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = self._real(*args, **kw)
            end.record()
            self.events.append((start, end))
            return out
        backend_module.coo_push = timed
        return self

    def __exit__(self, *exc):
        backend_module.coo_push = self._real

    def device_ms(self) -> float:
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events)


def same_states(got: dict, want: dict, float_sum: bool, what: str) -> None:
    for key in sorted(want):
        a, b = got[key], want[key]
        if a.dtype != b.dtype or a.shape != b.shape:
            fail(f"{what} {key}: {a.dtype}{tuple(a.shape)} vs "
                 f"{b.dtype}{tuple(b.shape)}")
        if float_sum and a.dtype.is_floating_point:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5,
                                       msg=lambda m: f"{what} {key}: {m}")
        elif not torch.equal(a, b):
            fail(f"{what} {key}: {int((a != b).sum())} entries differ")


def solve_batch_phase(graphs: dict, ways: dict) -> None:
    """Batched BFS, SSSP and PPR under push, three ways (push strategy
    pinned to "scan", to "mxu", autotuned); the answers must agree."""
    for gname, (g, delta) in graphs.items():
        sources = top_sources(g, BATCH[gname])
        for alg in ("bfs", "sssp_delta", "ppr"):
            kw = batch_kwargs(alg, delta)
            answers = {}
            for way, be in ways.items():
                stats0 = dict(be.stats)
                before = _build.launch_counts()
                with PushTimer() as timer:
                    t0 = time.perf_counter()
                    br = api.solve_batch(g, alg, sources=sources,
                                         policy="push", backend=be, **kw)
                    torch.cuda.synchronize()
                    wall_ms = (time.perf_counter() - t0) * 1e3
                after = _build.launch_counts()
                dtype, combine, mode = RELAX_KINDS[alg]
                x = torch.zeros((g.n, len(sources)), dtype=dtype,
                                device=g.device)
                answers[way] = br.states
                emit({"phase": "solve_batch", "graph": gname, "alg": alg,
                      "way": way, "B": len(sources), "wall_ms": wall_ms,
                      "push_device_ms": timer.device_ms(),
                      "push_blocks": list(be.push_blocks(g, x, combine,
                                                         mode)),
                      "steps": br.steps, "push_steps": br.push_steps,
                      "epochs": br.epochs, "converged": br.converged,
                      "all_done": bool(br.done.all()),
                      "launches": {k: after[k] - before[k] for k in after},
                      "fallbacks": sum(be.stats[k] - stats0[k] for k in
                                       ("fallback_pull", "fallback_push"))})
                if not bool(br.done.all()):
                    fail(f"solve_batch {gname}/{alg}/{way}: not all done")
            for way in ("mxu", "auto"):
                for i in range(len(sources)):
                    same_states(answers[way][i], answers["scan"][i],
                                alg == "ppr",
                                f"solve_batch {gname}/{alg} {way} vs scan "
                                f"query {i}")
            emit({"phase": "solve_batch_check", "graph": gname, "alg": alg,
                  "ways_agree": True})


def ppr_host(g, source: int, damp: float = 0.85, tol: float = 1e-6,
             iters: int = 100) -> np.ndarray:
    """Personalized PageRank by a float64 numpy power iteration."""
    src = g.coo_src.cpu().numpy()
    dst = g.coo_dst.cpu().numpy()
    deg = np.maximum(g.out_deg.cpu().numpy(), 1).astype(np.float64)
    base = np.zeros(g.n)
    base[source] = 1.0 - damp
    r = base.copy()
    for _ in range(iters):
        new = base + damp * np.bincount(dst, weights=(r / deg)[src],
                                        minlength=g.n)
        done = np.abs(new - r).max() < tol
        r = new
        if done:
            break
    return r


def check_served(g, alg: str, source: int, delta: float, got: dict,
                 what: str) -> None:
    """A served answer against the single-source solve on the card and
    a host solver."""
    key = api.get_spec(alg).runtime_keys[0]
    kw = batch_kwargs(alg, delta)
    one = api.solve(g, alg, backend="cuda", **{key: source}, **kw)
    same_states(got, one.state, alg == "ppr", what + " vs solve")
    if alg == "ppr":
        mine = got["ranks"].double().cpu().numpy()
        ok = np.allclose(mine, ppr_host(g, source), rtol=1e-4, atol=1e-5)
    else:
        host = host_reference(g, alg, {key: source})
        reach = np.isfinite(host)
        dist = got["dist"].double().cpu().numpy()
        if alg == "bfs":
            ok = ((dist[reach] == host[reach]).all()
                  and (dist[~reach] == 2147483647).all())
        else:
            ok = (np.allclose(dist[reach], host[reach], rtol=1e-5, atol=0)
                  and np.isinf(dist[~reach]).all())
    if not ok:
        fail(f"{what}: disagrees with the host solver")


def serve_phase(graphs: dict) -> None:
    """A QueryService on the card answers 16 BFS, 16 SSSP and 16 PPR
    requests per graph, submitted at once; per-request latency is from
    submit to the step that finished it."""
    be = api.BACKEND_SHORTHANDS["cuda"]
    for gname, (g, delta) in graphs.items():
        stats0 = dict(be.stats)
        sources = top_sources(g, SERVE_PER_ALG)
        svc = QueryService(g, backend="cuda", slots=BATCH[gname])
        reqs = [(alg, s) for alg in ("bfs", "sssp_delta", "ppr")
                for s in sources]
        t0 = time.perf_counter()
        submitted = {}
        for alg, s in reqs:
            rid = svc.submit(alg, s, **batch_kwargs(alg, delta))
            submitted[rid] = (alg, s, time.perf_counter())
        finished = {}
        while svc.pending():
            svc.step()
            now = time.perf_counter()
            for rid in submitted:
                if rid not in finished and svc.record(rid).done:
                    finished[rid] = now
        wall_s = time.perf_counter() - t0
        lat = sorted((finished[r] - submitted[r][2]) * 1e3
                     for r in submitted)
        st = svc.stats()
        fallbacks = sum(be.stats[k] - stats0[k]
                        for k in ("fallback_pull", "fallback_push"))
        emit({"phase": "serve", "graph": gname, "slots": BATCH[gname],
              "requests": len(reqs), "wall_s": wall_s,
              "qps": len(reqs) / wall_s,
              "p50_ms": lat[len(lat) // 2],
              "p99_ms": lat[min(len(lat) - 1, int(0.99 * len(lat)))],
              "batches": st["batches_started"], "chunks": st["chunks_run"],
              "cache_hits": st["cache"]["hits"],
              "force_retired": st["force_retired"],
              "fallbacks": fallbacks})
        if fallbacks or st["force_retired"] or any(
                svc.record(r).error for r in submitted):
            fail(f"serve {gname}: {fallbacks} fallbacks, "
                 f"{st['force_retired']} force-retired or failed queries")
        for alg in ("bfs", "sssp_delta", "ppr"):
            rids = [r for r, v in submitted.items() if v[0] == alg][:2]
            for rid in rids:
                check_served(g, alg, submitted[rid][1], delta,
                             svc.poll(rid),
                             f"serve {gname}/{alg} source "
                             f"{submitted[rid][1]}")
        again = svc.submit("bfs", sources[0])
        if not svc.record(again).cached:
            fail(f"serve {gname}: a repeated request missed the cache")
        emit({"phase": "serve_check", "graph": gname,
              "checked_per_alg": 2, "equal_to_solve": True,
              "equal_to_host_solver": True, "repeat_cache_hit": True,
              "cache_hits": svc.stats()["cache"]["hits"]})


def serving_path(graphs: dict, ways: dict) -> dict:
    """Slice 2's main path: solve_batch then serve, with the launch
    counts zeroed just before and read just after."""
    _build.reset_launch_counts()
    tune.clear_stats()
    solve_batch_phase(graphs, ways)
    serve_phase(graphs)
    counts = path_launches({k: 0 for k in _build.KERNELS},
                           probe_lines("serving_path"))
    emit({"phase": "serving_path", "launches": counts})
    for name in PUSH_KERNELS:
        if counts[name] <= 0:
            fail(f"kernel {name} was never launched on the serving path")
    return counts


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


def shaped_kernels(gname: str, g, device, ways: dict) -> list:
    """Phase 5 on one graph: each kernel at the shape the main path gives
    it, checked against its plain version and timed. The main path's
    messages are all "copy" (PageRank and BFS), so the bounds count the
    int32 indices and not the weights, which a copy never reads."""
    gen = torch.Generator(device=device).manual_seed(1)
    out = []

    def record(name, shape, got, want, combine, kernel, plain, library,
               nbytes, ops, reps, extra=None):
        err = max_abs_err(got, want, combine, f"{name} at {gname} {shape}")
        b_ms, b_by = bound(nbytes, ops)
        row = {"name": name, "route": "cuda", "source": KERNEL_INFO[name][0],
               "replaces": KERNEL_INFO[name][1], "graph": gname,
               "shape": shape, "max_abs_err": err,
               "ms": time_ms(kernel, reps),
               "plain_ms": time_ms(plain, max(3, reps // 4)),
               "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": (time_ms(library, reps) if library is not None
                              else None), **(extra or {})}
        emit({"phase": "kernel_time", **row})
        out.append(row)

    n, m, d = g.n, g.m, g.d_ell
    reps = 20 if n * d < 1e8 else 8

    # ell_spmv: the PageRank pull (f32 contributions, sum, copy); the
    # yardstick is the unweighted CSR of the same graph times x
    x = pad_values(torch.rand(n, generator=gen, device=device))
    a = torch.sparse_csr_tensor(g.in_ptr, g.coo_src,
                                torch.ones(m, device=device), (n, n))
    auto = ways["auto"]
    bn = auto._pull_block_n(g, x[:n], "sum", "copy")
    record("ell_spmv", f"x f32[{n + 1}] idx[{n},{d}] block_n {bn} sum/copy",
           ell_spmv(x, g.ell_idx, g.ell_w, "sum", "copy", block_n=bn),
           ell_spmv_plain(x, g.ell_idx, g.ell_w, "sum", "copy"), "sum",
           lambda: ell_spmv(x, g.ell_idx, g.ell_w, "sum", "copy",
                            block_n=bn),
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
    br = auto._pull_frontier_block(g, rows_n, xi[:n], "min", "copy")
    record("ell_pull_frontier",
           f"x i32[{n + 1}] rows[{rows_n}] ({cnt} live) idx[{n},{d}] "
           f"block_r {br} min/copy",
           ell_pull_frontier(xi, g.ell_idx, g.ell_w, rows, "min", "copy",
                             block_r=br),
           ell_pull_frontier_plain(xi, g.ell_idx, g.ell_w, rows, "min",
                                   "copy"), "min",
           lambda: ell_pull_frontier(xi, g.ell_idx, g.ell_w, rows, "min",
                                     "copy", block_r=br),
           lambda: ell_pull_frontier_plain(xi, g.ell_idx, g.ell_w, rows,
                                           "min", "copy"),
           None, nbytes=cnt * d * 4 + rows_n * 4 + distinct * 4 + rows_n * 4,
           ops=int(g.in_deg[live].sum()), reps=reps)

    # coo_push and coo_push_mxu: the (Personalized) PageRank push (f32,
    # sum, copy, every source active) at width 1 (slice 1) and at the
    # serving path's batch width, with the blocks the tuner gives the
    # path's backends; the yardstick is the same CSR times x
    active = torch.ones(n, dtype=torch.bool, device=device)
    for name, width, way in (("coo_push", 1, "scan"),
                             ("coo_push", BATCH[gname], "scan"),
                             ("coo_push_mxu", BATCH[gname], "mxu")):
        xs = torch.rand((n, width) if width > 1 else (n,), generator=gen,
                        device=device)
        block_e, bin_n, strategy = ways[way].push_blocks(g, xs, "sum",
                                                         "copy")
        plan = ways[way].push_plan(g, bin_n)
        args = (xs, active, g.coo_src, g.coo_dst, g.coo_w, n, "sum", "copy")
        kw = dict(plan=plan, strategy=strategy, block_e=block_e)

        def plain(xs=xs, strategy=strategy, block_e=block_e, plan=plan):
            if strategy == "mxu":
                return coo_push_mxu_plain(xs, active, plan, n, "sum", "copy",
                                          block_e)
            return coo_push_plain(xs, active, plan, n, "sum", "copy")

        record(name,
               f"x f32[{n}, {width}] plan[{plan.nb},{plan.cap}] bin_n "
               f"{plan.bin_n} block_e {block_e} sum/copy, all active",
               coo_push(*args, **kw), plain(), "sum",
               lambda args=args, kw=kw: coo_push(*args, **kw), plain,
               lambda xs=xs: torch.sparse.mm(
                   a, xs if xs.ndim == 2 else xs[:, None]),
               nbytes=(m * 4 + plan.nb * (plan.bin_n + 1) * 4 + n
                       + 2 * n * width * 4),
               ops=m * width, reps=reps,
               # the one-hot design's own floor: two TF32 products over
               # the whole one-hot matrix
               extra={"width": width, "onehot_floor_ms": (
                   4 * plan.nb * plan.bin_n * plan.cap * width
                   / TF32_OPS_PER_S * 1e3 if strategy == "mxu" else None)})
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
    # a fresh tuner cache, so that every run probes the same way
    os.environ["REPRO_CACHE_DIR"] = str(
        _build.BUILD_DIR.parent / f"tune-{os.getpid()}-{time.time_ns()}")
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
    errs["coo_push_mxu"] = mxu_grid(device)
    graphs = main_graphs(device)
    ways = {"scan": api.CudaBackend(push_strategy="scan"),
            "mxu": api.CudaBackend(push_strategy="mxu"),
            "auto": api.BACKEND_SHORTHANDS["cuda"]}
    tune_phase(graphs, list(ways.values()))
    results, counts = main_path(graphs)
    check_answers(graphs, results)
    serving = serving_path(graphs, ways)
    counts = {k: counts[k] + serving[k] for k in counts}

    rows = []
    for gname, (g, _) in graphs.items():
        rows += shaped_kernels(gname, g, device, ways)
    kernels = []
    for row in rows:
        # one row per kernel: the road graph, at width 1 where the kernel
        # runs there (slice 1), else at the serving path's width
        if row["graph"] != "rca" or (row["name"] == "coo_push"
                                     and row["width"] != 1):
            continue
        name = row["name"]
        worst = max(errs[name], *(r["max_abs_err"] for r in rows
                                  if r["name"] == name))
        kernels.append({k: v for k, v in row.items()
                        if k not in ("width", "onehot_floor_ms")}
                       | {"launches": counts[name], "max_abs_err": worst})
    print(card_line(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
