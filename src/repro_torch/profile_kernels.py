"""Time the kernels that PRs redesign, one source tree of
``repro_torch`` at a time, and the walls that carry them: a before/after
(A/B) comparison runs this once per tree, in turns, in one call on one
card.

    python3 src/repro_torch/profile_kernels.py --src SRC --tag NAME \\
        [--out FILE] [--reps N] [--only SECTION,...]

``SRC`` is the ``src`` directory holding the ``repro_torch`` to time (a
checkout of an earlier commit, or this one's); its kernels build into
that checkout's own ``build/``, and its tuner caches under a fresh
directory there. The first line is the card's ``nvidia-smi`` name and
power limit; then one JSON line per measurement. Sections (``--only``
picks some, all by default):

  * ``mxu``: ``coo_push(strategy="mxu")`` on the PageRank push (f32, sum,
    copy, every source active) over the full CA-road stand-in (``rca``)
    at widths 1 and 16 and Kronecker scale 16 (``kron16``) at widths 1
    and 32, the graphs of ``chip_smoke.py``, with the blocks the tree's
    tuner picks for the one-hot strategy; beside ``torch.sparse.mm`` on
    the CSR of the same graph, the bytes bound and the one-hot design's
    own floor (its TF32 products of each edge against its 64-row tile,
    as the tree's own ``roofline.py`` counts them).
  * ``flash``: bf16, the llama3.2-1b prefill layer (q [2, 4,096, 32,
    64], 8 KV heads, causal) beside ``scaled_dot_product_attention``,
    the gemma2-9b layers (q [1, 8,192, 16, 256], 8 KV heads, softcap 50)
    with the 4,096 window and without, and deepseek-moe-16b's (q [1,
    4,096, 16, 128], 16 KV heads, causal); beside the operations bound.
    Where the tree's forward can write the row logsumexp
    (``flash_attention_fwd``), that forward is timed too; the backward
    (``flash_attention_bwd``: the tree's kernel, or an earlier tree's
    plain recompute) beside SDPA's backward and the bound of its five
    products.
  * ``frontier``: ``ell_pull_frontier`` on the BFS pull (i32, min, copy)
    of ``chip_smoke.py``'s row list (the largest touched set that fits
    the default cap) on rca and kron16, over the real slots where the
    tree's kernel takes ``row_len``, at the tree's tuned ``block_r``;
    beside the full-scan pull of the same payload and the bytes bound.
  * ``cin``: the CIN layer on xDeepFM serve_p99's shapes (B = 512, D =
    10, F = 39, H = 200; layer 0 Hp = 39, layer 1 Hp = 200), seeded
    inputs, beside ``torch.einsum``, the f32 bound and the 3xTF32 floor.
  * ``cin_bwd``: the CIN layer's backward (``CinLayer``'s, through
    ``torch.autograd.grad`` after its forward) at serve_p99's layer 1 and
    train_batch's layers (B = 65,536; Hp = 39 and 200), f32, seeded;
    where the tree has them, its dw and dx0 kernels alone
    (``cin_weight_grad``, ``cin_dx0``); beside the three products'
    3xTF32 floor and f32 bound.
  * ``walls``: what the tuner picks for the serving widths, the batched
    PPR run (B = 32) and a ``QueryService`` answering 48 requests on
    kron16 through the autotuned backend, and llama3.2-1b's prefill of
    2 x 4,096 tokens (full config, seeded weights) with the flash
    kernel's device ms in it.
  * ``xdeepfm``: xDeepFM (full config, seeded weights) serving
    serve_p99 (512 rows, median of 20) and serve_bulk (262,144 rows,
    median of 3), with the CIN layers' device ms.

Kernel times are median CUDA-event ms over launches each after a write
that evicts the L2 cache; the timer, the card's peaks and the bounds are
this tree's ``kernels/roofline.py`` (shared with ``chip_smoke.py``),
loaded by its path whatever ``--src`` holds. Needs a CUDA device;
imports nothing of the tree until ``main`` runs.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

BATCH = {"rca": 16, "kron16": 32}
SECTIONS = ("mxu", "flash", "frontier", "cin", "cin_bwd", "walls",
            "xdeepfm")


def load_roofline():
    """This tree's ``kernels/roofline.py``, loaded by its path: the tree
    under ``--src`` may be an earlier one without it, and its
    ``repro_torch`` is the one that imports by name."""
    path = Path(__file__).resolve().parent / "kernels" / "roofline.py"
    spec = importlib.util.spec_from_file_location("_profile_roofline", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", required=True)
    ap.add_argument("--tag", required=True)
    ap.add_argument("--out", default=None)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", default=",".join(SECTIONS))
    args = ap.parse_args(argv)
    only = set(args.only.split(","))
    if not only <= set(SECTIONS):
        ap.error(f"--only takes sections of {SECTIONS}")
    import torch
    if not torch.cuda.is_available():
        print("profile_kernels: needs a CUDA device", file=sys.stderr)
        return 2
    rl = load_roofline()
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    os.environ["REPRO_CACHE_DIR"] = str(
        src.parent / "build" / f"tune-pk-{os.getpid()}-{time.time_ns()}")
    from repro_torch import api
    from repro_torch.core import backend as backend_module
    from repro_torch.graphs import kronecker, standin
    from repro_torch.graphs.structure import pad_values
    from repro_torch.kernels.cin import cin_layer
    from repro_torch.kernels.coo_push import coo_push
    from repro_torch.kernels.ell_pull_frontier import (default_pull_cap,
                                                       ell_pull_frontier,
                                                       frontier_rows)
    from repro_torch.kernels.ell_spmv import ell_spmv
    from repro_torch.kernels.flash_attention import flash_attention
    fmod = sys.modules["repro_torch.kernels.flash_attention"]

    lines = []

    def emit(obj):
        obj = {"tag": args.tag, **obj}
        print(json.dumps(obj), flush=True)
        lines.append(obj)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    emit({"card": card, "src": str(src)})
    flush = torch.empty(1 << 28, dtype=torch.uint8, device="cuda")

    def time_ms(fn, reps=args.reps):
        return rl.time_ms(fn, reps, flush)

    def wall_ms(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    graphs = {}
    if only & {"mxu", "frontier", "walls"}:
        graphs = {
            "rca": standin("rca", scale=1.0, weighted=True, device="cuda"),
            "kron16": kronecker(16, edge_factor=16, seed=0, weighted=True,
                                device="cuda")}
    gen = torch.Generator(device="cuda").manual_seed(1)

    # ---- the one-hot push
    if "mxu" in only:
        mxu = api.CudaBackend(push_strategy="mxu")
        for gname, g in graphs.items():
            n, m = g.n, g.m
            a = torch.sparse_csr_tensor(g.in_ptr, g.coo_src,
                                        torch.ones(m, device="cuda"), (n, n))
            active = torch.ones(n, dtype=torch.bool, device="cuda")
            for width in (1, BATCH[gname]):
                xs = torch.rand((n, width) if width > 1 else (n,),
                                generator=gen, device="cuda")
                be, bin_n, strat = mxu.push_blocks(g, xs, "sum", "copy")
                plan = mxu.push_plan(g, bin_n)
                kw = dict(plan=plan, strategy=strat, block_e=be)

                def run(xs=xs, kw=kw):
                    return coo_push(xs, active, g.coo_src, g.coo_dst, g.coo_w,
                                    n, "sum", "copy", **kw)

                def lib(xs=xs):
                    return torch.sparse.mm(
                        a, xs if xs.ndim == 2 else xs[:, None])
                err = float((run().double() - lib().reshape(xs.shape).double())
                            .abs().max())
                b_ms, b_by = rl.bound(rl.push_bytes(m, n, width, plan.nb,
                                                    plan.bin_n), m * width)
                emit({"kind": "kernel", "name": "coo_push_mxu", "graph": gname,
                      "width": width, "block_e": be, "bin_n": bin_n,
                      "ms": time_ms(run), "sparse_mm_ms": time_ms(lib),
                      "bound_ms": b_ms, "bound_by": b_by,
                      "tile_floor_ms": rl.onehot_floor_ms(m, width),
                      "max_abs_err_vs_sparse_mm": err})

    # ---- flash attention (bf16)
    if "flash" in only:
        fgen = torch.Generator(device="cuda").manual_seed(2)

        def normal(shape):
            return torch.randn(shape, generator=fgen, device="cuda").to(
                torch.bfloat16)

        window_all = 1 << 30
        for name, (B, T, H, Hk, d, window, cap) in {
                "llama3.2-1b": (2, 4096, 32, 8, 64, window_all, 0.0),
                "gemma2-9b local": (1, 8192, 16, 8, 256, 4096, 50.0),
                "gemma2-9b global": (1, 8192, 16, 8, 256, window_all, 50.0),
                "deepseek-moe-16b": (1, 4096, 16, 16, 128, window_all, 0.0)
        }.items():
            q, k, v = normal((B, T, H, d)), normal((B, T, Hk, d)), \
                normal((B, T, Hk, d))
            dout = normal((B, T, H, d))
            lib_ms = lib_bwd_ms = None
            if window >= T and cap == 0.0:
                lib_ms = time_ms(lambda q=q, k=k, v=v: torch.nn.functional
                                 .scaled_dot_product_attention(
                                     q.transpose(1, 2), k.transpose(1, 2),
                                     v.transpose(1, 2), is_causal=True,
                                     enable_gqa=True))
                qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
                sd = torch.nn.functional.scaled_dot_product_attention(
                    qg.transpose(1, 2), kg.transpose(1, 2),
                    vg.transpose(1, 2), is_causal=True,
                    enable_gqa=True).transpose(1, 2)
                lib_bwd_ms = time_ms(lambda: torch.autograd.grad(
                    sd, (qg, kg, vg), dout, retain_graph=True), reps=10)
                del qg, kg, vg, sd
            b_ms, b_by = rl.bound(*rl.flash_work(B, T, H, Hk, d, window, 2),
                                  rl.BF16_OPS_PER_S)
            row = {"kind": "kernel", "name": "flash_attention",
                   "layer": name, "shape": [B, T, H, Hk, d],
                   "window": min(window, T), "softcap": cap,
                   "ms": time_ms(lambda q=q, k=k, v=v, w=window, c=cap:
                                 flash_attention(q, k, v, w, c), reps=10),
                   "sdpa_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by}
            if hasattr(fmod, "flash_attention_fwd"):
                out, lse = fmod.flash_attention_fwd(q, k, v, window, cap,
                                                    want_lse=True)
                row["lse_ms"] = time_ms(
                    lambda q=q, k=k, v=v, w=window, c=cap:
                    fmod.flash_attention_fwd(q, k, v, w, c, want_lse=True),
                    reps=10)

                def bwd(q=q, k=k, v=v, w=window, c=cap):
                    return fmod.flash_attention_bwd(q, k, v, out, lse, dout,
                                                    w, c)
                bwd_reps = 10
            else:
                def bwd(q=q, k=k, v=v, w=window, c=cap):
                    return fmod.flash_attention_bwd(q, k, v, dout, w, c)
                bwd_reps = 3
            bb_ms, bb_by = rl.bound(
                *rl.flash_bwd_work(B, T, H, Hk, d, window, 2),
                rl.BF16_OPS_PER_S)
            emit(row)
            emit({"kind": "kernel", "name": "flash_attention_bwd",
                  "layer": name, "shape": [B, T, H, Hk, d],
                  "window": min(window, T), "softcap": cap,
                  "ms": time_ms(bwd, reps=bwd_reps),
                  "sdpa_bwd_ms": lib_bwd_ms, "bound_ms": bb_ms,
                  "bound_by": bb_by})
            del q, k, v, dout

    # ---- the frontier pull: chip_smoke.py's BFS pull row list, over the
    # real slots where the tree's kernel takes row_len
    if "frontier" in only:
        auto = api.CudaBackend()
        takes_row_len = "row_len" in inspect.signature(
            ell_pull_frontier).parameters
        for gname, g in graphs.items():
            n, m, d = g.n, g.m, g.d_ell
            cnt = min(default_pull_cap(n, m, d), max(1, (m - 1) // d))
            touched = torch.zeros(n, dtype=torch.bool, device="cuda")
            touched[torch.randperm(n, generator=gen, device="cuda")[:cnt]] = \
                True
            rows_n = max(8, 1 << (cnt - 1).bit_length())
            rows = frontier_rows(touched, rows_n)
            xi = pad_values(torch.randint(0, n + 8, (n,), generator=gen,
                                          device="cuda", dtype=torch.int32))
            live = rows[rows < n].long()
            slots = int(g.in_deg[live].sum())
            srcs = g.ell_idx[live]
            distinct = int(torch.unique(srcs[srcs < n]).numel())
            br = auto._pull_frontier_block(g, rows_n, xi[:n], "min", "copy")
            kw = {"block_r": br}
            if takes_row_len:
                kw["row_len"] = g.in_deg

            def run(xi=xi, rows=rows, g=g, kw=kw):
                return ell_pull_frontier(xi, g.ell_idx, g.ell_w, rows, "min",
                                         "copy", **kw)
            full_kw = dict(block_n=auto._pull_block_n(g, xi[:n], "min",
                                                      "copy"),
                           row_len=g.in_deg, plan=auto.pull_plan(g, 1))
            want = ell_spmv(xi, g.ell_idx, g.ell_w, "min", "copy",
                            **full_kw)[rows.clamp(max=n - 1).long()]
            same = bool(torch.equal(run()[rows < n], want[rows < n]))
            b_ms, b_by = rl.bound(slots * 4 + cnt * 4 + rows_n * 8
                                  + distinct * 4, slots)
            emit({"kind": "kernel", "name": "ell_pull_frontier",
                  "graph": gname, "rows": rows_n, "live": cnt,
                  "real_slots": slots, "block_r": br,
                  "row_len": takes_row_len,
                  "ms": time_ms(run), "full_scan_ms": time_ms(
                      lambda xi=xi, g=g, full_kw=full_kw: ell_spmv(
                          xi, g.ell_idx, g.ell_w, "min", "copy", **full_kw)),
                  "bound_ms": b_ms, "bound_by": b_by,
                  "equal_to_full_scan": same})

    # ---- the CIN layer at serve_p99's shapes
    if "cin" in only:
        cgen = torch.Generator(device="cuda").manual_seed(3)
        B, F, H, D = 512, 39, 200, 10
        for layer, Hp in ((0, F), (1, H)):
            xk = torch.randn((B, Hp, D), generator=cgen, device="cuda")
            x0 = torch.randn((B, F, D), generator=cgen, device="cuda")
            w = torch.randn((H, Hp, F), generator=cgen, device="cuda") * (
                2.0 / (Hp * F)) ** 0.5
            run = (lambda xk=xk, x0=x0, w=w: cin_layer(xk, x0, w))
            lib = (lambda xk=xk, x0=x0, w=w: torch.einsum(
                "hij,bid,bjd->bhd", w, xk, x0))
            err = float((run() - lib()).abs().max())
            b_ms, b_by = rl.bound((B * Hp * D + B * F * D + H * Hp * F
                                   + B * H * D) * 4, 2 * B * H * Hp * F * D)
            emit({"kind": "kernel", "name": "cin", "layer": layer,
                  "shape": [B, Hp, F, H, D], "ms": time_ms(run),
                  "einsum_ms": time_ms(lib), "bound_ms": b_ms,
                  "bound_by": b_by,
                  "tf32_floor_ms": rl.cin_tf32_floor_ms(B, H, Hp, F, D),
                  "max_abs_err_vs_einsum": err})

    # ---- the CIN backward: the Function's, and its kernels where the
    # tree has them
    if "cin_bwd" in only:
        cmod = sys.modules["repro_torch.kernels.cin"]
        cgen = torch.Generator(device="cuda").manual_seed(5)
        for name, (B, Hp) in (("serve_p99 layer 1", (512, 200)),
                              ("train_batch layer 0", (65536, 39)),
                              ("train_batch layer 1", (65536, 200))):
            F, H, D = 39, 200, 10
            xk, x0 = (torch.randn(s_, generator=cgen, device="cuda")
                      for s_ in ((B, Hp, D), (B, F, D)))
            w = torch.randn((H, Hp, F), generator=cgen, device="cuda") * (
                2.0 / (Hp * F)) ** 0.5
            g = torch.randn((B, H, D), generator=cgen, device="cuda")
            leaves = [a.clone().requires_grad_() for a in (xk, x0, w)]
            out = cin_layer(*leaves)
            reps = 5 if B > 4096 else args.reps
            pieces = {}
            if hasattr(cmod, "cin_dx0"):
                pieces["cin_dx0"] = time_ms(
                    lambda: cmod.cin_dx0(g, xk, w), reps)
                pieces["cin_dw"] = time_ms(
                    lambda: cmod.cin_weight_grad(g, xk, x0), reps)
            ops = 3 * 2 * B * H * Hp * F * D
            emit({"kind": "kernel", "name": "cin_bwd", "shape": name,
                  "B": B, "Hp": Hp, "bwd_ms": time_ms(
                      lambda: torch.autograd.grad(out, leaves, g,
                                                  retain_graph=True), reps),
                  "pieces_ms": pieces,
                  "tf32_floor_ms": 3 * rl.cin_tf32_floor_ms(B, H, Hp, F, D),
                  "f32_bound_ms": rl.bound(0, ops)[0]})
            del out, leaves, xk, x0, w, g
            torch.cuda.empty_cache()

    # ---- walls: the tuner's picks, batched PPR and serving on kron16,
    # llama prefill
    if "walls" in only:
        g = graphs["kron16"]
        del graphs["rca"]
        auto = api.CudaBackend()
        for gname, width in (("kron16", 32),):
            x0 = torch.zeros((g.n, width), device="cuda")
            emit({"kind": "wall", "graph": gname, "run": "tuner_pick",
                  "B": width, "push_blocks": list(auto.push_blocks(
                      g, x0, "sum", "copy"))})
        order = torch.argsort(-g.out_deg.cpu(), stable=True)
        sources = [int(s) for s in order[:BATCH["kron16"]]]
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
                            backend=auto)
            torch.cuda.synchronize()
            events.clear()
            br, ms = wall_ms(lambda: api.solve_batch(
                g, "ppr", sources=sources, policy="push", backend=auto))
        finally:
            backend_module.coo_push = real
        emit({"kind": "wall", "graph": "kron16", "run": "ppr_batch_auto",
              "B": len(sources), "wall_ms": ms,
              "push_device_ms": sum(s.elapsed_time(e) for s, e in
                                    events[len(events) // 2:]),
              "steps": br.steps})
        from repro_torch.service import QueryService
        reqs = [(alg, s) for alg in ("bfs", "sssp_delta", "ppr")
                for s in sources[:16]]
        for _ in range(2):       # the first service pays the tuner probes
            svc = QueryService(g, backend=auto, slots=BATCH["kron16"])
            t0 = time.perf_counter()
            for alg, s in reqs:
                svc.submit(alg, s, **({"delta": 2.0} if alg == "sssp_delta"
                                      else {}))
            while svc.pending():
                svc.step()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        emit({"kind": "wall", "graph": "kron16", "run": "serve",
              "requests": len(reqs), "wall_s": wall, "qps": len(reqs) / wall})
        del g, svc
        torch.cuda.empty_cache()

        from repro_torch.configs.archs import full_config
        from repro_torch.kernels import ops as kernel_ops
        from repro_torch.models.transformer import init_params, prefill
        cfg = full_config("llama3.2-1b")
        params = init_params(cfg, seed=0, device="cuda")
        toks = torch.randint(0, cfg.vocab, (2, 4096), generator=gen,
                             device="cuda")
        flash_events = []
        real_flash = kernel_ops.flash_attention

        def timed_flash(*a_, **k_):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = real_flash(*a_, **k_)
            e.record()
            flash_events.append((s, e))
            return out
        kernel_ops.flash_attention = timed_flash
        try:
            _, ms = wall_ms(lambda: prefill(params, cfg, toks, "bf16"))
        finally:
            kernel_ops.flash_attention = real_flash
        torch.cuda.synchronize()
        half = flash_events[len(flash_events) // 2:]
        emit({"kind": "wall", "run": "llama3.2-1b_prefill", "B": 2, "T": 4096,
              "wall_ms": ms, "tokens_per_s": 2 * 4096 / ms * 1e3,
              "flash_device_ms": sum(s.elapsed_time(e) for s, e in half)})
    graphs.clear()
    torch.cuda.empty_cache()

    # ---- xDeepFM serving, with the CIN layers' device ms
    if "xdeepfm" in only:
        from repro_torch.configs.archs import full_config
        from repro_torch.kernels import ops as kernel_ops
        from repro_torch.models.recsys import xdeepfm_apply, xdeepfm_init
        cfg = full_config("xdeepfm")
        params = xdeepfm_init(cfg, seed=0, device="cuda")
        xgen = torch.Generator(device="cuda").manual_seed(2)
        cin_events = []
        real_cin = kernel_ops.cin_layer

        def timed_cin(*a_, **k_):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = real_cin(*a_, **k_)
            e.record()
            cin_events.append((s, e))
            return out
        kernel_ops.cin_layer = timed_cin
        try:
            for name, B, reps in (("serve_p99", 512, 20),
                                  ("serve_bulk", 262144, 3)):
                ids = torch.randint(0, cfg.vocab_per_field,
                                    (B, cfg.n_fields), generator=xgen,
                                    device="cuda")
                run = (lambda ids=ids: torch.sigmoid(
                    xdeepfm_apply(params, cfg, ids)))
                wall_ms(run)
                cin_events.clear()
                lat = [wall_ms(run)[1] for _ in range(reps)]
                torch.cuda.synchronize()
                nl = len(cfg.cin_layers)
                cin_ms = [s.elapsed_time(e) for s, e in cin_events]
                per_layer = [statistics.median(cin_ms[i::nl])
                             for i in range(nl)]
                emit({"kind": "wall", "run": "xdeepfm_" + name, "B": B,
                      "reps": reps, "ms_median": statistics.median(lat),
                      "rows_per_s": B / statistics.median(lat) * 1e3,
                      "cin_ms_per_layer": per_layer})
        finally:
            kernel_ops.cin_layer = real_cin
    return _write(args.out, lines)


def _write(out, lines) -> int:
    if out:
        with open(out, "a") as f:
            for obj in lines:
                f.write(json.dumps(obj) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
