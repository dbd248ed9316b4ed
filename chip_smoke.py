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
     msg {copy, mul, add} × payload [n] / [n, 3] (and [n, 33] for
     the two pulls and the scan ``coo_push``), on small ragged graphs (a
     hub, empty rows, self loops, duplicate edges, m = 0, and a hub of
     12,293 in-edges that splits the pull's rows and the push's bins);
     ``ell_spmv`` over whole rows and over ``row_len = in_deg``, and
     ``ell_pull_frontier`` the same way on a list of touched rows and on
     a list of sentinels only, each called twice for the same bits; then
     ``"mxu_grid"``, the one-hot push against its plain versions over
     the same cells at B ∈ {1, 3, 8, 16, 32, 33} on those graphs (the
     12,293 hub among them) plus a star whose hub tile is cut across
     units, float32 sums also on a payload spanning 2^80.
     Integers, min and max must agree bit for bit, float sums to
     rtol = atol = 1e-5 (the one-hot push's against the float64 plain
     sum, and against its float32 plain version on absolute payloads;
     every destination within 2 · 2^-24 · Σ|terms| of the float64 sum;
     on the signed payloads its gap to the float32 plain version may not
     exceed that version's own gap to the float64 sum plus
     1e-5 (1 + |sum|)).
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
     Then ``"push_choice"``: the main path's width-1 min solves (BFS
     under gs, SSSP under push) through the backends pinned to the
     scan and to the one-hot push and the autotuned one, walls and push
     device ms side by side, answers equal.
  6. Each kernel at its path's shapes (the one-hot push at width 1 and
     at the serving width, and its window reduce on the BFS push,
     timed beside the scan): held against its plain version,
     then timed with CUDA events (L2 flushed before each launch) beside
     the plain version, the bound of the card and, where one PyTorch
     call computes the same function, ``torch.sparse.mm`` on the CSR of
     the same graph (a yardstick the port never calls). ``ell_spmv``
     runs as the main path calls it (``row_len = in_deg``, the backend's
     row plan) at width 1 and at the serving width; the frontier pull
     (``row_len = in_deg``) beside the full-scan pull of the same payload,
     its yardstick, since it reads a subset of the full scan's bytes.
     Then ``"ppr_step"``'s row (``ppr_step_row``): batched PPR's fused
     pull and update (``ell_spmv_ppr_step``) on a uniform random graph
     of 2^21 vertices at width 64, bit for bit the unfused step (the
     padded payload, ``ell_spmv``, ``ppr_update``) and timed beside it.
  7. ``"model_kernel_grid"``: flash attention against its plain version
     over head dim {16, 32, 64, 128, 256} × T {1, 63, 129, 130, 300,
     4096} × GQA group {1, 2, 4, 8} × window {global, 17, 4096} ×
     softcap {0, 50} × {bf16, f32}; its backward kernel against
     ``flash_attention_bwd_plain`` on the same output and logsumexp over
     head dim × dtype × T {1, 130, 200, 384, 1000, 2048} × group ×
     window {global, 17} × softcap (T = 200 and 1,000 leave a ragged
     last tile of 64 queries and of 64 or 128 keys; at 2,048 up to 32
     key tiles add into one dQ tile in turn) (each gradient within 1e-4
     f32, 1e-2 bf16 of its largest
     entry; two launches equal bit for bit; the forward's logsumexp
     within 1e-5 of the plain one's); the CIN layer over B {1, 37, 512} ×
     (Hp, F, H, D) {(39, 39, 200, 10), (200, 39, 200, 10), (5, 4, 7, 6),
     (200, 39, 70, 10), (13, 9, 37, 3)} × {f32, bf16}: H = 200 on its
     fitted product width, odd H on the general one, K split at B = 1
     and 37; its dw and dx0 kernels over the same cells and (20, 41, 9,
     4), (7, 7, 8, 6), (13, 230, 37, 3) (F padded to 200 and 40 by dx0,
     and in two blocks of 200), each within 1e-4
     of its largest entry (dx0 in bf16: 2e-2), two launches equal bit
     for bit.
  8. Main path of slice 3, model serving, weights from seeded
     generators on the card: llama3.2-1b (full config) prefills B = 2 ×
     T = 4,096 (twice: the first pays the GEMM heuristics and the
     allocator, the second is timed and profiled) and decodes 32 tokens;
     gemma2-9b at full width, 2 layers, prefills 1 × 8,192 (the 4,096
     window binds, the ring cache is built) and decodes 16; xDeepFM
     (full config) serves ``serve_p99`` (B = 512), ``serve_bulk``
     (B = 262,144) and ``retrieval_cand`` (1 M candidates). Each
     phase's JSON line lists its cuts under ``reduced``. After the
     launch counts are read: each LM's prefill with the flash kernel
     against ``attn_impl="naive"`` (logits and cache) and its first
     decode step against a prefill one token longer; xDeepFM with the
     kernel against the plain CIN at serve_p99 and on 4,096 rows of the
     bulk batch, retrieval against a float64 recomputation.
  9. Main path of slice 7 (run after 5), ``"solve_more"``: on the two
     graphs, ``solve(..., backend="cuda")`` for WCC (gs, push, pull),
     δ-PageRank (push, pull; tol = 1e-2 / n), Brandes BC (pull; 2
     sources on rca, 8 on kron16, the first in the largest component),
     Boman coloring (push), Borůvka MST (pull) and triangle count (pull,
     rca only),
     then PageRank with Partition-Awareness (16 parts, 20 iterations),
     each with the launch counts zeroed before it and read after it.
     WCC, δ-PR and BC must launch a pull and a push kernel between
     them, BC the frontier pull; coloring, MST and triangle count run
     local steps and launch none. Each answer against the dense backend
     on the card and a host oracle (scipy's components and spanning
     tree, a float64 numpy Brandes and power iteration, (A·A)∘A); the
     PA ranks within 1e-6 of slice 1's PageRank push, with fewer locks.
     Then the two kernel shapes slice 7 adds (BC's float32-sum frontier
     pull, δ-PR's scan push), timed as in 6. BC is held to the float64
     oracle on every finite entry through both backends: the dense
     backend's ``segment_sum`` sums float32 in float64 on the card, and
     a probe of two 2^-130 terms through it must not read 0.
 10. Main path of slice 8 (run after 9), ``"observe"``, through the
     autotuned backend: on both graphs BFS (auto) and PageRank (pull)
     with and without a ``Telemetry`` handle, equal bit for bit (state,
     Cost, steps, StepTrace), one timed ``step`` event per step whose
     sum stays within the ``solve:*`` span; the walls, the median push
     and pull step times and the AutoSwitch audit are printed; SSSP
     (push), a phase program, audited on the predicted basis. The trace
     is written as JSONL and as a Chrome trace under ``build/observe``
     and validated. Then BFS (gs) on rca with a checkpoint every 64
     steps under an ``engine.step`` fault every 500 hits, equal to the
     fault-free solve with at least one fault and one resume; PageRank
     under ``check_finite="nan"``, and BC on rca, whose float32 σ
     overflows, raising ``DivergenceError``; and a ``QueryService`` with
     telemetry on kron16 answering the 48 requests of 5 under
     ``ci-default``'s three service sites, equal to a fault-free
     service, with chunk retries, cache errors and ``service.*`` and
     ``resilience.*`` events. ``ell_spmv``, ``ell_pull_frontier`` and a
     push kernel must launch, with no fallback.
 11. Each model kernel at its path's shapes, on the path's own inputs,
     timed as in 6, beside ``scaled_dot_product_attention`` (causal,
     GQA; the llama layer) and ``torch.einsum`` (the CIN layer, whose
     row adds its 3xTF32 floor beside the f32 bound).
 12. Main path of slice 9 (run after 10, before the
     kernel timings of 6 and the model phases), ``"shard"``: the sharded
     engine at full size on both graphs, four shards on one card
     (``make_shard_mesh(4, devices=[cuda] * 4)``; the "wire" is copies
     in the card's memory, not NVLink), the ``ell_spmv`` kernel inside
     each shard's pull (``inner="cuda"``): BFS (auto), PageRank (push,
     pull; 20 iterations) and SSSP (push); ``DistributedBackend`` at
     P = 4 for BFS and PageRank (push, pull); ``backend="shard"`` on the
     default mesh (a shard per card; PageRank pull on both graphs, BFS
     on kron16). Each run once plain (its wall) and, but SSSP (a phase
     program), once under telemetry (its median step time;
     bit-identical), and
     held against the main path's autotuned CUDA run and the dense run:
     integers, min and max bit for bit, float sums to 1e-5 relative.
     Then ``predict_comm_bytes`` against the charged bytes of one push
     and one pull step with the real cut; on kron16 one
     ``shard.exchange.push`` fault retried to the same bits, and
     PageRank push with top-k (1 %) and int8 compression, stepped by
     hand: each step's error carry against the sent message and the
     delivered sums, the wire bytes against the formula, the distance
     from the uncompressed ranks. ``ell_spmv`` must launch and no
     sharded pull may give way to the ELL executor. The card's busy
     share over one sharded PageRank pull, and ``ell_spmv`` at the
     shard shape (four [n/4, d_ell] blocks against the gathered vector)
     at width 1 and the serving width, timed as in 6 beside
     ``torch.sparse.mm`` on each shard's CSR rows.

 13. Main path of slice 10 (run after 11), ``"train"``: llama3.2-1b at
     full width through ``TrainLoop`` (8 × 4,096 in 4 microbatches,
     AdamW, 5 steps, per-layer remat; a checkpoint at step 3 written by
     ``save_async``, the step-5 directory removed as a crash before its
     commit would leave it, and a fresh loop on the directory resuming
     at 3 and running to 5: its losses against the uninterrupted run's,
     bit for bit or within 2e-3); gemma2-9b at full width, 2 layers,
     1 × 4,096, 3 steps (softcap and window through the backward);
     xDeepFM at full width through ``launch.train.main`` at train_batch
     (B = 65,536, BCE, 5 steps). One line per run: step ms, tokens/s or
     rows/s, model FLOPs against the bf16 peak, peak memory, the
     attention's forward launches and backward calls, the CIN's
     forward and its backward's dxk, dw and dx0 kernels per layer, a
     profiled step's busy share, the card's name and power limit,
     ``reduced``. ``flash_attention``, ``flash_attention_bwd``, ``cin``,
     ``cin_dw`` and ``cin_dx0`` must launch, and neither
     ``flash_attention_bwd_plain`` nor CIN's plain dw and dx0 may run.
     Then
     ``"train_check"``: llama at full width, 2 layers, bf16 and f32,
     every gradient with the kernel against ``attn_impl="naive"``
     (‖Δg‖/‖g‖ ≤ 5e-2 bf16, 1e-4 f32); xDeepFM's gradients on 4,096
     rows against the loss on ``cin_layer_plain`` (1e-4), and the CIN
     kernel after an in-place AdamW step against the plain layer on the
     updated weights. ``"train_grad"`` lines: each Function's gradients
     at the layer shapes (llama, gemma2 local at T = 8,192 where the
     window binds, gemma2 global; CIN at serve_p99 and train_batch)
     against autograd through the plain versions (relative to the
     largest entry: flash 1e-2 bf16, 1e-4 f32; CIN 1e-4), the backward
     timed beside the plain autograd backward, SDPA's backward where it
     computes the same function, and the bound; the flash backward
     kernel (also at deepseek-moe-16b's layer) beside its plain
     recompute, against the bound of its five products; CIN's dw and dx0
     kernels against their plain versions, timed beside the route each
     replaced (the chunked GEMM; a layer launch of width 64 on
     w.permute(2, 0, 1)), their plain versions and one ``einsum`` each,
     the three products' 3xTF32 floor beside one TF32 pass of them. Then
     the CIN layer at train_batch's shapes (B = 65,536) beside
     ``einsum``.
 14. Main path of slice 11, the GNN family (run after 13), ``"gnn"``:
     EGNN, GIN, GraphSAGE and GraphCast at full width (``full_config``,
     the reference's cell widths: d_in the shape's features, d_out its
     classes, 1 for molecule, graphcast's 227 variables) train 3 AdamW
     steps each under ``direction`` "pull" and "push" through
     ``TrainLoop``, with the reference cell's losses, on full_graph_sm
     (``erdos_renyi`` at 2,708 nodes and ~10,556 edges) and molecule
     (128 graphs of 30 atoms), uncut; on minibatch_lg's sampled subgraph
     (1,024 seeds, fanout (15, 10): 169,984 nodes, 168,960 edges,
     ``sample_blocks`` on the full 232,965-node, ~114.6 M-edge graph) and
     on ogb_products (2.45 M nodes, ~61.9 M edges; GIN and GraphSAGE).
     The two large graphs are built on the card (uniform pairs, both
     directions, no self loops or duplicates). One line per run: step
     ms, peak memory, losses. Checks: push equals pull; at full_graph_sm
     and molecule the card's forward equals the port's CPU forward in
     float64; every loss is finite. ``"gnn_blocks"``: GraphSAGE through
     ``sage_apply_blocks`` on blocks sampled from the full minibatch_lg
     graph each step; ``"gnn_mp"``: ``gin_apply_mp`` on four shards on
     one card against ``gin_apply`` at full_graph_sm and ogb_products.
     The path reaches no kernel of the repo (its sums are
     ``segment_sum``'s float64 ``index_add_``, chunked).
 15. Main path of slice 11, the MoE family, ``"moe"``: deepseek-moe-16b
     at full depth (28 layers, bf16) prefills 1 × 4,096 with the flash
     kernel and decodes 16 tokens, moonshot-v1-16b-a3b the same at 4 of
     48 layers (``"lm_prefill"``/``"lm_decode"`` lines with ``"path":
     "moe"``: tokens/s, ms a step, busy share, top kernels); then
     deepseek-moe-16b trains at 4 layers, 1 × 4,096, 3 steps through
     ``TrainLoop``. Checks, with the routers' expert choices pinned
     (``RoutePin``: two bf16 runs see router logits ~1e-2 apart, and
     near-tied experts flip; the unpinned flipped share is printed):
     prefill with the kernel against ``attn_impl="naive"`` and the first
     decode step against a prefill one token longer (at a capacity that
     drops nothing), within LM_TOL scaled to depth past 16 layers; the
     first layer's MoE FFN with push against pull dispatch; the flash
     kernel at deepseek's layer shape timed beside SDPA;
     ``moe_apply_ep`` on four shards on one card ("psum" with f32 and
     bf16 combine, "a2a") against ``moe_apply`` at S = 4,096 in bf16
     and f32; the gradients at 2 layers with the kernel against the
     plain path (bf16 5e-2, f32 1e-4).

 16. Slice 12, the cell registry and the dry run (run after 15).
     ``"legacy"`` (right after slice 1's answers): ``bfs``, ``sssp_delta``
     and ``personalized_pagerank`` on rca equal ``api.solve``'s states.
     ``"cells"``: ``launch.dryrun.run_cell`` over the 40 cells at the
     single-pod (16 × 16) and multi-pod (2 × 16 × 16) layouts on
     ``meta``, in one worker process per CPU core (the card idles): one
     line per cell with its FLOPs (PyTorch operators plus the kernels'
     counted work), ``model_flops``, bytes accessed, argument bytes per
     device and in all, the one-controller peak, ``fits_one_card``, the
     wire bytes of the explicit exchanges and the roofline terms on one
     H100; graphcast@minibatch_lg and egnn@ogb_products must not fit
     (the card ran out on them in earlier runs). ``"hillclimb"``: one
     variant of each of the three cells (qwen ``v1_pad_heads``, gin
     ``v1_shard_all``, deepseek ``v1_bf16_combine``), in the same pool.
     ``"cells_card"``: every cell whose predicted arguments and peak stay
     within 70 GB (xDeepFM's four, the GNN cells that fit, llama3.2-1b at
     long_500k among them) built on the card with seeded random weights
     and inputs and run three times: the first run's peak
     (``max_memory_allocated`` past the bytes held before it) within
     ±20 % of the dry run's, its outputs finite and of the dry run's
     bytes; the second's FLOPs, counted the dry run's way, equal to the
     meta count; the third's wall. ``cin`` must launch.
     ``"service_bench"``: ``service.bench.sweep(smoke=True)`` through
     the autotuned CUDA backend, the reference's ``service_*`` rows.
     ``"memory"`` lines give the bytes the card still holds after each
     late phase.

Launch counts are zeroed just before each main path and read just after
it; every kernel of the path must have launched and no step of the graph
paths may have fallen back to the plain primitives. The line before the last is
``{"kernels": [...]}``; the last is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import api  # noqa: E402
from repro_torch.core import backend as backend_module  # noqa: E402
from repro_torch.core.cost_model import Cost  # noqa: E402
from repro_torch.core.direction import Direction, Fixed  # noqa: E402
from repro_torch.graphs import (GRAPH_ARRAYS, Graph,  # noqa: E402
                                SampledBlocks, build_graph, erdos_renyi,
                                graph_from_arrays, kronecker, sample_blocks,
                                standin, star)
from repro_torch.graphs.structure import pad_values  # noqa: E402
from repro_torch.configs import (ARCH_FAMILY, all_cells,  # noqa: E402
                                 build_cell)
from repro_torch.configs.archs import full_config  # noqa: E402
from repro_torch.core import algorithms as legacy_algs  # noqa: E402
from repro_torch.configs.shapes import GNN_SHAPES  # noqa: E402
from repro_torch.data import (molecule_batches, recsys_batches,  # noqa: E402
                              token_batches)
from repro_torch.dist.sharding import (set_activation_mesh,  # noqa: E402
                                       tree_bytes_per_device)
from repro_torch.dist.overlap import value_and_grad  # noqa: E402
from repro_torch.kernels import _build, tune  # noqa: E402
from repro_torch.kernels import cin as cin_module  # noqa: E402
from repro_torch.kernels import ops as kernel_ops  # noqa: E402
from repro_torch.kernels.cin import (cin_dx0, cin_dx0_plain,  # noqa: E402
                                     cin_layer, cin_layer_plain,
                                     cin_weight_grad, cin_weight_grad_plain)
from repro_torch.kernels.coo_push import (build_push_plan,  # noqa: E402
                                          coo_push, coo_push_mxu_plain,
                                          coo_push_plain)
from repro_torch.kernels.ell_pull_frontier import (  # noqa: E402
    default_pull_cap, ell_pull_frontier, ell_pull_frontier_plain,
    frontier_plan, frontier_rows)
from repro_torch.kernels.ell_spmv import (  # noqa: E402
    PPR_STEP_MAX_WIDTH, _msg_dtype, apply_msg, ell_spmv, ell_spmv_plain,
    ell_spmv_ppr_step, ell_spmv_ppr_step_plain, gather_rows_plain,
    ppr_update)
from repro_torch.kernels.roofline import (  # noqa: E402
    BF16_OPS_PER_S, F32_OPS_PER_S, TF32_OPS_PER_S, bound, cin_bwd_work,
    cin_tf32_floor_ms, cin_work, flash_bwd_work, flash_work,
    onehot_floor_ms, push_bytes, time_ms)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    GLOBAL_WINDOW, HEAD_DIMS, flash_attention, flash_attention_bwd,
    flash_attention_bwd_plain, flash_attention_fwd,
    flash_attention_plain_gqa)
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.dryrun import count_step, run_cell  # noqa: E402
from repro_torch.launch.hillclimb import main as hillclimb_main  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import gnn as gnn_module  # noqa: E402
from repro_torch.models import moe as moe_module  # noqa: E402
from repro_torch.models import transformer as transformer_module  # noqa: E402
from repro_torch.models.common import (param_count,  # noqa: E402
                                       tree_leaves, tree_map,
                                       tree_size_bytes)
from repro_torch.models.recsys import (  # noqa: E402
    cin_apply, retrieval_score, xdeepfm_apply, xdeepfm_init)
from repro_torch.models.transformer import (decay_mask,  # noqa: E402
                                            decode_step, init_params,
                                            lm_loss, pad_kv_cache, prefill)
from repro_torch.service import QueryService  # noqa: E402
from repro_torch.service.bench import sweep as bench_sweep  # noqa: E402
from repro_torch.shard import ShardedBackend, make_shard_mesh  # noqa: E402
from repro_torch.sparse.segment import (reduce_identity,  # noqa: E402
                                       segment_sum)
from repro_torch.train import (LoopConfig, OptConfig,  # noqa: E402
                               TrainLoop, apply_updates, init_opt)
from repro_torch.train.losses import (bce_with_logits, mse,  # noqa: E402
                                      softmax_xent_dense)

# the module (the package exports its function under the same name)
flash_module = sys.modules["repro_torch.kernels.flash_attention"]

KERNEL_INFO = {
    "ell_spmv": ("src/repro_torch/kernels/csrc/ell_spmv.cu",
                 "src/repro/kernels/ell_spmv.py:97"),
    # the full-scan pull with batched PPR's update as its epilogue
    "ell_spmv_ppr": ("src/repro_torch/kernels/csrc/ell_spmv.cu",
                     "src/repro/kernels/ell_spmv.py:97"),
    "ell_pull_frontier": ("src/repro_torch/kernels/csrc/ell_pull_frontier.cu",
                          "src/repro/kernels/ell_pull_frontier.py:112"),
    "coo_push": ("src/repro_torch/kernels/csrc/coo_push.cu",
                 "src/repro/kernels/coo_push.py:312"),
    "coo_push_mxu": ("src/repro_torch/kernels/csrc/coo_push_mxu.cu",
                     "src/repro/kernels/coo_push.py:241"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:65"),
    # its gradient: the reference differentiates blockwise_sdpa instead
    "flash_attention_bwd": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "src/repro/kernels/flash_attention.py:65"),
    "cin": ("src/repro_torch/kernels/csrc/cin.cu",
            "src/repro/kernels/cin.py:39"),
    # CIN's gradients: the reference differentiates cin_apply's einsums in
    # XLA (src/repro/models/recsys.py), around this kernel's function
    "cin_dw": ("src/repro_torch/kernels/csrc/cin_bwd.cu",
               "src/repro/kernels/cin.py:39"),
    "cin_dx0": ("src/repro_torch/kernels/csrc/cin_bwd.cu",
                "src/repro/kernels/cin.py:39"),
}
# the push kernels, by the name of their device functions
PUSH_KERNELS = ("coo_push", "coo_push_mxu")
COMBINES = ("sum", "min", "max")
DTYPES = (torch.float32, torch.float64, torch.int32, torch.int64)
MSGS = ("copy", "mul", "add")
WIDTHS = (None, 3)
SMALL_N = 24
SMALL_CASES = ("ragged", "empty_rows", "self_loops", "duplicate_edges",
               "edgeless", "hub")
# in-edges of the hub case's hub: split into pieces of the full-scan
# pull at every width (8,192 slots at width 1) and into scan-push units
HUB_DEG = 3 * 4096 + 5
# a payload of two column tiles (33 columns), which the kernel grid also
# gives the full-scan pull and the scan push
WIDE = 33
# payload widths of the one-hot push's grid: one column, an odd few, one
# and two column tiles of its tensor-core path, and 8 and 32
MXU_WIDTHS = (None, 3, 8, 16, 32, 33)

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
    no in-edges, self loops, duplicate edges, no edges at all, and a hub
    of ``HUB_DEG`` in-edges (duplicate sources) over sparse other rows."""
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
    elif case == "hub":
        m = 2 * n
        src = rng.randint(0, n, size=HUB_DEG + m)
        dst = np.concatenate([np.full(HUB_DEG, n // 3),
                              rng.randint(0, n, size=m)])
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


def own_layout(g) -> tuple:
    """``(idx, w, kw)``: the arrays the pull kernels read on ``g``'s own
    layout (``Graph.pull_arrays``: the dense ELL, or the CSR) and the
    keywords that name the row layout (``row_ptr``, ``d_ell``) where
    ``g`` has it; the kernels and their plain versions take both."""
    idx, w, row_ptr = g.pull_arrays
    return idx, w, ({} if row_ptr is None
                    else {"row_ptr": row_ptr, "d_ell": g.d_ell})


def kernel_grid(device) -> dict:
    """Phase 2: every (combine, dtype, msg, width) cell of every kernel
    against its plain version on the small graphs; both pulls over whole
    rows and over ``row_len = in_deg`` (the main path's call), the
    frontier pull also on a list of sentinels only and twice (the same
    bits); at width 33 the three redesigned graph kernels only. Each
    graph's pulls read its own layout (the hub cases the row layout)."""
    errs = {k: 0.0 for k in ("ell_spmv", "ell_pull_frontier", "coo_push")}
    cells, row_cases = 0, []
    gen = torch.Generator(device=device).manual_seed(0)
    for case, g in small_graphs(device).items():
        plans = [build_push_plan(g.coo_src, g.coo_dst, g.coo_w, g.n, b,
                                 device=device)
                 for b in (8, 256)] if g.m else [None]
        touched = torch.rand(g.n, generator=gen, device=device) < 0.3
        lists = (frontier_rows(touched, 16),
                 frontier_rows(torch.zeros_like(touched), 5))
        active = torch.rand(g.n, generator=gen, device=device) < 0.5
        idx, w, lk = own_layout(g)
        if lk:
            row_cases.append(case)
        for c in COMBINES:
            for dt in DTYPES:
                for msg in MSGS:
                    for width in WIDTHS + (WIDE,):
                        shape = (g.n + 1,) + (() if width is None
                                              else (width,))
                        x = payload(shape, dt, cells, device)
                        x[-1] = 0
                        tag = f"{case}/{c}/{dt}/{msg}/w{width}"
                        for row_len in (None, g.in_deg):
                            got = ell_spmv(x, idx, w, c, msg,
                                           row_len=row_len, **lk)
                            want = ell_spmv_plain(x, idx, w, c, msg,
                                                  row_len=row_len, **lk)
                            errs["ell_spmv"] = max(
                                errs["ell_spmv"], max_abs_err(
                                    got, want, c, f"ell_spmv {tag} row_len "
                                    f"{row_len is not None}"))
                        for rows in lists:
                            for row_len in (None, g.in_deg):
                                args = (x, idx, w, rows, c, msg)
                                got = ell_pull_frontier(*args,
                                                        row_len=row_len,
                                                        **lk)
                                what = (f"ell_pull_frontier {tag} rows "
                                        f"{rows.shape[0]} row_len "
                                        f"{row_len is not None}")
                                errs["ell_pull_frontier"] = max(
                                    errs["ell_pull_frontier"], max_abs_err(
                                        got, ell_pull_frontier_plain(
                                            *args, row_len=row_len, **lk),
                                        c, what))
                                if not torch.equal(got, ell_pull_frontier(
                                        *args, row_len=row_len, **lk)):
                                    fail(what + ": a second call differs")
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
          "row_layout": row_cases,
          "widths": [w for w in WIDTHS + (WIDE,)],
          "cells_per_case": cells // len(SMALL_CASES),
          "max_abs_err": errs})
    return errs


def mxu_err(x: torch.Tensor, active: torch.Tensor, g, plan, combine: str,
            msg: str, block_e: int, what: str,
            spread: bool = False) -> dict:
    """Hold the one-hot push against its plain versions; returns the
    largest absolute gap of each comparison. Integers, min and max:
    against ``coo_push_mxu_plain`` bit for bit (``"onehot_plain"``).
    Float sums: the kernel sums to float32 rounding, the plain version
    in float32 chunks (the reference's numerics), and two float32 sums
    agree to 1e-5 only where the terms do not cancel. So float sums are
    held per element to ``|kernel - sum| <= 2 · 2^-24 · Σ|terms|``, the
    float64 sum of the messages and of their magnitudes
    (:func:`term_sums`: relative precision, however far apart the
    column's magnitudes are; ``"mass_ratio"`` is the largest ``|kernel -
    sum| / Σ|terms|`` in units of 2^-24); to 1e-5 against the float64 sum on the payload
    as given (``"f64_plain_sum"``, skipped where ``spread``: the payload
    then spans beyond 1e-5's absolute scale) and against
    ``coo_push_mxu_plain`` on its absolute values
    (``"onehot_plain_abs"``); and on the payload as given, per element,
    to ``|kernel - plain| <= |plain - f64| + 1e-5 (1 + |f64|)``: no
    further from the reference's numerics than their own float32
    rounding is from the exact sum, plus 1e-5 (``"onehot_plain_signed"``
    is the largest ``|kernel - plain|``)."""
    def run(xv):
        return coo_push(xv, active, g.coo_src, g.coo_dst, g.coo_w, g.n,
                        combine, msg, plan=plan, strategy="mxu",
                        block_e=block_e)
    got = run(x)
    want = coo_push_mxu_plain(x, active, plan, g.n, combine, msg, block_e)
    if not (combine == "sum" and got.dtype.is_floating_point):
        return {"onehot_plain": max_abs_err(got, want, combine, what)}
    exact = coo_push_plain(x, active, plan, g.n, combine, msg)
    k, p, f = got.double(), want.double(), exact.double()
    total, mass = (t.reshape(f.shape) for t in term_sums(x, active, g, msg))
    over = (k - total).abs() - 2.0 * 2.0 ** -24 * mass
    if over.numel() and float(over.max()) > 0:
        i = int(over.flatten().argmax())
        fail(f"{what} (relative): {int((over > 0).sum())} entries past "
             f"2 · 2^-24 · Σ|terms|; the worst: kernel "
             f"{float(k.flatten()[i])!r}, f64 {float(total.flatten()[i])!r}"
             f", Σ|terms| {float(mass.flatten()[i])!r}")
    ratio = torch.where(mass > 0, (k - total).abs() / mass, 0.0)
    signed = (k - p).abs()
    over = signed - (p - f).abs() - 1e-5 * (1.0 + f.abs())
    if over.numel() and float(over.max()) > 0:
        i = int(over.flatten().argmax())
        fail(f"{what} (signed): {int((over > 0).sum())} entries past "
             f"|plain - f64| + 1e-5 (1 + |f64|); the worst: kernel "
             f"{float(k.flatten()[i])!r}, plain {float(p.flatten()[i])!r}, "
             f"f64 {float(f.flatten()[i])!r}")
    gaps = {"mass_ratio": float(ratio.max()) * 2.0 ** 24 if got.numel()
            else 0.0,
            "onehot_plain_signed": float(signed.max()) if got.numel()
            else 0.0}
    if spread:
        return gaps
    xa = x.abs()
    return {**gaps,
            "f64_plain_sum": max_abs_err(got, exact, combine,
                                         what + " (f64)"),
            "onehot_plain_abs": max_abs_err(run(xa), coo_push_mxu_plain(
                xa, active, plan, g.n, combine, msg, block_e), combine,
                what + " (|x|)")}


def term_sums(x: torch.Tensor, active: torch.Tensor, g,
              msg: str) -> tuple[torch.Tensor, torch.Tensor]:
    """float64 [n(, B)] twice: Σ msg(x[src], w) and Σ|msg(x[src], w)| over
    each destination's in-edges from active sources, the messages formed
    in their dtype as the pushes form them."""
    src, dst = g.coo_src.long(), g.coo_dst.long()
    m = apply_msg(x[src], g.coo_w, msg, _msg_dtype(x.dtype, g.coo_w.dtype,
                                                   msg)).double()
    keep = active[src].reshape((-1,) + (1,) * (m.ndim - 1))
    m = torch.where(keep, m, 0.0)
    out = torch.zeros((2, g.n) + tuple(m.shape[1:]), dtype=torch.float64,
                      device=x.device)
    return out[0].index_add_(0, dst, m), out[1].index_add_(0, dst, m.abs())


def spread_payload(shape, seed: int, device) -> torch.Tensor:
    """float32 normal values times 2^k, k uniform in [-40, 40] per
    element: a column spanning about 2^80."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=shape) * np.exp2(rng.integers(-40, 41, size=shape))
    return torch.from_numpy(a).to(torch.float32).to(device)


def mxu_grid(device) -> float:
    """The one-hot push against its plain versions (:func:`mxu_err`) over
    combine × dtype × msg × B ∈ {1, 3, 8, 16, 32, 33} on the small graphs
    plus a star (one hub taking every edge of its bin, cut into several
    units at block_e 64), with bins of 8 and 256 and units of 64 (256
    edges, the least) and 1,024 slots; float32 sums also on a payload
    spanning 2^80 (:func:`spread_payload`). Prints the largest gap of
    each comparison and returns the largest absolute one held."""
    gaps, cells, t0 = {}, 0, time.perf_counter()
    graphs = {**small_graphs(device), "star": star(3000, device=device)}
    gen = torch.Generator(device=device).manual_seed(5)
    for case, g in graphs.items():
        if not g.m:
            continue                  # m = 0 launches nothing (phase 2)
        plans = [build_push_plan(g.coo_src, g.coo_dst, g.coo_w, g.n, b,
                                 device=device) for b in (8, 256)]
        active = torch.rand(g.n, generator=gen, device=device) < 0.6
        for width in MXU_WIDTHS:
            for dt in DTYPES:
                for c in COMBINES:
                    for msg in MSGS:
                        shape = (g.n,) + (() if width is None else (width,))
                        xs = {"normal": payload(shape, dt, cells, device)}
                        if c == "sum" and dt == torch.float32:
                            xs["spread"] = spread_payload(shape, cells,
                                                          device)
                        for kind, x in xs.items():
                            for plan in plans:
                                for block_e in (64, 1024):
                                    for k, v in mxu_err(
                                            x, active, g, plan, c, msg,
                                            block_e,
                                            f"coo_push_mxu {case}/{c}/{dt}/"
                                            f"{msg}/w{width}/bin"
                                            f"{plan.bin_n}/be{block_e}/"
                                            f"{kind}",
                                            spread=kind == "spread"
                                    ).items():
                                        k = k if kind == "normal" else \
                                            f"{kind}_{k}"
                                        gaps[k] = max(gaps.get(k, 0.0), v)
                        cells += 1
    torch.cuda.synchronize()
    err = max(v for k, v in gaps.items()
              if k in ("f64_plain_sum", "onehot_plain_abs", "onehot_plain"))
    emit({"phase": "mxu_grid", "cases": sorted(graphs), "cells": cells,
          "widths": list(MXU_WIDTHS), "max_abs_err": err,
          "gaps": gaps, "seconds": time.perf_counter() - t0})
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
    (widths 1 and the batch widths), then build the row and bin plans
    those choices need in every backend the paths use: set-up, not the
    path."""
    tune.clear_stats()
    t0 = time.perf_counter()
    for gname, (g, _) in graphs.items():
        for width in sorted({1, BATCH[gname], serve_width(gname)}):
            for dtype, combine, mode in set(RELAX_KINDS.values()):
                shape = (g.n,) if width == 1 else (g.n, width)
                x = torch.zeros(shape, dtype=dtype, device=g.device)
                for be in backends:
                    be._pull_block_n(g, x, combine, mode)
                    be.pull_plan(g, width)
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


def main_path(graphs: dict) -> tuple[dict, dict, dict, dict]:
    """Slice 1's main path: every solve through the CUDA backend, with
    the launch counts zeroed just before and read just after. Returns
    the results and their walls (ms), by (graph, alg, policy), the
    launch counts and the backend's dispatch counters."""
    be = api.BACKEND_SHORTHANDS["cuda"]
    results, walls = {}, {}
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
            walls[(gname, alg, policy)] = wall_ms
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
    if not stats["row_layout_pulls"]:
        fail("no main-path pull read the row layout (kron16's)")
    return results, walls, counts, stats


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


def check_answers(graphs: dict, results: dict) -> dict:
    """Phase 4: the dense backend on the card and a host solver. Returns
    the dense runs, by (graph, alg, policy)."""
    dense_runs = {}
    for (gname, alg, policy), r in results.items():
        g, delta = graphs[gname]
        kw = run_kwargs(alg, delta)
        dense = api.solve(g, alg, policy=policy, backend="dense", **kw)
        dense_runs[(gname, alg, policy)] = dense
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
    return dense_runs


# -- the serving path ------------------------------------------------------
def top_sources(g, k: int) -> list[int]:
    """Distinct query vertices, highest out-degree first."""
    order = np.argsort(-g.out_deg.cpu().numpy(), kind="stable")
    return [int(order[i % g.n]) for i in range(k)]


def batch_kwargs(alg: str, delta: float) -> dict:
    return {"sssp_delta": {"delta": delta}}.get(alg, {})


class CallTimer:
    """CUDA events around every call of ``module.<name>`` (a kernel
    wrapper: the span holds its launch and no other device work), and
    the arguments of the calls made while ``keep`` is set."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.events, self.kept, self.keep = [], [], False
        self._real = getattr(module, name)

    def __enter__(self):
        def timed(*args, **kw):
            if self.keep:
                self.kept.append((args, kw))
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = self._real(*args, **kw)
            end.record()
            self.events.append((start, end))
            return out
        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self._real)

    def take_ms(self) -> list:
        """Each call's device ms since the last take, in call order."""
        torch.cuda.synchronize()
        ms = [s.elapsed_time(e) for s, e in self.events]
        self.events = []
        return ms

    def device_ms(self) -> float:
        return sum(self.take_ms())


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
                with CallTimer(backend_module, "coo_push") as timer:
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


def push_choice_phase(graphs: dict, ways: dict) -> None:
    """The main path's width-1 min solves (BFS under gs, SSSP under push,
    as in MAIN_RUNS) through the backends pinned to the scan and to the
    one-hot push and through the autotuned one: what the tuner's choice
    of push strategy costs in wall ms and push device ms. Each backend's
    plan and units are built by one push before its timed solve; the
    answers must be equal."""
    for gname, (g, delta) in graphs.items():
        for alg, policy in (("bfs", "gs"), ("sssp_delta", "push")):
            dtype, combine, mode = RELAX_KINDS[alg]
            x = torch.zeros(g.n, dtype=dtype, device=g.device)
            active = torch.ones(g.n, dtype=torch.bool, device=g.device)
            states = {}
            for way in ("scan", "mxu", "auto"):
                be = ways[way]
                block_e, bin_n, strategy = be.push_blocks(g, x, combine,
                                                          mode)
                coo_push(x, active, g.coo_src, g.coo_dst, g.coo_w, g.n,
                         combine, mode, plan=be.push_plan(g, bin_n),
                         strategy=strategy, block_e=block_e)
                torch.cuda.synchronize()
                with CallTimer(backend_module, "coo_push") as timer:
                    t0 = time.perf_counter()
                    r = api.solve(g, alg, policy=policy, backend=be,
                                  **run_kwargs(alg, delta))
                    torch.cuda.synchronize()
                    wall_ms = (time.perf_counter() - t0) * 1e3
                push_ms = timer.take_ms()
                emit({"phase": "push_choice", "graph": gname, "alg": alg,
                      "policy": policy, "way": way, "wall_ms": wall_ms,
                      "push_calls": len(push_ms),
                      "push_device_ms": sum(push_ms),
                      "push_blocks": [block_e, bin_n, strategy],
                      "steps": r.steps})
                states[way] = (r.state if isinstance(r.state, dict)
                               else {"state": r.state})
            for way in ("mxu", "auto"):
                same_states(states[way], states["scan"], False,
                            f"push_choice {gname}/{alg} {way} vs scan")


# -- slice 7: the other six algorithms ------------------------------------
SOLVE_MORE = (("wcc", "gs"), ("wcc", "push"), ("wcc", "pull"),
              ("pr_delta", "push"), ("pr_delta", "pull"),
              ("betweenness", "pull"), ("coloring", "push"),
              ("mst_boruvka", "pull"), ("triangle_count", "pull"))
EXCHANGE_ALGS = ("wcc", "pr_delta", "betweenness")
LOCAL_ALGS = ("coloring", "mst_boruvka", "triangle_count")
PA_PARTS, PA_ITERS = 16, 20
DAMP = 0.85
# BC against the float64 Brandes and the dense backend: every term of σ
# and δ is positive, so float32 sums in other orders stay within a few
# float32 roundings per level (5.4e-7 relative on CPU test graphs)
BC_RTOL = 1e-4
# δ-PR against the dense backend, L1, where both take the same steps
PR_DELTA_L1 = 1e-5


def host_components(g) -> np.ndarray:
    """Component labels of the (symmetric) graph, by scipy."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components
    src = g.coo_src.cpu().numpy()
    dst = g.coo_dst.cpu().numpy()
    a = csr_matrix((np.ones(g.m, dtype=np.int8), (src, dst)),
                   shape=(g.n, g.n))
    return connected_components(a, directed=True, connection="weak")[1]


def more_settings(gname: str, g, labels: np.ndarray) -> dict:
    """(kwargs, reduced) of each slice 7 algorithm on one graph; None
    where it does not run."""
    first = int(np.flatnonzero(labels == np.bincount(labels).argmax())[0])
    road = gname == "rca"
    bc = ({"num_sources": 2, "source_offset": first},
          {"num_sources": "2 of n: each source walks ~2,800 levels each "
                          "way at ~1 ms of host time a step"}) if road else \
        ({"num_sources": 8, "source_offset": first},
         {"num_sources": "8 of n"})
    color = ({"num_parts": 1024},
             {"num_parts": "1,024, not 16: phase 1 is a host loop over "
                           "ceil(n / P) slots (122,500 at P = 16)"}) \
        if road else ({"num_parts": 16, "C": 256},
                      {"C": "256, not 64: first fit needs 78 colors at "
                            "Kronecker scale 14 and 91 at 15"})
    return {"wcc": ({}, {}),
            "pr_delta": ({"tol": 1e-2 / g.n, "damp": DAMP},
                         {"tol": "1e-2 / n: the default 1e-6 is above the "
                                 "initial residual 0.15 / n"}),
            "betweenness": bc, "coloring": color, "mst_boruvka": ({}, {}),
            "triangle_count": ({}, {}) if road else None}


def solve_more_path(graphs: dict) -> tuple[dict, dict]:
    """Slice 7's main path: WCC, δ-PageRank and BC through the CUDA
    backend's kernels, coloring, MST and triangle count as local steps,
    and PageRank with Partition-Awareness; each run with the launch
    counts zeroed just before and read just after."""
    from repro_torch.core.algorithms import PageRankResult
    from repro_torch.core.algorithms.pagerank import pagerank_pa_prepare
    be = api.BACKEND_SHORTHANDS["cuda"]
    totals = {k: 0 for k in _build.KERNELS}
    by_alg, results = {}, {}
    for gname, (g, _) in graphs.items():
        labels = host_components(g)
        settings = more_settings(gname, g, labels)
        for alg, policy in SOLVE_MORE:
            if settings[alg] is None:
                continue
            kw, reduced = settings[alg]
            stats0 = dict(be.stats)
            tune.clear_stats()
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            r = api.solve(g, alg, policy=policy, backend="cuda", **kw)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            launches = path_launches({k: 0 for k in _build.KERNELS},
                                     probe_lines("solve_more"))
            dispatch = {k: be.stats[k] - stats0[k] for k in be.stats}
            for k, v in launches.items():
                totals[k] += v
                by_alg.setdefault(alg, dict.fromkeys(_build.KERNELS, 0))
                by_alg[alg][k] += v
            results[(gname, alg, policy)] = (r, kw, labels)
            emit({"phase": "solve_more", "graph": gname, "alg": alg,
                  "policy": policy, "backend": "cuda", "kwargs": kw,
                  "wall_ms": wall_ms, "steps": r.steps,
                  "push_steps": r.push_steps, "epochs": r.epochs,
                  "converged": r.converged, "cost": r.cost.as_dict(),
                  "launches": launches, "dispatch": dispatch,
                  "reduced": reduced})
            for k in ("fallback_pull", "fallback_push"):
                if dispatch[k]:
                    fail(f"solve_more {gname}/{alg}/{policy}: "
                         f"{dispatch[k]} steps fell back ({k})")
        t0 = time.perf_counter()
        run, split = pagerank_pa_prepare(g, PA_PARTS, iters=PA_ITERS,
                                         damp=DAMP)
        split_s = time.perf_counter() - t0
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        ranks, cost = run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        launches = _build.launch_counts()
        pa = PageRankResult(ranks=ranks, cost=cost, iterations=PA_ITERS)
        results[(gname, "pagerank_pa", None)] = (pa, {}, labels)
        emit({"phase": "solve_more", "graph": gname, "alg": "pagerank_pa",
              "kwargs": {"num_parts": PA_PARTS, "iters": PA_ITERS},
              "split_s": split_s, "cut_fraction": split["cut_fraction"],
              "wall_ms": wall_ms, "cost": cost.as_dict(),
              "launches": launches})
        if sum(launches.values()):
            fail(f"pagerank_pa on {gname} launched {launches}")
    emit({"phase": "solve_more_path", "launches": totals,
          "by_alg": by_alg})
    pulls = sum(by_alg[a][k] for a in EXCHANGE_ALGS
                for k in ("ell_spmv", "ell_pull_frontier"))
    pushes = sum(by_alg[a][k] for a in EXCHANGE_ALGS for k in PUSH_KERNELS)
    if pulls <= 0 or pushes <= 0:
        fail(f"WCC, δ-PR and BC launched {pulls} pull and {pushes} push "
             "kernels: each kind must run")
    if by_alg["betweenness"]["ell_pull_frontier"] <= 0:
        fail("BC never launched ell_pull_frontier")
    for alg in LOCAL_ALGS:
        if sum(by_alg[alg].values()):
            fail(f"{alg} runs local steps only, yet launched {by_alg[alg]}")
    return results, by_alg


def brandes_host(g, sources: list) -> tuple[np.ndarray, int]:
    """Brandes BC over ``sources`` in float64 numpy, level by level;
    returns (bc, the deepest level reached)."""
    n = g.n
    ptr = g.out_ptr.cpu().numpy().astype(np.int64)
    nbrs = g.push_dst.cpu().numpy().astype(np.int64)
    deg = np.diff(ptr)
    bc, deepest = np.zeros(n), 0
    with np.errstate(invalid="ignore", over="ignore"):
        for s in sources:
            level = np.full(n, -1, np.int64)
            level[s] = 0
            sigma = np.zeros(n)
            sigma[s] = 1.0
            frontier, dag, d = np.array([s], np.int64), [], 0
            while frontier.size:
                cnt = deg[frontier]
                u = np.repeat(frontier, cnt)
                v = nbrs[np.repeat(ptr[frontier] - np.cumsum(cnt) + cnt, cnt)
                         + np.arange(cnt.sum())]
                level[v[level[v] == -1]] = d + 1
                keep = level[v] == d + 1
                u, v = u[keep], v[keep]
                sigma += np.bincount(v, weights=sigma[u], minlength=n)
                dag.append((u, v))
                frontier = np.unique(v)
                d += 1
            deepest = max(deepest, d - 1)
            delta = np.zeros(n)
            for u, v in reversed(dag):
                pay = (1.0 + delta[v]) / sigma[v]
                delta += np.bincount(u, weights=sigma[u] * pay, minlength=n)
            delta[s] = 0.0
            bc += delta
    return bc, deepest


def pagerank_fixpoint(g, damp: float = DAMP) -> np.ndarray:
    """The PageRank fixpoint by a float64 power iteration to an L1
    change below 1e-13."""
    from scipy.sparse import csr_matrix
    src = g.coo_src.cpu().numpy()
    dst = g.coo_dst.cpu().numpy()
    a = csr_matrix((np.ones(g.m), (dst, src)), shape=(g.n, g.n))
    deg = np.maximum(g.out_deg.cpu().numpy(), 1).astype(np.float64)
    r = np.full(g.n, 1.0 / g.n)
    for _ in range(2000):
        nxt = (1 - damp) / g.n + damp * (a @ (r / deg))
        done = np.abs(nxt - r).sum() < 1e-13
        r = nxt
        if done:
            break
    return r


def rel_gaps(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """|got - want| / (|want| + 1e-6 max|want|), 0 where either is not
    finite."""
    fin = np.isfinite(got) & np.isfinite(want)
    if not fin.any():
        return np.zeros_like(got)
    scale = np.abs(want) + 1e-6 * np.abs(want[fin]).max()
    with np.errstate(invalid="ignore"):
        return np.where(fin, np.abs(got - want) / scale, 0.0)


def check_more(graphs: dict, results: dict, main_results: dict) -> None:
    """Each slice 7 answer against the dense backend on the card and an
    independent host oracle (numpy and scipy)."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import minimum_spanning_tree
    for (gname, alg, policy), (r, kw, labels) in results.items():
        g = graphs[gname][0]
        line = {"phase": "check_more", "graph": gname, "alg": alg,
                "policy": policy}
        if alg == "pagerank_pa":
            push = main_results[(gname, "pagerank", "push")]
            gap = float((r.ranks - push.state).abs().max())
            host = host_reference(g, "pagerank", {"iters": PA_ITERS})
            if not (gap <= 1e-6 and np.allclose(
                    r.ranks.double().cpu().numpy(), host, rtol=1e-4,
                    atol=1e-9)):
                fail(f"pagerank_pa on {gname}: {gap} from the PageRank "
                     "push, or off the host power iteration")
            if not int(r.cost.locks) < int(push.cost.locks):
                fail(f"pagerank_pa on {gname}: {int(r.cost.locks)} locks, "
                     f"not fewer than the push's {int(push.cost.locks)}")
            emit(line | {"max_abs_gap_to_push": gap,
                         "locks": int(r.cost.locks),
                         "push_locks": int(push.cost.locks)})
            continue
        dense = api.solve(g, alg, policy=policy, backend="dense", **kw)
        got, want = (
            {k: v.cpu() for k, v in (s.items() if isinstance(s, dict)
                                     else {"labels": s}.items())}
            for s in (r.state, dense.state))
        src = g.coo_src.cpu().numpy()
        dst = g.coo_dst.cpu().numpy()
        if alg == "pr_delta":
            bound = g.n * kw["tol"] / (1 - DAMP)
            ranks = got["ranks"].double().numpy()
            to_dense = float(np.abs(ranks - want["ranks"].double()
                                    .numpy()).sum())
            to_host = float(np.abs(ranks - pagerank_fixpoint(g)).sum())
            if policy == "push" and r.push_steps == 0:
                fail(f"pr_delta on {gname} pushed no step")
            # the two backends sum in other orders: the same steps leave
            # them float32 roundings apart (≤ 1.9e-7 read on the card);
            # a residual that flips at the tolerance changes the steps,
            # and then only the tolerance bounds the gap, 2 n tol / (1 -
            # damp)
            flip = r.steps != dense.steps
            if (to_dense > (2 * bound if flip else PR_DELTA_L1)
                    or to_host > bound + 1e-5):
                fail(f"pr_delta on {gname}/{policy}: L1 {to_dense} from "
                     f"dense ({r.steps} vs {dense.steps} steps), "
                     f"{to_host} from the fixpoint (bound {bound})")
            line |= {"l1_to_dense": to_dense, "l1_to_fixpoint": to_host,
                     "bound": bound, "steps": r.steps,
                     "dense_steps": dense.steps, "tolerance_flip": flip}
        elif alg == "betweenness":
            k = kw["num_sources"]
            sources = [(kw["source_offset"] + i) % g.n for i in range(k)]
            host, deepest = brandes_host(g, sources)
            mine = got["bc"].double().numpy()
            theirs = want["bc"].double().numpy()
            nan_same = torch.equal(got["bc"].isnan(), want["bc"].isnan())
            # where σ nears the float32 limit, (1 + δ) / σ is subnormal:
            # a float32 sum by atomics would flush such terms to zero.
            # The kernels and the dense backend's segment sums sum float32
            # in float64 on the card, so both backends are held to the
            # float64 oracle on every finite entry.
            flushes = float(segment_sum(
                torch.full((2,), 2.0 ** -130, device=g.device),
                torch.zeros(2, dtype=torch.long, device=g.device),
                1)[0]) == 0.0
            fin = np.isfinite(mine) & np.isfinite(theirs) & np.isfinite(
                host)
            off = fin & (rel_gaps(theirs, host) > BC_RTOL)
            rel_dense = float(rel_gaps(mine, theirs).max())
            rel_dense_host = float(rel_gaps(theirs, host).max())
            rel_host = float(rel_gaps(mine, host).max())
            if flushes or off.any():
                fail(f"betweenness on {gname}: the dense backend departs "
                     f"from the float64 oracle at {int(off.sum())} finite "
                     f"entries (segment_sum flushes subnormals: {flushes})")
            if not (nan_same and rel_dense <= BC_RTOL
                    and rel_host <= BC_RTOL
                    and int(got["max_level"]) == deepest):
                fail(f"betweenness on {gname}: NaN sets equal {nan_same}, "
                     f"relative gaps {rel_dense} (dense), {rel_host} "
                     f"(host), max level {int(got['max_level'])} vs "
                     f"{deepest}")
            sizes = np.bincount(labels)
            line |= {"sources": sources,
                     "sources_reaching_more_than_one": int(
                         (sizes[labels[sources]] > 1).sum()),
                     "finite": int(np.isfinite(mine).sum()),
                     "nan": int(np.isnan(mine).sum()),
                     "host_finite": int(np.isfinite(host).sum()),
                     "segment_sum_flushes_subnormals": flushes,
                     "dense_off_host": int(off.sum()),
                     "rel_gap_dense": rel_dense,
                     "rel_gap_dense_host": rel_dense_host,
                     "rel_gap_host": rel_host, "max_level": deepest}
        else:
            for key in sorted(want):
                a, b = got[key], want[key]
                if a.dtype != b.dtype or a.shape != b.shape or (
                        not torch.equal(a, b)):
                    fail(f"{alg} on {gname}/{policy} {key}: differs from "
                         "the dense backend")
            if alg == "wcc":
                mins = np.full(labels.max() + 1, g.n)
                np.minimum.at(mins, labels, np.arange(g.n))
                ok = np.array_equal(got["labels"].numpy(), mins[labels])
                line["components"] = int(labels.max() + 1)
            elif alg == "coloring":
                c = got["colors"]
                ok = (not bool(((c[src] == c[dst]) & (c[src] > 0)).any())
                      and bool((c > 0).all())
                      and int(c.max()) <= kw.get("C", 64))
                line["colors"] = int(c.max())
            elif alg == "mst_boruvka":
                w = g.coo_w.cpu().numpy().astype(np.float64)
                tree = minimum_spanning_tree(
                    csr_matrix((w, (src, dst)), shape=(g.n, g.n)))
                host_w = float(tree.sum())
                ok = (abs(float(got["weight"]) - host_w) <= 1e-6 * host_w
                      and int(got["components"]) == int(labels.max() + 1))
                line |= {"weight": float(got["weight"]),
                         "host_weight": host_w,
                         "components": int(got["components"])}
            else:
                a = csr_matrix((np.ones(g.m, dtype=np.int64), (src, dst)),
                               shape=(g.n, g.n))
                per = np.asarray((a @ a).multiply(a).sum(axis=1)).ravel()
                ok = (np.array_equal(got["per_vertex"].numpy(), per // 2)
                      and int(got["total"]) == int(per.sum() // 6))
                line["triangles"] = int(got["total"])
            if not ok:
                fail(f"{alg} on {gname}/{policy}: disagrees with the host "
                     "oracle")
        emit(line | {"equal_to_dense": True, "equal_to_host": True})


# -- slice 8: the stepwise engine, telemetry and fault injection ----------
# enough StepTrace slots for every step of rca's solves here (~2,300 BFS
# levels, ~3,000 SSSP steps)
OBSERVE_TRACE = 8192
OBSERVE_RUNS = (("bfs", "auto", {"root": 0}), ("pagerank", "pull",
                                              {"iters": 20}))


def state_dict(state) -> dict:
    return state if isinstance(state, dict) else {"state": state}


def same_runs(a, b, what: str) -> None:
    """Two solves equal bit for bit: state, Cost, steps, push steps,
    converged and every StepTrace row."""
    sa, sb = state_dict(a.state), state_dict(b.state)
    for k in sb:
        if sa[k].dtype != sb[k].dtype or not torch.equal(sa[k], sb[k]):
            fail(f"{what} {k}: differs")
    if (a.cost.as_dict(), a.steps, a.push_steps, a.converged) != (
            b.cost.as_dict(), b.steps, b.push_steps, b.converged):
        fail(f"{what}: Cost, steps or converged differ")
    if (a.trace is None) != (b.trace is None) or (
            a.trace is not None
            and a.trace.as_dict(a.steps) != b.trace.as_dict(b.steps)):
        fail(f"{what}: StepTrace rows differ")


def timed_solve(g, alg: str, **kw):
    t0 = time.perf_counter()
    r = api.solve(g, alg, backend="cuda", **kw)
    torch.cuda.synchronize()
    return r, (time.perf_counter() - t0) * 1e3


def observe_runs(graphs: dict, tel) -> None:
    """(a) flat solves with and without telemetry, (b) a phase program
    under telemetry."""
    for gname, (g, delta) in graphs.items():
        for alg, policy, kw in OBSERVE_RUNS:
            plain, plain_ms = timed_solve(g, alg, policy=policy,
                                          trace=OBSERVE_TRACE, **kw)
            seen, seen_ms = timed_solve(g, alg, policy=policy,
                                        trace=OBSERVE_TRACE, telemetry=tel,
                                        **kw)
            what = f"observe {gname}/{alg}/{policy}"
            same_runs(seen, plain, what)
            run = tel.last_run
            steps = tel.events_for(run, "step")
            (span,) = [e for e in tel.events_for(run, "span")
                       if e["name"] == f"solve:{alg}"]
            (audit,) = tel.events_for(run, "audit")
            us = [e.get("us") for e in steps]
            if len(steps) != seen.steps or None in us:
                fail(f"{what}: {len(steps)} step events for {seen.steps} "
                     "steps, or a step without its wall time")
            if sum(us) > span["dur_us"]:
                fail(f"{what}: the steps' {sum(us)} us exceed the solve "
                     f"span's {span['dur_us']} us")
            push = [e["us"] for e in steps if e["pushed"]]
            pull = [e["us"] for e in steps if not e["pushed"]]
            emit({"phase": "observe", "graph": gname, "alg": alg,
                  "policy": policy, "plain_wall_ms": plain_ms,
                  "telemetry_wall_ms": seen_ms, "steps": seen.steps,
                  "push_steps": seen.push_steps,
                  "sum_step_us": sum(us), "span_us": span["dur_us"],
                  "push_us_median": (statistics.median(push) if push
                                     else None),
                  "pull_us_median": (statistics.median(pull) if pull
                                     else None),
                  "audit": {k: audit[k] for k in
                            ("basis", "audited_steps", "flagged",
                             "mispredict_rate")}})
        r, ms = timed_solve(g, "sssp_delta", policy="push",
                            trace=OBSERVE_TRACE, telemetry=tel, source=0,
                            delta=delta)
        run = tel.last_run
        (audit,) = tel.events_for(run, "audit")
        steps = tel.events_for(run, "step")
        if audit["basis"] != "predicted" or any("us" in e for e in steps):
            fail(f"observe {gname}/sssp_delta: a phase program runs whole, "
                 f"yet its audit reads {audit['basis']}")
        emit({"phase": "observe", "graph": gname, "alg": "sssp_delta",
              "policy": "push", "telemetry_wall_ms": ms, "steps": r.steps,
              "epochs": r.epochs, "step_events": len(steps),
              "audit": {k: audit[k] for k in
                        ("basis", "audited_steps", "flagged",
                         "mispredict_rate")}})


def observe_export(tel) -> None:
    """(c) the run's events as JSONL and as a Chrome trace."""
    from repro_torch.obs import (validate_trace_file, write_chrome_trace,
                                 write_jsonl)
    out = _build.BUILD_DIR.parent / "observe"
    out.mkdir(parents=True, exist_ok=True)
    lines = write_jsonl(tel, out / "trace.jsonl")
    if validate_trace_file(out / "trace.jsonl") != lines:
        fail("observe: the JSONL trace does not validate")
    chrome = write_chrome_trace(tel, out / "trace.json")
    kinds = {}
    for e in tel.events:
        kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
    emit({"phase": "observe_export", "jsonl_lines": lines,
          "chrome_events": chrome, "events_by_kind": kinds,
          "dropped": tel.dropped})


def observe_faults(graphs: dict, more: dict) -> None:
    """(d) a checkpointed BFS under engine.step faults, and the
    divergence guard."""
    from repro_torch import resilience
    g, _ = graphs["rca"]
    plain, plain_ms = timed_solve(g, "bfs", policy="gs", root=0)
    plan = resilience.FaultPlan(name="engine-step-500", seed=7, specs=(
        resilience.FaultSpec(site="engine.step", kind="transient",
                             every=500, start=100),))
    resilience.clear_resilience_stats()
    t0 = time.perf_counter()
    with resilience.inject(plan) as inj:
        r = api.solve(g, "bfs", policy="gs", backend="cuda", root=0,
                      checkpoint_every=64)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    same_runs(r, plain, "observe rca/bfs/gs under engine.step faults")
    injected = inj.stats()["injected"].get("engine.step", 0)
    resumes = resilience.resilience_stats().get("resume.engine.step", 0)
    resilience.drain_events()
    if injected < 1 or resumes < 1:
        fail(f"observe: {injected} engine.step faults, {resumes} resumes")
    line = {"phase": "observe_faults", "graph": "rca", "alg": "bfs",
            "policy": "gs", "checkpoint_every": 64, "wall_ms": wall_ms,
            "fault_free_wall_ms": plain_ms, "steps": r.steps,
            "injected": injected, "resumes": resumes,
            "equal_to_fault_free": True}
    for gname, (g, _) in graphs.items():
        api.solve(g, "pagerank", policy="pull", backend="cuda", iters=20,
                  check_finite="nan")
    line["pagerank_check_finite"] = "passed"
    g, _ = graphs["rca"]
    _, kw, _ = more[("rca", "betweenness", "pull")]
    try:
        api.solve(g, "betweenness", policy="pull", backend="cuda",
                  check_finite="nan", **kw)
    except resilience.DivergenceError as e:
        line["bc_divergence_step"] = e.step
    else:
        fail("observe: BC on rca has NaN entries, yet check_finite passed")
    emit(line)


def service_requests(g, delta: float) -> list:
    return [(alg, s, batch_kwargs(alg, delta))
            for alg in ("bfs", "sssp_delta", "ppr")
            for s in top_sources(g, SERVE_PER_ALG)]


def observe_service(graphs: dict, tel) -> None:
    """(e) serving under the service sites of ci-default."""
    from repro_torch import resilience
    g, delta = graphs["kron16"]
    reqs = service_requests(g, delta)
    clean = QueryService(g, backend="cuda", slots=BATCH["kron16"])
    want = [clean.submit(alg, s, **kw) for alg, s, kw in reqs]
    clean.run_until_complete()
    plan = resilience.FaultPlan(name="ci-default-service", seed=7,
                                specs=tuple(
        s for s in resilience.named_plans()["ci-default"].specs
        if s.site.startswith("service.")))
    resilience.clear_resilience_stats()
    t0 = time.perf_counter()
    with resilience.inject(plan) as inj:
        svc = QueryService(g, backend="cuda", slots=BATCH["kron16"],
                           telemetry=tel)
        got = [svc.submit(alg, s, **kw) for alg, s, kw in reqs]
        svc.run_until_complete()
    wall_s = time.perf_counter() - t0
    for (alg, s, _), a, b in zip(reqs, got, want):
        same = state_dict(svc.poll(a)), state_dict(clean.poll(b))
        for k in same[1]:
            if not torch.equal(same[0][k], same[1][k]):
                fail(f"observe serve kron16/{alg} source {s} {k}: differs "
                     "from the fault-free service")
    st = svc.stats()
    names = {e.get("name", "") for e in tel.events}
    svc_events = sorted(n for n in names if n.startswith("service."))
    res_events = sorted(n for n in names if n.startswith("resilience."))
    if st["chunk_retries"] < 1 or st["cache_errors"] < 1 or not (
            svc_events and res_events):
        fail(f"observe serve: {st['chunk_retries']} chunk retries, "
             f"{st['cache_errors']} cache errors, events {svc_events} "
             f"{res_events}")
    emit({"phase": "observe_serve", "graph": "kron16",
          "requests": len(reqs), "wall_s": wall_s,
          "qps": len(reqs) / wall_s, "injected": inj.stats()["injected"],
          "chunk_retries": st["chunk_retries"],
          "cache_errors": st["cache_errors"], "failures": st["failures"],
          "service_events": svc_events, "resilience_events": res_events,
          "equal_to_fault_free": True})


def observe_path(graphs: dict, more: dict) -> dict:
    """Slice 8's main path: telemetry, checkpoints and faults through the
    autotuned CUDA backend, with the launch counts zeroed just before
    and read just after."""
    from repro_torch.obs import Telemetry
    be = api.BACKEND_SHORTHANDS["cuda"]
    stats0 = dict(be.stats)
    tune.clear_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    tel = Telemetry()
    observe_runs(graphs, tel)
    observe_export(tel)
    observe_faults(graphs, more)
    observe_service(graphs, Telemetry())
    seconds = time.perf_counter() - t0
    counts = path_launches({k: 0 for k in _build.KERNELS},
                           probe_lines("observe"))
    dispatch = {k: be.stats[k] - stats0[k] for k in be.stats}
    emit({"phase": "observe_path", "seconds": seconds, "launches": counts,
          "dispatch": dispatch})
    for name in ("ell_spmv", "ell_pull_frontier"):
        if counts[name] <= 0:
            fail(f"kernel {name} was never launched on the observe path")
    if sum(counts[k] for k in PUSH_KERNELS) <= 0:
        fail("no push kernel was launched on the observe path")
    for k in ("fallback_pull", "fallback_push"):
        if dispatch[k]:
            fail(f"{dispatch[k]} observe steps fell back ({k})")
    return counts


def distinct_sources(g, rows: torch.Tensor) -> int:
    """Distinct sources of the in-edges of ``rows`` (int64 ids), read
    from the CSR, whatever the graph's pull layout."""
    mine = torch.zeros(g.n, dtype=torch.bool, device=rows.device)
    mine[rows] = True
    return int(torch.unique(g.coo_src[mine[g.coo_dst.long()]]).numel())


def kernel_row(name: str, shape: str, err: float, kernel, plain, library,
               nbytes: float, ops: float, reps: int,
               rate: float = F32_OPS_PER_S, plain_reps: int = 0,
               **extra) -> dict:
    """One ``"kernel_time"`` line for a kernel already held against its
    plain version (``err``, the largest gap): the kernel timed with CUDA
    events (L2 flushed before each launch) beside its plain version
    (``plain_reps`` runs, else a quarter of ``reps`` and at least 3), the
    card's bound for ``nbytes`` and ``ops`` at ``rate``, and one PyTorch
    call computing the same function (``library``, or None); ``extra``
    keys (graph, path, launches, ...) join the line. Emitted and
    returned."""
    b_ms, b_by = bound(nbytes, ops, rate)
    row = {"name": name, "route": "cuda", "source": KERNEL_INFO[name][0],
           "replaces": KERNEL_INFO[name][1], "shape": shape,
           "max_abs_err": err, "ms": time_ms(kernel, reps),
           "plain_ms": time_ms(plain, plain_reps or max(3, reps // 4)),
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": (time_ms(library, reps) if library is not None
                          else None), **extra}
    emit({"phase": "kernel_time", **row})
    return row


def more_kernel_rows(gname: str, g, auto, results: dict,
                     by_alg: dict) -> None:
    """The two kernel shapes slice 7 adds to the main path, held against
    their plain versions and timed as in :func:`shaped_kernels`: the
    frontier pull of BC's float32 sums over one BFS level of its first
    source (the largest level that fits the frontier kernel) and the scan
    push of δ-PageRank's residual shares halfway through its run."""
    from repro_torch.core import Direction, Fixed, PushPullEngine
    from repro_torch.core.algorithms.pr_delta import (pr_delta_init,
                                                      pr_delta_program)
    gen = torch.Generator(device=g.device).manual_seed(7)
    n, m, d = g.n, g.m, g.d_ell
    reps = 20 if n * d < 1e8 else 8

    # BC's pull: (1 + δ) / σ of one level's vertices, summed into the
    # level above it (touched = that level)
    _, kw, _ = results[(gname, "betweenness", "pull")]
    dist = api.solve(g, "bfs", root=kw["source_offset"],
                     backend="dense").state["dist"]
    reach = dist[dist < 2147483647]
    counts = torch.bincount(reach.long())
    cap = default_pull_cap(n, m, d)
    fits = (counts <= cap) & (counts * d < m)
    lvl = int(torch.where(fits, counts, 0).argmax())
    touched = dist == lvl
    cnt = int(touched.sum())
    rows_n = min(max(8, 1 << (cnt - 1).bit_length()), cap)
    rows = frontier_rows(touched, rows_n)
    xf = torch.where(dist == lvl + 1, torch.rand(n, generator=gen,
                                                 device=g.device), 0.0)
    xp = pad_values(xf)
    live = rows[rows < n].long()
    slots = int(g.in_deg[live].sum())
    distinct = distinct_sources(g, live)
    idx, w, lk = own_layout(g)
    br = auto._pull_frontier_block(g, rows_n, xf, "sum", "copy")
    fkw = dict(block_r=br, row_len=g.in_deg, **lk)
    shape = (f"x f32[{n + 1}] rows[{rows_n}] (level {lvl}: {cnt} live, "
             f"{slots} real slots) idx[{n},{d}] ({g.pull_layout}) row_len "
             f"in_deg block_r {br} sum/copy (the BC backward pull)")
    err = max_abs_err(
        ell_pull_frontier(xp, idx, w, rows, "sum", "copy", **fkw),
        ell_pull_frontier_plain(xp, idx, w, rows, "sum", "copy",
                                row_len=g.in_deg, **lk), "sum",
        f"ell_pull_frontier at {gname} {shape}")
    kernel_row("ell_pull_frontier", shape, err,
               lambda: ell_pull_frontier(xp, idx, w, rows, "sum", "copy",
                                         **fkw),
               lambda: ell_pull_frontier_plain(xp, idx, w, rows, "sum",
                                               "copy", row_len=g.in_deg,
                                               **lk),
               None, nbytes=slots * 4 + cnt * 4 + rows_n * 4 + distinct * 4
               + rows_n * 4, ops=slots, reps=reps, path="solve_more",
               graph=gname,
               launches=by_alg["betweenness"]["ell_pull_frontier"],
               payload="float32 sum/copy")

    # δ-PageRank's push: its residual shares halfway through the run
    r, kw, _ = results[(gname, "pr_delta", "push")]
    rounds = max(1, r.steps // 2)
    prog, _ = pr_delta_program(g, **kw)
    st = PushPullEngine(program=prog, policy=Fixed(Direction.PUSH),
                        max_steps=rounds, backend=auto).run(
        g, *pr_delta_init(g, **kw)).state
    active = st["res"].abs() > kw["tol"]
    xs = torch.where(active, DAMP * st["res"]
                     / g.out_deg.clamp(min=1).float(), 0.0)
    block_e, bin_n, strategy = auto.push_blocks(g, xs, "sum", "copy")
    plan = auto.push_plan(g, bin_n)
    args = (xs, active, g.coo_src, g.coo_dst, g.coo_w, n, "sum", "copy")
    pkw = dict(plan=plan, strategy=strategy, block_e=block_e)
    a = torch.sparse_csr_tensor(g.in_ptr, g.coo_src,
                                torch.ones(m, device=g.device), (n, n))
    shape = (f"x f32[{n}] plan[{plan.nb},{plan.cap}] bin_n {plan.bin_n} "
             f"block_e {block_e} sum/copy, {int(active.sum())} of {n} "
             f"active (δ-PageRank's push after {rounds} rounds)")
    err = max_abs_err(coo_push(*args, **pkw),
                      coo_push_plain(xs, active, plan, n, "sum", "copy"),
                      "sum", f"coo_push at {gname} {shape}")
    kernel_row("coo_push", shape, err, lambda: coo_push(*args, **pkw),
               lambda: coo_push_plain(xs, active, plan, n, "sum", "copy"),
               lambda: torch.sparse.mm(a, xs[:, None]),
               nbytes=push_bytes(m, n, 1, plan.nb, plan.bin_n), ops=m,
               reps=reps, path="solve_more", graph=gname,
               launches=by_alg["pr_delta"]["coo_push"], strategy=strategy)
    torch.cuda.synchronize()


def ppr_step_row(device, scale: int = 21, width: int = 64) -> dict:
    """Row 1f: one batched PPR step on a uniform random graph of 2^scale
    vertices and 32 · 2^scale directed edges (GAP's Urand at degree 16),
    at ``width`` columns: the fused ``ell_spmv_ppr_step`` against the
    unfused step (the padded payload, ``ell_spmv``, ``ppr_update``), bit
    for bit, both timed in this call. The bound counts what the fused
    step must move: the m int32 indices, row_len, the payload, base and
    rank read once and the ranks written once."""
    n = 1 << scale
    g = card_erdos_renyi(n, 32 * n, seed=0, device=device)
    gen = torch.Generator(device=device).manual_seed(2)
    rank = torch.rand((n, width), generator=gen, device=device) / n
    base = torch.zeros((n, width), device=device)
    base[torch.randint(0, n, (width,), generator=gen, device=device),
         torch.arange(width, device=device)] = 0.15
    resid = torch.full((width,), float("inf"), device=device)
    resid[0] = 0.0                                 # one converged column
    x = rank / g.out_deg.clamp(min=1).to(torch.float32)[:, None]
    be = api.CudaBackend()
    bn = be._pull_block_n(g, x, "sum", "copy")
    plan = be.pull_plan(g, width)
    kw = dict(damp=0.85, tol=1e-6, block_n=bn, plan=plan)

    def fused():
        return ell_spmv_ppr_step(x, g.ell_idx, g.ell_w, base, rank, resid,
                                 **kw)

    def unfused():
        msgs = ell_spmv(pad_values(x), g.ell_idx, g.ell_w, "sum", "copy",
                        block_n=bn, row_len=g.in_deg, plan=plan)
        return ppr_update(base, rank, resid, msgs, 0.85, 1e-6)

    got, want = fused(), unfused()
    for a, b in zip(got, want):
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            fail("ell_spmv_ppr_step differs from ell_spmv + ppr_update")
    err = max(float((a - b).abs().max())
              for a, b in zip(got, ell_spmv_ppr_step_plain(
                  x, g.ell_idx, g.ell_w, base, rank, resid, damp=0.85,
                  tol=1e-6, row_len=g.in_deg)))
    shape = (f"x f32[{n}, {width}] idx[{n},{g.d_ell}] (m {g.m}) row_len "
             f"in_deg block_n {bn} classes {list(plan.class_off)} hub "
             f"pieces {plan.pieces} sum/copy + PPR update")
    row = kernel_row("ell_spmv_ppr", shape, err, fused,
                     lambda: ell_spmv_ppr_step_plain(
                         x, g.ell_idx, g.ell_w, base, rank, resid,
                         damp=0.85, tol=1e-6, row_len=g.in_deg),
                     None, nbytes=g.m * 4 + n * 4 + 4 * n * width * 4,
                     ops=g.m * width, reps=8, plain_reps=1,
                     unfused_ms=time_ms(unfused, 8), graph=f"urand{scale}",
                     path="ppr_step", bit_equal_unfused=True)
    del g, x, base, rank, got, want
    return row


# -- the row layout: pulls through the CSR's row offsets --------------------
ROW_SAMPLE = 256          # rows held against the plain gather: the longest
HUB_SAMPLE = 64           # rows and others drawn at random


def card_kron(scale: int, degree: int, seed: int, device) -> "Graph":
    """GAP's Kron graph as the benchmark's ``gap-kron-s21`` cell draws it
    (``perfbench/generators/kron.py``, on the card), every view built on
    the card in the row layout, which ``build_graph`` gives it."""
    from perfbench.generators import kron
    e = kron.generate(scale, degree, seed, device=device)
    return card_graph(torch.from_numpy(e["src"]), torch.from_numpy(e["dst"]),
                      e["n"], device, dense=False)


def csr_sums(x: torch.Tensor, g, cols: int = 8) -> torch.Tensor:
    """The plain full-scan sum of copied payloads over ``g``'s CSR, in
    float64: for each row, the sum of x's rows at its in-edges' sources
    (``index_add_``, ``cols`` columns at a time), [n, B]."""
    n, width = g.n, x.shape[1]
    src, dst = g.coo_src.long(), g.coo_dst.long()
    out = torch.empty((n, width), dtype=torch.float64, device=x.device)
    for c in range(0, width, cols):
        part = torch.zeros((n, min(cols, width - c)), dtype=torch.float64,
                           device=x.device)
        part.index_add_(0, dst, x[:n, c:c + cols][src].double())
        out[:, c:c + cols] = part
    return out


def within_an_ulp(got: torch.Tensor, want64: torch.Tensor,
                  what: str) -> float:
    """Hold float32 sums ``got`` against the float64 sums ``want64`` of
    the same terms: each within 2^-23 · |want| (one float32 ulp or less;
    a float64 sum rounded once to float32, as the kernels give it, lies
    within half an ulp), an empty row exactly 0. A term dropped or
    counted twice moves its row by the term, further than that wherever
    the term is above 2^-23 of the row's sum. Returns the largest gap in
    units of 2^-23 · |want|."""
    gap = (got.double() - want64).abs()
    lim = want64.abs() * 2.0 ** -23
    bad = int((gap > lim).sum())
    if bad:
        fail(f"{what}: {bad} of {got.numel()} sums further than 2^-23 of "
             f"the float64 sum over the CSR")
    return float((gap / lim.clamp(min=1e-300)).max())


def row_layout_rows(gname: str, g, width: int, device, main: dict) -> list:
    """The row layout's kernel instances (``ROWS``: each row read from
    the CSR through its offsets, ``row_ptr = in_ptr``) on ``g``, which
    has no dense ELL: each held against a plain version and timed. The
    full-scan ``ell_spmv`` with the backend's plan, float32 sum/copy at
    ``width``, against the float64 sums over the CSR (:func:`csr_sums`,
    its plain timing) within an ulp, and on ``ROW_SAMPLE`` rows (the
    ``HUB_SAMPLE`` longest, the others drawn) against the plain version's
    rows (``gather_rows_plain``); int32 min/copy at width 1 against
    ``scatter_reduce`` over the CSR, bit for bit. ``ell_pull_frontier``
    on those rows, int32 min/copy and float32 sum/copy at ``width``,
    against ``ell_pull_frontier_plain``. ``ell_spmv_ppr_step`` at
    min(width, 64) columns against the unfused step (the row layout's
    ``ell_spmv`` and ``ppr_update``), bit for bit. The bounds count the
    int32 indices (a copy reads no weight), the n + 1 row offsets, the
    payload and the output; each line carries the main path's launches
    of the kernel and its row-layout pulls (``main``)."""
    if g.pull_layout != "rows":
        fail(f"{gname}: row_layout_rows takes a row-layout graph")
    gen = torch.Generator(device=device).manual_seed(5)
    n, m, d = g.n, g.m, g.d_ell
    idx, w, lk = own_layout(g)
    be = api.CudaBackend()
    reps = 8
    tag = dict(graph=gname, path="row_layout",
               main_path_row_layout_pulls=main["dispatch"][
                   "row_layout_pulls"])
    out = []

    # the sampled rows: the longest, then drawn ones
    top = torch.argsort(g.in_deg, descending=True)[:HUB_SAMPLE]
    drawn = torch.randperm(n, generator=gen, device=device)[
        :ROW_SAMPLE - HUB_SAMPLE]
    touched = torch.zeros(n, dtype=torch.bool, device=device)
    touched[top] = touched[drawn] = True
    rows = frontier_rows(touched, ROW_SAMPLE)
    live = rows[rows < n].long()
    cnt, slots = int(live.numel()), int(g.in_deg[live].sum())

    # ell_spmv, float32 sum/copy at width
    xp = pad_values(torch.rand((n, width), generator=gen, device=device))
    plan = be.pull_plan(g, width)
    bn = be._pull_block_n(g, xp[:n], "sum", "copy")
    kw = dict(block_n=bn, plan=plan, **lk)
    got = ell_spmv(xp, idx, w, "sum", "copy", **kw)
    exact = csr_sums(xp, g)
    shape = (f"x f32[{n + 1}, {width}] CSR idx[{m}] row_ptr[{n + 1}] "
             f"(d_ell {d}) block_n {bn} classes {list(plan.class_off)} hub "
             f"pieces {plan.pieces} ({plan.hub_slots} slots) sum/copy")
    ulps = within_an_ulp(got, exact, f"ell_spmv at {gname} {shape}")
    err = max_abs_err(got, exact.float(), "sum", f"ell_spmv at {gname}")
    sample = gather_rows_plain(xp, idx, w, rows.long(), "sum", "copy", n, n,
                               None, lk["row_ptr"], d)
    ulps = max(ulps, within_an_ulp(
        got[live], sample[:cnt].double(), f"ell_spmv at {gname}: plain rows"))
    del exact, sample
    a = torch.sparse_csr_tensor(g.in_ptr, g.coo_src,
                                torch.ones(m, device=device), (n, n))
    out.append(kernel_row(
        "ell_spmv", shape, err, lambda: ell_spmv(xp, idx, w, "sum", "copy",
                                                 **kw),
        lambda: csr_sums(xp, g), lambda: torch.sparse.mm(a, xp[:n]),
        nbytes=m * 4 + (n + 1) * 4 + (2 * n + 1) * width * 4,
        ops=m * width, reps=reps, plain_reps=1, width=width,
        ulps_of_the_exact_sum=ulps,
        main_path_launches=main["launches"]["ell_spmv"], **tag))
    del got, a

    # ell_spmv, int32 min/copy at width 1, bit for bit
    xi = pad_values(torch.randint(0, n + 8, (n,), generator=gen,
                                  device=device, dtype=torch.int32))
    want = torch.full((n,), reduce_identity("min", torch.int32),
                      dtype=torch.int32, device=device)
    want.scatter_reduce_(0, g.coo_dst.long(), xi[g.coo_src.long()], "amin")
    ikw = dict(block_n=be._pull_block_n(g, xi[:n], "min", "copy"),
               plan=be.pull_plan(g, 1), **lk)
    max_abs_err(ell_spmv(xi, idx, w, "min", "copy", **ikw), want, "min",
                f"ell_spmv at {gname} int32 min/copy")
    del want

    # ell_pull_frontier on the sampled rows
    distinct = distinct_sources(g, live)
    for xf, comb, wd in ((xi, "min", 1), (xp, "sum", width)):
        br = be._pull_frontier_block(g, ROW_SAMPLE, xf[:n], comb, "copy")
        fkw = dict(block_r=br, **lk)
        fplan = frontier_plan(d, wd)
        got = ell_pull_frontier(xf, idx, w, rows, comb, "copy", **fkw)
        want = ell_pull_frontier_plain(xf, idx, w, rows, comb, "copy", **lk)
        what = f"ell_pull_frontier at {gname} {comb} width {wd}"
        err = max_abs_err(got, want, comb, what)
        extra = {}
        if comb == "sum":
            extra["ulps_of_the_plain_sum"] = within_an_ulp(
                got, want.double(), what)
        if not torch.equal(got, ell_pull_frontier(xf, idx, w, rows, comb,
                                                  "copy", **fkw)):
            fail(what + ": a second call differs")
        item = xf.element_size()
        out.append(kernel_row(
            "ell_pull_frontier",
            f"x {str(xf.dtype)[6:]}[{n + 1}, {wd}] rows[{ROW_SAMPLE}] "
            f"({cnt} live: the {HUB_SAMPLE} longest and drawn ones, "
            f"{slots} real slots) "
            f"CSR row_ptr (d_ell {d}) block_r {br} lanes {fplan.group} "
            f"pieces {fplan.pieces} of {fplan.piece} {comb}/copy", err,
            lambda xf=xf, comb=comb, fkw=fkw: ell_pull_frontier(
                xf, idx, w, rows, comb, "copy", **fkw),
            lambda xf=xf, comb=comb: ell_pull_frontier_plain(
                xf, idx, w, rows, comb, "copy", **lk),
            None, nbytes=slots * 4 + cnt * 8 + ROW_SAMPLE * 4
            + (distinct + ROW_SAMPLE) * wd * item, ops=slots * wd,
            reps=reps, plain_reps=1, width=wd,
            main_path_launches=main["launches"]["ell_pull_frontier"],
            **extra, **tag))
        del got, want

    # ell_spmv_ppr_step at min(width, 64) columns, against the unfused step
    b = min(width, PPR_STEP_MAX_WIDTH)
    rank = torch.rand((n, b), generator=gen, device=device) / n
    base = torch.zeros((n, b), device=device)
    base[torch.randint(0, n, (b,), generator=gen, device=device),
         torch.arange(b, device=device)] = 0.15
    resid = torch.full((b,), float("inf"), device=device)
    resid[0] = 0.0                                 # one converged column
    x = rank / g.out_deg.clamp(min=1).to(torch.float32)[:, None]
    plan = be.pull_plan(g, b)
    pkw = dict(damp=0.85, tol=1e-6, block_n=be._pull_block_n(
        g, x, "sum", "copy"), plan=plan, row_ptr=lk["row_ptr"])

    def fused():
        return ell_spmv_ppr_step(x, idx, w, base, rank, resid, **pkw)

    def unfused():
        msgs = ell_spmv(pad_values(x), idx, w, "sum", "copy",
                        block_n=pkw["block_n"], plan=plan, **lk)
        return ppr_update(base, rank, resid, msgs, 0.85, 1e-6)

    def plain():
        return ppr_update(base, rank, resid,
                          csr_sums(pad_values(x), g).float(), 0.85, 1e-6)

    got, want = fused(), unfused()
    for p, q in zip(got, want):
        if not torch.equal(p.view(torch.int32), q.view(torch.int32)):
            fail(f"ell_spmv_ppr_step at {gname} differs from the row "
                 "layout's ell_spmv + ppr_update")
    err = max(max_abs_err(p, q, "sum", f"ell_spmv_ppr_step at {gname}")
              for p, q in zip(got, plain()))
    out.append(kernel_row(
        "ell_spmv_ppr",
        f"x f32[{n}, {b}] CSR idx[{m}] row_ptr[{n + 1}] (d_ell {d}) "
        f"block_n {pkw['block_n']} hub pieces {plan.pieces} sum/copy + PPR "
        f"update", err, fused, plain, None,
        nbytes=m * 4 + (n + 1) * 4 + 4 * n * b * 4, ops=m * b, reps=reps,
        plain_reps=1, width=b, unfused_ms=time_ms(unfused, reps),
        bit_equal_unfused=True,
        main_path_launches=main["launches"]["ell_spmv_ppr"], **tag))
    del got, want, x, rank, base, xp, xi
    torch.cuda.synchronize()
    return out


# -- slice 9: the sharded engine -------------------------------------------
SHARDS = 4
# (algorithm, policy) of the sharded runs, and of the DistributedBackend
# runs; each is held against the main path's run of the same algorithm
# (BFS's dist and parent do not depend on the direction: both take the
# least frontier neighbour)
SHARD_RUNS = (("bfs", "auto"), ("pagerank", "push"), ("pagerank", "pull"),
              ("sssp_delta", "push"))
DIST_RUNS = (("bfs", "push"), ("bfs", "pull"), ("pagerank", "push"),
             ("pagerank", "pull"))
MAIN_OF = {("bfs", "push"): ("bfs", "pull")}
# backend="shard" (a shard per card): PageRank on both graphs, BFS on
# kron16 (rca's 2,290 host-bound BFS steps add nothing to the check)
SHORTHAND_RUNS = {"rca": (("pagerank", "pull"),),
                  "kron16": (("bfs", "auto"), ("pagerank", "pull"))}
SHARD_COMPRESSION = {"topk": 0.01, "int8": 0.01}


def same_answer(got, want, float_sum: bool, what: str) -> None:
    """Integers, min and max bit for bit; float sums to 1e-5 relative."""
    ga, wa = state_dict(got), state_dict(want)
    for k in wa:
        a, b = ga[k], wa[k]
        if a.dtype != b.dtype or a.shape != b.shape:
            fail(f"{what} {k}: {a.dtype}{tuple(a.shape)} against "
                 f"{b.dtype}{tuple(b.shape)}")
        if float_sum:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=0,
                                       msg=lambda m: f"{what} {k}: {m}")
        elif not torch.equal(a, b):
            fail(f"{what} {k}: {int((a != b).sum())} entries differ")


def shard_solve(g, alg: str, policy: str, backend, delta: float):
    """One timed solve, then, for a flat program, the same solve under a
    ``Telemetry`` handle for its step times (bit-identical, else the run
    fails; a phase program runs whole and has none)."""
    from repro_torch.obs import Telemetry
    kw = run_kwargs(alg, delta)
    r, wall_ms = synced_ms(lambda: api.solve(g, alg, policy=policy,
                                             backend=backend, **kw))
    if alg == "sssp_delta":
        return r, wall_ms, None
    tel = Telemetry()
    seen = api.solve(g, alg, policy=policy, backend=backend, telemetry=tel,
                     **kw)
    torch.cuda.synchronize()
    same_answer(seen.state, r.state, False, f"{alg}/{policy} telemetry")
    if seen.cost.as_dict() != r.cost.as_dict() or seen.steps != r.steps:
        fail(f"{alg}/{policy}: the telemetry run's Cost or steps differ")
    us = [e["us"] for e in tel.events_for(tel.last_run, "step")
          if "us" in e]
    return r, wall_ms, (statistics.median(us) / 1e3 if us else None)


def shard_line(gname: str, alg: str, policy: str, backend, run: tuple,
               main: dict, kind: str) -> dict:
    """Check one sharded or distributed run (``run``: result, wall ms,
    median step ms) against the main path's CudaBackend run and the
    dense backend (``main``: "cuda", "dense" and "wall_ms", each keyed
    by (graph, alg, policy)); print its line."""
    r, wall_ms, step_ms = run
    main_key = (gname,) + MAIN_OF.get((alg, policy), (alg, policy))
    float_sum = alg == "pagerank"
    what = f"{kind} {gname}/{alg}/{policy}"
    same_answer(r.state, main["cuda"][main_key].state, float_sum,
                what + " against cuda")
    same_answer(r.state, main["dense"][main_key].state, float_sum,
                what + " against dense")
    line = {"phase": "shard", "kind": kind, "graph": gname, "alg": alg,
            "policy": policy, "shards": backend.part.num_parts,
            "wall_ms": wall_ms, "steps": r.steps,
            "push_steps": r.push_steps, "step_ms_median": step_ms,
            "single_device_wall_ms": main["wall_ms"][main_key],
            "single_device_policy": main_key[2],
            "cut_edges": backend.cut_edges,
            "collective_bytes": int(r.cost.collective_bytes),
            "cost": r.cost.as_dict(), "equal_to_cuda": True,
            "equal_to_dense": True}
    if isinstance(backend, ShardedBackend):
        line |= {"inner": backend.inner,
                 "border_vertices": backend.topo.border_vertices,
                 "dispatch": dict(backend.stats)}
    emit(line)
    return line


def predict_check(gname: str, g, sb) -> None:
    """predict_comm_bytes against the bytes one push step and one pull
    step charge, on a sparse and a full frontier, for the float32 sum
    and int32 min payloads of the path."""
    gen = torch.Generator(device=g.device).manual_seed(3)
    dev = g.device
    lines = []
    for dtype, combine in ((torch.float32, "sum"), (torch.int32, "min")):
        vals = (torch.rand(g.n, generator=gen, device=dev)
                if dtype.is_floating_point else
                torch.randint(0, g.n, (g.n,), generator=gen, device=dev,
                              dtype=dtype))
        for name, frontier in (
                ("sparse", torch.arange(g.n, device=dev) % 97 == 0),
                ("full", torch.ones(g.n, dtype=torch.bool, device=dev))):
            pb, lb = sb.predict_comm_bytes(g, vals, frontier)
            _, cp = sb.push(g, vals, frontier, combine, None,
                            Cost.zeros(dev))
            _, cl = sb.pull(g, vals, None, combine, None, Cost.zeros(dev))
            got = (int(cp.collective_bytes), int(cl.collective_bytes))
            if got != (int(pb), int(lb)) or 0 in got:
                fail(f"shard {gname}: predicted wire bytes {int(pb)}, "
                     f"{int(lb)}; charged {got}")
            lines.append({"payload": f"{dtype} {combine}",
                          "frontier": name, "push_bytes": got[0],
                          "pull_bytes": got[1]})
    emit({"phase": "shard_predict", "graph": gname, "shards": SHARDS,
          "cut_edges": sb.cut_edges, "checks": lines,
          "predicted_equals_charged": True})


def compression_check(gname: str, g, mesh, main) -> None:
    """PageRank push with top-k and int8 compression, stepped by hand so
    that each step's error feedback can be read: per shard and element,
    what was sent (``acc + old_err − new_err``, with ``acc`` the remote
    accumulator recomputed here) is a top-k or int8 message of ``acc +
    old_err``, and the owners received the local sums plus what every
    shard sent. The wire bytes equal the formula and the last state
    equals ``api.solve``'s; its distance from the uncompressed ranks is
    printed."""
    from repro_torch.core.algorithms import pagerank_init, pagerank_program
    from repro_torch.dist import CompressionConfig
    from repro_torch.dist.collectives import place_edges
    dev = g.device
    for kind, frac in SHARD_COMPRESSION.items():
        cfg = CompressionConfig(kind, frac)
        sb = ShardedBackend.prepare(g, mesh=mesh, inner="cuda",
                                    compression=cfg)
        part, topo = sb.part, sb.topo
        npad = part.n_padded
        loc_rows = place_edges(topo.local, (dev,) * SHARDS)
        prog, iters = pagerank_program(g, iters=20)
        state, frontier = pagerank_init(g)
        err = sb.init_exchange_state(g)
        total = Cost.zeros(dev)
        worst = 0.0
        k = max(1, int(frac * npad))
        for step in range(iters):
            values = prog.values_fn(g, state, frontier)
            # one row past n_padded: padding slots name the sentinel n
            vpad = torch.cat([values, values.new_zeros(npad + 1 - g.n)])
            fpad = torch.cat([frontier, frontier.new_zeros(npad + 1 - g.n)])
            out, total, new_err = sb.relax_ex(
                g, values, frontier, direction=Direction.PUSH,
                combine="sum", msg_fn=None, cost=total, xstate=err)
            want = torch.zeros(npad, dtype=torch.float64, device=dev)
            for e in loc_rows:
                ok = e.valid & fpad[e.src.long()]
                want.index_add_(0, e.dst[ok].long(),
                                vpad[e.src[ok].long()].double())
            for p, e in enumerate(topo.remote_rows):
                # the remote accumulator, through the segment sum the
                # exchange uses (a float32 sum rounds the same way)
                ok = e.valid & fpad[e.src.long()]
                acc = segment_sum(torch.where(ok, vpad[e.src.long()], 0.0),
                                  torch.where(e.valid, e.dst.long(), npad),
                                  npad)
                s = acc + err[p]
                sent = s - new_err[p]
                if kind == "topk":
                    kept = sent != 0
                    if int(kept.sum()) > k or not (
                            torch.equal(sent[kept], s[kept])
                            and torch.equal(new_err[p][~kept], s[~kept])):
                        fail(f"shard {gname} topk step {step} shard {p}: "
                             "the error carry is not acc + err − sent")
                else:
                    scale = float(s.abs().max().clamp(min=1e-12)) / 127
                    q = sent / scale
                    if (q - q.round()).abs().max() > 1e-3 or \
                            q.abs().max() > 127 + 1e-3:
                        fail(f"shard {gname} int8 step {step} shard {p}: "
                             "what was sent is not on the int8 grid")
                want += sent.double()
            gap = (out.double() - want[:g.n]).abs() / want[:g.n].abs().clamp(
                min=1e-30)
            worst = max(worst, float(gap.max()))
            if worst > 1e-5:
                fail(f"shard {gname} {kind} step {step}: delivered sums "
                     f"{worst} from local + sent")
            state, frontier, _ = prog.update_fn(state, out, step)
            err = new_err
        r = api.solve(g, "pagerank", policy="push", backend=sb, iters=iters)
        same_answer(r.state, state, False, f"shard {gname} {kind} solve")
        per_dev = k * 8 if kind == "topk" else npad + 4
        if int(r.cost.collective_bytes) != iters * SHARDS * per_dev or \
                int(total.collective_bytes) != iters * SHARDS * per_dev:
            fail(f"shard {gname} {kind}: collective_bytes "
                 f"{int(r.cost.collective_bytes)}, formula "
                 f"{iters * SHARDS * per_dev}")
        ref = main.state
        emit({"phase": "shard_compression", "graph": gname, "kind": kind,
              "frac": frac if kind == "topk" else None, "steps": r.steps,
              "collective_bytes": int(r.cost.collective_bytes),
              "uncompressed_bytes": iters * SHARDS * npad * 4,
              "feedback_identity": True,
              "delivered_rel_gap_max": worst,
              "l1_from_uncompressed": float((r.state - ref).abs().sum()),
              "max_rel_from_uncompressed": float(
                  ((r.state - ref).abs() / ref.abs()).max()),
              "residual_l1": sum(float(e.abs().sum()) for e in err)})


def shard_fault_check(gname: str, g, sb, delta: float) -> None:
    """One injected ``shard.exchange.push`` fault, retried in place: the
    solve stays bit-identical."""
    from repro_torch import resilience
    kw = run_kwargs("bfs", delta)
    clean = api.solve(g, "bfs", policy="push", backend=sb, **kw)
    plan = resilience.FaultPlan(name="shard-push-once", seed=7, specs=(
        resilience.FaultSpec(site="shard.exchange.push", kind="transient",
                             every=1 << 30, start=2),))
    resilience.clear_resilience_stats()
    with resilience.inject(plan) as inj:
        r = api.solve(g, "bfs", policy="push", backend=sb, **kw)
    torch.cuda.synchronize()
    injected = inj.stats()["injected"].get("shard.exchange.push", 0)
    retries = resilience.resilience_stats().get(
        "retry.shard.exchange.push", 0)
    resilience.drain_events()
    same_answer(r.state, clean.state, False, f"shard {gname} under a fault")
    if injected != 1 or retries != 1 or \
            r.cost.as_dict() != clean.cost.as_dict():
        fail(f"shard {gname}: {injected} faults, {retries} retries, or "
             "the Cost moved")
    emit({"phase": "shard_fault", "graph": gname, "alg": "bfs",
          "policy": "push", "injected": injected, "retries": retries,
          "equal_to_fault_free": True})


def shard_kernel_rows(gname: str, g, sb, launches: int) -> list:
    """``ell_spmv`` at the shard shape: each of the four shards' [shard,
    d_ell] blocks (row_len = in-degree, its own row plan) against the
    gathered vector [n_padded + 1(, B)] with num_sources = n, as the
    sharded pull calls it, at width 1 and at the serving width; held
    against the plain version, then the four launches of one pull step
    timed together (and each alone), beside the four plain calls and
    ``torch.sparse.mm`` on each shard's CSR row block. The bound is
    the full pull's: the step computes the same function."""
    gen = torch.Generator(device=g.device).manual_seed(5)
    topo, part = sb.topo, sb.part
    n, m, d, s, npad = g.n, g.m, g.d_ell, part.shard_size, part.n_padded
    reps = 20 if n * d < 1e8 else 8
    ptr = g.in_ptr.long()
    csr = []
    for p in range(SHARDS):
        end = min((p + 1) * s, n)
        lo, hi = int(ptr[p * s]), int(ptr[end])
        crow = ptr[p * s:end + 1] - lo
        crow = torch.cat([crow, crow[-1:].expand(s + 1 - crow.numel())])
        csr.append(torch.sparse_csr_tensor(
            crow, g.coo_src[lo:hi].long(),
            torch.ones(hi - lo, device=g.device), (s, npad)))
    out = []
    for width in (1, BATCH[gname]):
        xp = torch.rand((npad + 1, width) if width > 1 else (npad + 1,),
                        generator=gen, device=g.device)
        xp[n:] = 0
        calls = [(topo.ell_idx[p], topo.ell_w[p], topo.row_plan(p, width))
                 for p in range(SHARDS)]

        def kernel(xp=xp, calls=calls):
            return [ell_spmv(xp, i, w, "sum", "copy", num_sources=n,
                             block_n=min(256, s), plan=pl)
                    for i, w, pl in calls]

        def plain(xp=xp, calls=calls):
            return [ell_spmv_plain(xp, i, w, "sum", "copy", num_sources=n,
                                   row_len=pl.row_len)
                    for i, w, pl in calls]

        def library(xp=xp):
            x2 = xp[:npad] if xp.ndim == 2 else xp[:npad, None]
            return [torch.sparse.mm(a, x2) for a in csr]

        err = max(max_abs_err(a, b, "sum", f"ell_spmv shard {p} at {gname}")
                  for p, (a, b) in enumerate(zip(kernel(), plain())))
        per_shard = [time_ms(lambda c=c, xp=xp: ell_spmv(
            xp, c[0], c[1], "sum", "copy", num_sources=n,
            block_n=min(256, s), plan=c[2]), reps) for c in calls]
        out.append(kernel_row(
            "ell_spmv",
            f"{SHARDS} shards × idx[{s},{d}] against x f32[{npad + 1}, "
            f"{width}] num_sources {n} row_len in_deg sum/copy (the "
            "sharded pull step)", err, kernel, plain, library,
            nbytes=m * 4 + n * 4 + (2 * n + 1) * width * 4, ops=m * width,
            reps=reps, path="shard", graph=gname, width=width,
            launches=launches, per_shard_ms=per_shard,
            pieces=[c[2].pieces for c in calls]))
    torch.cuda.synchronize()
    return out


def shard_path(graphs: dict, main: dict) -> tuple[dict, list]:
    """Slice 9's main path: the sharded engine, four shards on one card
    (``make_shard_mesh(4, devices=[cuda] * 4)``) with the ``ell_spmv``
    kernel inside each shard's pull, and ``DistributedBackend`` at P = 4,
    through ``api.solve`` on both graphs at full size; then
    ``backend="shard"`` on the default mesh (a shard per card). The launch
    counts are zeroed just before and read just after. ``main`` holds
    the single-device runs each answer is held against (see
    :func:`shard_line`)."""
    from repro_torch.shard import make_shard_mesh
    card = next(iter(graphs.values()))[0].device
    mesh = make_shard_mesh(SHARDS, devices=[card] * SHARDS)
    prepared = {}
    for gname, (g, _) in graphs.items():
        t0 = time.perf_counter()
        sb = ShardedBackend.prepare(g, mesh=mesh, inner="cuda")
        db = api.DistributedBackend.prepare(g, mesh=mesh)
        torch.cuda.synchronize()
        prepared[gname] = (sb, db)
        emit({"phase": "shard_prepare", "graph": gname, "shards": SHARDS,
              "shard_size": sb.part.shard_size,
              "n_padded": sb.part.n_padded, "cut_edges": sb.cut_edges,
              "border_vertices": sb.topo.border_vertices,
              "pull_cap": sb.topo.pull_edges.cap,
              "remote_cap": sb.topo.remote.cap,
              "prepare_s": time.perf_counter() - t0})
    tune.clear_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    for gname, (g, delta) in graphs.items():
        sb, db = prepared[gname]
        for alg, policy in SHARD_RUNS:
            shard_line(gname, alg, policy, sb,
                       shard_solve(g, alg, policy, sb, delta), main,
                       "sharded")
        for alg, policy in DIST_RUNS:
            shard_line(gname, alg, policy, db,
                       shard_solve(g, alg, policy, db, delta), main,
                       "distributed")
        default = api._resolve_backend("shard", g)
        if default.part.num_parts != torch.cuda.device_count():
            fail("backend='shard' did not take a shard per card")
        for alg, policy in SHORTHAND_RUNS[gname]:
            shard_line(gname, alg, policy, default,
                       shard_solve(g, alg, policy, "shard", delta), main,
                       "shorthand")
        predict_check(gname, g, sb)
    g, delta = graphs["kron16"]
    shard_fault_check("kron16", g, prepared["kron16"][0], delta)
    compression_check("kron16", g, mesh,
                      main["cuda"][("kron16", "pagerank", "push")])
    seconds = time.perf_counter() - t0
    counts = path_launches({k: 0 for k in _build.KERNELS},
                           probe_lines("shard"))
    dispatch = {gname: dict(sb.stats) for gname, (sb, _) in prepared.items()}
    emit({"phase": "shard_path", "seconds": seconds, "launches": counts,
          "dispatch": dispatch})
    if counts["ell_spmv"] <= 0:
        fail("ell_spmv was never launched on the shard path")
    for gname, st in dispatch.items():
        if st["fallback_pull"] or st["kernel_pull"] <= 0:
            fail(f"shard {gname}: {st['kernel_pull']} kernel pulls, "
                 f"{st['fallback_pull']} fallbacks")
    # the card's busy share over one sharded PageRank pull
    for gname, (g, _) in graphs.items():
        prof = device_profile(lambda g=g: api.solve(
            g, "pagerank", policy="pull", backend=prepared[gname][0],
            iters=20))
        emit({"phase": "shard_profile", "graph": gname, "alg": "pagerank",
              "policy": "pull", "shards": SHARDS, **prof})
    rows = []
    for gname, (g, _) in graphs.items():
        rows += shard_kernel_rows(gname, g, prepared[gname][0],
                                  counts["ell_spmv"])
    return counts, rows


# -- kernels at the main path's shapes -------------------------------------
def shaped_kernels(gname: str, g, device, ways: dict) -> list:
    """Phase 5 on one graph: each kernel at the shape the main path gives
    it, checked against its plain version and timed. The main path's
    messages are all "copy" (PageRank and BFS), so the bounds count the
    int32 indices and not the weights, which a copy never reads. The
    pulls read the graph's own layout, as the main path does (kron16's
    is the row layout)."""
    gen = torch.Generator(device=device).manual_seed(1)
    out = []
    idx, w, lk = own_layout(g)
    lay = "rows" if lk else "dense"

    def record(name, shape, got, want, combine, *timed, extra=None,
               **work):
        err = max_abs_err(got, want, combine, f"{name} at {gname} {shape}")
        out.append(kernel_row(name, shape, err, *timed, graph=gname,
                              **work, **(extra or {})))

    n, m, d = g.n, g.m, g.d_ell
    reps = 20 if n * d < 1e8 else 8

    # ell_spmv: the PageRank pull (f32 contributions, sum, copy) at
    # width 1 and the batched pull at the serving width, over the real
    # slots with the backend's row plan; the yardstick is the unweighted
    # CSR of the same graph times x. The bound counts what the call must
    # move: m int32 indices (a copy reads no weight), row_len, the
    # payload and the output.
    a = torch.sparse_csr_tensor(g.in_ptr, g.coo_src,
                                torch.ones(m, device=device), (n, n))
    auto = ways["auto"]
    for width in (1, BATCH[gname]):
        xp = pad_values(torch.rand((n, width) if width > 1 else (n,),
                                   generator=gen, device=device))
        bn = auto._pull_block_n(g, xp[:n], "sum", "copy")
        plan = auto.pull_plan(g, width)
        kw = dict(block_n=bn, row_len=g.in_deg, plan=plan, **lk)
        record("ell_spmv",
               f"x f32[{n + 1}, {width}] idx[{n},{d}] ({lay}) row_len "
               f"in_deg block_n {bn} classes {list(plan.class_off)} hub "
               f"pieces {plan.pieces} sum/copy",
               ell_spmv(xp, idx, w, "sum", "copy", **kw),
               ell_spmv_plain(xp, idx, w, "sum", "copy", row_len=g.in_deg,
                              **lk), "sum",
               lambda xp=xp, kw=kw: ell_spmv(xp, idx, w, "sum", "copy",
                                             **kw),
               lambda xp=xp: ell_spmv_plain(xp, idx, w, "sum", "copy",
                                            row_len=g.in_deg, **lk),
               lambda xp=xp: torch.sparse.mm(
                   a, xp[:n] if xp.ndim == 2 else xp[:n, None]),
               nbytes=m * 4 + n * 4 + (2 * n + 1) * width * 4, ops=m * width,
               reps=reps, extra={"width": width})

    # ell_pull_frontier: a BFS pull on the largest touched set that fits,
    # over the real slots (row_len = in_deg) as the backend calls it; its
    # yardstick is the full-scan pull of the same payload, which reads a
    # superset of its bytes. The bound counts what the call must move: the
    # listed rows' real slots (int32 indices; a copy reads no weight),
    # their row_len, the list, the distinct payload rows and the output.
    cap = default_pull_cap(n, m, d)
    cnt = min(cap, max(1, (m - 1) // d))
    touched = torch.zeros(n, dtype=torch.bool, device=device)
    touched[torch.randperm(n, generator=gen, device=device)[:cnt]] = True
    rows_n = max(8, 1 << (cnt - 1).bit_length())
    rows = frontier_rows(touched, rows_n)
    xi = pad_values(torch.randint(0, n + 8, (n,), generator=gen,
                                  device=device, dtype=torch.int32))
    live = rows[rows < n].long()
    slots = int(g.in_deg[live].sum())
    distinct = distinct_sources(g, live)
    br = auto._pull_frontier_block(g, rows_n, xi[:n], "min", "copy")
    fkw = dict(block_r=br, row_len=g.in_deg, **lk)
    plan = frontier_plan(d, 1)
    full_kw = dict(block_n=auto._pull_block_n(g, xi[:n], "min", "copy"),
                   row_len=g.in_deg, plan=auto.pull_plan(g, 1), **lk)
    record("ell_pull_frontier",
           f"x i32[{n + 1}] rows[{rows_n}] ({cnt} live, {slots} real "
           f"slots) idx[{n},{d}] ({lay}) row_len in_deg block_r {br} "
           f"lanes {plan.group} pieces {plan.pieces} of {plan.piece} "
           f"min/copy",
           ell_pull_frontier(xi, idx, w, rows, "min", "copy", **fkw),
           ell_pull_frontier_plain(xi, idx, w, rows, "min", "copy",
                                   row_len=g.in_deg, **lk), "min",
           lambda: ell_pull_frontier(xi, idx, w, rows, "min", "copy",
                                     **fkw),
           lambda: ell_pull_frontier_plain(xi, idx, w, rows, "min", "copy",
                                           row_len=g.in_deg, **lk),
           None, nbytes=slots * 4 + cnt * 4 + rows_n * 4 + distinct * 4
           + rows_n * 4, ops=slots, reps=reps,
           extra={"full_scan_ms": time_ms(
               lambda: ell_spmv(xi, idx, w, "min", "copy", **full_kw),
               reps)})

    # coo_push and coo_push_mxu: the (Personalized) PageRank push (f32,
    # sum, copy, every source active) at width 1 (slice 1) and at the
    # serving path's batch width, with the blocks the tuner gives the
    # path's backends; the yardstick is the same CSR times x
    active = torch.ones(n, dtype=torch.bool, device=device)
    for name, width, way in (("coo_push", 1, "scan"),
                             ("coo_push", BATCH[gname], "scan"),
                             ("coo_push_mxu", 1, "mxu"),
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
               nbytes=push_bytes(m, n, width, plan.nb, plan.bin_n),
               ops=m * width, reps=reps,
               extra={"width": width, "onehot_floor_ms": (
                   onehot_floor_ms(m, width) if strategy == "mxu"
                   else None)})

    # coo_push_mxu's window reduce on the BFS push (i32, min, copy,
    # width 1, every source active), which the tuner may give the one-hot
    # strategy: at the autotuned backend's blocks when it picks "mxu",
    # else at the one-hot backend's; held bit for bit against
    # coo_push_mxu_plain and timed beside the scan on the same inputs at
    # the blocks of the backend pinned to it
    xb = torch.randint(0, n + 8, (n,), generator=gen, device=device,
                       dtype=torch.int32)
    pick = auto.push_blocks(g, xb, "min", "copy")
    block_e, bin_n, _ = pick if pick[2] == "mxu" else \
        ways["mxu"].push_blocks(g, xb, "min", "copy")
    plan = ways["mxu"].push_plan(g, bin_n)
    args = (xb, active, g.coo_src, g.coo_dst, g.coo_w, n, "min", "copy")
    kw = dict(plan=plan, strategy="mxu", block_e=block_e)
    s_e, s_bin, _ = ways["scan"].push_blocks(g, xb, "min", "copy")
    s_kw = dict(plan=ways["scan"].push_plan(g, s_bin), strategy="scan",
                block_e=s_e)
    max_abs_err(coo_push(*args, **s_kw), coo_push_plain(
        xb, active, s_kw["plan"], n, "min", "copy"), "min",
        f"coo_push (scan) BFS push at {gname}")
    record("coo_push_mxu",
           f"x i32[{n}] plan[{plan.nb},{plan.cap}] bin_n {plan.bin_n} "
           f"block_e {block_e} min/copy, all active (the BFS push)",
           coo_push(*args, **kw),
           coo_push_mxu_plain(xb, active, plan, n, "min", "copy", block_e),
           "min", lambda: coo_push(*args, **kw),
           lambda: coo_push_mxu_plain(xb, active, plan, n, "min", "copy",
                                      block_e),
           None, nbytes=push_bytes(m, n, 1, plan.nb, plan.bin_n),
           ops=m, reps=reps,
           extra={"width": 1, "payload": "int32 min/copy",
                  "tuner_pick": list(pick),
                  "scan_blocks": [s_e, s_bin],
                  "scan_ms": time_ms(lambda: coo_push(*args, **s_kw),
                                     reps)})
    torch.cuda.synchronize()
    return out


# -- slice 3: model serving ------------------------------------------------
FLASH_DIMS = HEAD_DIMS
FLASH_TS = (1, 63, 129, 130, 300, 4096)
# GQA groups: 2 is gemma2-9b's (16 query heads over 8), 4 llama3.2-1b's
FLASH_GROUPS = (1, 2, 4, 8)
FLASH_WINDOWS = (GLOBAL_WINDOW, 17, 4096)
FLASH_CAPS = (0.0, 50.0)
MODEL_DTYPES = (torch.bfloat16, torch.float32)
# the backward kernel's grid (d and dtype as the forward's): ragged last
# query and key tiles (130, 200, 1,000), and many key tiles adding into
# each dQ tile in turn (2,048)
FLASH_BWD_TS = (1, 130, 200, 384, 1000, 2048)
FLASH_BWD_WINDOWS = (GLOBAL_WINDOW, 17)
CIN_BATCHES = (1, 37, 512)
CIN_SHAPES = ((39, 39, 200, 10), (200, 39, 200, 10), (5, 4, 7, 6),
              (200, 39, 70, 10), (13, 9, 37, 3))
# the backward kernels also at F padded to 200 and to 40 from below 8 by
# the dx0 kernel, and at F above 200 (its fields in two blocks)
CIN_BWD_SHAPES = CIN_SHAPES + ((20, 41, 9, 4), (7, 7, 8, 6),
                               (13, 230, 37, 3))
# kernel against plain: flash 3e-4 (f32) / 2e-2 (bf16, P enters P·V in
# bf16); CIN 2e-4 (f32 sums in other orders) / 2e-2 (bf16 output)
FLASH_TOL = {torch.float32: 3e-4, torch.bfloat16: 2e-2}
CIN_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
# bf16 models, relative to the largest value: kernel path against plain
# path and decode against prefill. Activations round at 2^-8 in bf16
# and the kernel's bf16 P adds ~2^-9 per layer, over up to 16 layers.
LM_TOL = 5e-2


def lm_tol(cfg) -> float:
    """LM_TOL for up to 16 layers, scaled with depth past them (2^-9 of
    the kernel's bf16 P a layer): deepseek-moe-16b's 28 layers, 8.75e-2."""
    return LM_TOL * max(1.0, cfg.n_layers / 16)
# xDeepFM (f32), kernel CIN against plain CIN: rtol, atol
XDEEPFM_TOL = (1e-4, 1e-6)
# the serving runs: prompt batch and length, decode steps, layers kept
LM_RUNS = {
    "llama3.2-1b": {"B": 2, "T": 4096, "steps": 32, "layers": None,
                    "reduced": {"batch": "2, not prefill_32k's 32",
                                "seq_len": "4,096, not 32,768",
                                "decode": "32 steps against a 4,128-slot "
                                          "cache, not decode_32k's 128 "
                                          "rows at 32,768",
                                "why": "the smoke's time limit"}},
    "gemma2-9b": {"B": 1, "T": 8192, "steps": 16, "layers": 2,
                  "reduced": {"layers": "2 (one local, one global), not 42",
                              "batch": "1, not prefill_32k's 32",
                              "seq_len": "8,192, not 32,768 (the 4,096 "
                                         "window binds and the ring is "
                                         "built)",
                              "decode": "16 steps",
                              "why": "the smoke's time limit"}},
}
XDEEPFM_SERVE = {"serve_p99": 512, "serve_bulk": 262144}
RETRIEVAL_CANDIDATES = 1_000_000


def close_to(got: torch.Tensor, want: torch.Tensor, tol: float,
             what: str) -> float:
    """allclose(rtol = atol = tol) in f32; returns the largest gap."""
    if got.dtype != want.dtype or got.shape != want.shape:
        fail(f"{what}: {got.dtype}{tuple(got.shape)} vs plain "
             f"{want.dtype}{tuple(want.shape)}")
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol, msg=lambda m: f"{what}: {m}")
    return float((got.float() - want.float()).abs().max())


def rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|, in f32."""
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp(min=1e-30))


def normal(shape, gen, dtype=torch.float32) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device).to(dtype)


def grad_gaps(got, want) -> list:
    """Each gradient's largest gap over its largest |entry|, or over the
    largest |entry| of the three where that is larger: where each query
    sees one key (T = 1), dq and dk are 0 in exact arithmetic, and the
    kernel's dP − D (D = rowsum(dO ∘ out)) leaves f32 roundings of the
    size of dv's entries times 2^-24."""
    floor = max(float(w.float().abs().max()) for w in want)
    return [float((a.float() - b.float()).abs().max())
            / max(float(b.float().abs().max()), floor, 1e-30)
            for a, b in zip(got, want)]


def flash_bwd_grid(device, gen) -> tuple[float, float, int]:
    """The backward kernel against ``flash_attention_bwd_plain`` on the
    same output and logsumexp (the kernel forward's), over head dim ×
    dtype × T in FLASH_BWD_TS × GQA group × window {global, 17} × softcap
    {0, 50}: each gradient within FLASH_GRAD_TOL of its largest entry
    (:func:`grad_gaps`), two launches equal bit for bit, and the
    forward's logsumexp within 1e-5 of the plain one's largest |entry|.
    Returns (largest abs gap, largest relative gap, cells)."""
    worst_abs = worst_rel = 0.0
    cells = 0
    for d in FLASH_DIMS:
        for dt in MODEL_DTYPES:
            for T in FLASH_BWD_TS:
                for group in FLASH_GROUPS:
                    B, Hk = 2, 2
                    q = normal((B, T, Hk * group, d), gen, dt)
                    k = normal((B, T, Hk, d), gen, dt)
                    v = normal((B, T, Hk, d), gen, dt)
                    dout = normal((B, T, Hk * group, d), gen, dt)
                    for window in FLASH_BWD_WINDOWS:
                        for cap in FLASH_CAPS:
                            what = (f"flash bwd d{d} T{T} g{group} {dt} "
                                    f"w{window} cap{cap}")
                            out, lse = flash_attention_fwd(
                                q, k, v, window, cap, want_lse=True)
                            plain_lse = flash_attention_plain_gqa(
                                q, k, v, window, cap, return_lse=True)[1]
                            lse_gap = rel_gap(lse, plain_lse)
                            if not lse_gap <= FLASH_LSE_TOL:
                                fail(f"{what}: logsumexp {lse_gap} of the "
                                     f"largest, above {FLASH_LSE_TOL}")
                            got = flash_attention_bwd(q, k, v, out, lse,
                                                      dout, window, cap)
                            again = flash_attention_bwd(q, k, v, out, lse,
                                                        dout, window, cap)
                            want = flash_attention_bwd_plain(
                                q, k, v, dout, window, cap, out=out,
                                lse=lse)
                            if not all(torch.equal(a, b)
                                       for a, b in zip(got, again)):
                                fail(f"{what}: two launches differ")
                            gaps = grad_gaps(got, want)
                            if not max(gaps) <= FLASH_GRAD_TOL[dt]:
                                fail(f"{what}: (dq, dk, dv) gaps {gaps}, "
                                     f"above {FLASH_GRAD_TOL[dt]}")
                            worst_rel = max(worst_rel, *gaps)
                            worst_abs = max(worst_abs, *(
                                float((a.float() - b.float()).abs().max())
                                for a, b in zip(got, want)))
                            cells += 1
    return worst_abs, worst_rel, cells


def cin_bwd_check(kernel, plain, args, tol: float, what: str) -> float:
    """A CIN backward kernel against its plain version on ``args``:
    within ``tol`` of the largest |entry| (dw is f32 whatever the inputs;
    dx0 rounds to their dtype), two launches equal bit for bit. Returns
    the largest absolute gap."""
    got, want = kernel(*args), plain(*args)
    if got.dtype != want.dtype or got.shape != want.shape:
        fail(f"{what}: {got.dtype}{tuple(got.shape)} vs plain "
             f"{want.dtype}{tuple(want.shape)}")
    if not torch.equal(got, kernel(*args)):
        fail(f"{what}: two launches differ")
    gap = rel_gap(got, want)
    if not gap <= tol:
        fail(f"{what}: {gap} of the largest entry, above {tol}")
    return float((got.float() - want.float()).abs().max())


def model_kernel_grid(device) -> dict:
    """Each model kernel against its plain version: flash over head dim ×
    T (ragged against the 64-row tiles) × GQA group × window × softcap ×
    dtype, its backward over :func:`flash_bwd_grid`'s cells; CIN over
    ragged B × the layer shapes × dtype, its dw and dx0 kernels too."""
    gen = torch.Generator(device=device).manual_seed(11)
    t0 = time.perf_counter()
    errs = {"flash_attention": 0.0, "cin": 0.0, "cin_dw": 0.0,
            "cin_dx0": 0.0}
    cells = {"flash_attention": 0, "cin": 0, "cin_bwd": 0}
    for d in FLASH_DIMS:
        for T in FLASH_TS:
            B, Hk = (2, 2) if T < 4096 else (1, 2)
            for group in FLASH_GROUPS:
                for dt in MODEL_DTYPES:
                    q = normal((B, T, Hk * group, d), gen, dt)
                    k = normal((B, T, Hk, d), gen, dt)
                    v = normal((B, T, Hk, d), gen, dt)
                    for window in FLASH_WINDOWS:
                        for cap in FLASH_CAPS:
                            got = flash_attention(q, k, v, window, cap)
                            want = flash_attention_plain_gqa(q, k, v, window,
                                                             cap)
                            errs["flash_attention"] = max(
                                errs["flash_attention"], close_to(
                                    got, want, FLASH_TOL[dt],
                                    f"flash d{d} T{T} g{group} {dt} "
                                    f"w{window} cap{cap}"))
                            cells["flash_attention"] += 1
    errs["flash_attention_bwd"], bwd_rel, cells["flash_attention_bwd"] = \
        flash_bwd_grid(device, gen)
    for B in CIN_BATCHES:
        for Hp, F, H, D in CIN_SHAPES:
            for dt in MODEL_DTYPES:
                xk = normal((B, Hp, D), gen, dt)
                x0 = normal((B, F, D), gen, dt)
                w = (normal((H, Hp, F), gen) * (2.0 / (Hp * F)) ** 0.5
                     ).to(dt)
                errs["cin"] = max(errs["cin"], close_to(
                    cin_layer(xk, x0, w), cin_layer_plain(xk, x0, w),
                    CIN_TOL[dt], f"cin B{B} {(Hp, F, H, D)} {dt}"))
                cells["cin"] += 1
        for Hp, F, H, D in CIN_BWD_SHAPES:
            for dt in MODEL_DTYPES:
                what = f"cin backward B{B} {(Hp, F, H, D)} {dt}"
                xk = normal((B, Hp, D), gen, dt)
                x0 = normal((B, F, D), gen, dt)
                w = (normal((H, Hp, F), gen) * (2.0 / (Hp * F)) ** 0.5
                     ).to(dt)
                g = normal((B, H, D), gen, dt)
                errs["cin_dw"] = max(errs["cin_dw"], cin_bwd_check(
                    cin_weight_grad, cin_weight_grad_plain, (g, xk, x0),
                    CIN_GRAD_TOL, "dw " + what))
                errs["cin_dx0"] = max(errs["cin_dx0"], cin_bwd_check(
                    cin_dx0, cin_dx0_plain, (g, xk, w),
                    CIN_TOL[dt] if dt == torch.bfloat16 else CIN_GRAD_TOL,
                    "dx0 " + what))
                cells["cin_bwd"] += 1
    torch.cuda.synchronize()
    emit({"phase": "model_kernel_grid", "cells": cells,
          "max_abs_err": errs, "flash_bwd_max_rel_err": bwd_rel,
          "flash_bwd_tol": {str(k): v for k, v in FLASH_GRAD_TOL.items()},
          "seconds": time.perf_counter() - t0})
    return errs


def synced_ms(fn):
    """(result, host ms) of ``fn`` ending in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def device_profile(fn, top: int = 6) -> dict:
    """One call of ``fn`` under ``torch.profiler``: its host wall, the
    device time of its kernels (one stream, so their sum is the busy
    time) and the kernels that take most of it."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                      for e in prof.key_averages()
                      if e.self_device_time_total > 0),
                     key=lambda r: -r[1])
    busy = sum(ms for _, ms, _ in kernels)
    return {"wall_ms": wall_ms, "device_ms": busy,
            "busy_share": busy / wall_ms,
            "launches": sum(n for _, _, n in kernels),
            "top": [{"kernel": k[:80], "ms": ms, "calls": n}
                    for k, ms, n in kernels[:top]]}


def lm_serve(arch: str, device, flash: CallTimer, run: dict | None = None,
             path: str = "model", keep: tuple = ()) -> dict:
    """Prefill a seeded prompt through ``prefill`` (bf16 cache), then
    ``decode_step`` token by token on the grown cache. ``run``: the
    arch's entry of ``LM_RUNS`` unless given; ``keep``: more CallTimers
    that keep the cold prefill's arguments, as ``flash`` does."""
    run = run or LM_RUNS[arch]
    cfg = full_config(arch)
    if run["layers"]:
        cfg = dataclasses.replace(cfg, n_layers=run["layers"])
    B, T, steps = run["B"], run["T"], run["steps"]
    params, init_ms = synced_ms(lambda: init_params(cfg, seed=0,
                                                    device=device))
    gen = torch.Generator(device=device).manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (B, T + steps), generator=gen,
                         device=device)
    for timer in (flash, *keep):
        timer.keep = True
    _, cold_ms = synced_ms(lambda: prefill(params, cfg, toks[:, :T], "bf16"))
    for timer in (flash, *keep):
        timer.keep = False
    kept = flash.kept[-cfg.n_layers:]
    flash.take_ms()
    # the second prefill is the steady state (the first pays the GEMM
    # heuristics and the allocator's growth)
    (logits, cache), prefill_ms = synced_ms(
        lambda: prefill(params, cfg, toks[:, :T], "bf16"))
    layer_ms = flash.take_ms()
    windows = cfg.window_array(T)
    emit({"phase": "lm_prefill", "path": path, "arch": arch, "B": B,
          "T": T,
          "layers": cfg.n_layers, "d_model": cfg.d_model,
          "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.hd],
          "param_gb": tree_size_bytes(params) / 1e9, "init_ms": init_ms,
          "first_prefill_ms": cold_ms, "prefill_ms": prefill_ms,
          "tokens_per_s": B * T / prefill_ms * 1e3,
          "flash_ms_per_layer": layer_ms, "flash_ms_by_window": {
              str(w): statistics.mean(ms for ms, lw in zip(layer_ms, windows)
                                      if lw == w) for w in set(windows)},
          "flash_share": sum(layer_ms) / prefill_ms,
          "profile": device_profile(
              lambda: prefill(params, cfg, toks[:, :T], "bf16")),
          "reduced": run["reduced"]})
    grown = pad_kv_cache(cache, T + steps)
    step_ms, first = [], None
    for i in range(steps):
        (lg, grown), ms = synced_ms(lambda i=i: decode_step(
            params, cfg, toks[:, T + i:T + i + 1], grown, T + i))
        step_ms.append(ms)
        if i == 0:
            first = lg
    if not (torch.isfinite(logits).all() and torch.isfinite(lg).all()):
        fail(f"{arch}: non-finite logits")
    emit({"phase": "lm_decode", "path": path, "arch": arch, "B": B,
          "cache_len": T + steps,
          "steps": steps, "ms_per_step_median": statistics.median(step_ms),
          "ms_per_step": step_ms,
          "profile": device_profile(lambda: decode_step(
              params, cfg, toks[:, T:T + 1], pad_kv_cache(cache, T + 1), T)),
          "tokens_per_s": B * steps / sum(step_ms) * 1e3,
          "reduced": run["reduced"]})
    return {"cfg": cfg, "params": params, "toks": toks, "logits": logits,
            "cache": cache, "first_decode": first, "T": T,
            "flash_args": kept}


def lm_check(arch: str, st: dict, path: str = "model") -> None:
    """Kernel path against the plain path (``attn_impl="naive"``) on the
    same weights, and the first decode step against a prefill one token
    longer."""
    cfg, params, toks, T = st["cfg"], st["params"], st["toks"], st["T"]
    logits_n, cache_n = prefill(params, dataclasses.replace(
        cfg, attn_impl="naive"), toks[:, :T], "bf16")
    gaps = {"logits": rel_gap(st["logits"], logits_n)}
    flat = (lambda c: c if "global" not in c else
            {f"{p}.{k}": v for p in ("local", "global")
             for k, v in c[p].items()})
    for name, buf in flat(st["cache"]).items():
        gaps["cache." + name] = rel_gap(buf, flat(cache_n)[name])
    longer, _ = prefill(params, cfg, toks[:, :T + 1], "bf16")
    gaps["decode_vs_prefill"] = rel_gap(st["first_decode"], longer)
    bad = {k: v for k, v in gaps.items() if not v <= LM_TOL}
    emit({"phase": "lm_check", "path": path, "arch": arch,
          "relative_gap": gaps,
          "tol": LM_TOL, "ok": not bad})
    if bad:
        fail(f"{arch}: {bad} above {LM_TOL} of the largest value")


def xdeepfm_serve(device, cin: CallTimer) -> dict:
    """serve_p99 and serve_bulk (``sigmoid(xdeepfm_apply)``) and
    retrieval_cand (``retrieval_score``) on the full config."""
    cfg = full_config("xdeepfm")
    params, init_ms = synced_ms(lambda: xdeepfm_init(cfg, seed=0,
                                                     device=device))
    gen = torch.Generator(device=device).manual_seed(2)
    ids = {name: torch.randint(0, cfg.vocab_per_field, (B, cfg.n_fields),
                               generator=gen, device=device)
           for name, B in XDEEPFM_SERVE.items()}
    out = {}
    for name, reps in (("serve_p99", 20), ("serve_bulk", 3)):
        lat = []
        for r in range(reps):
            cin.keep = name == "serve_p99" and r == 0
            out[name], ms = synced_ms(lambda name=name: torch.sigmoid(
                xdeepfm_apply(params, cfg, ids[name])))
            lat.append(ms)
        cin.keep = False
        layer_ms = cin.take_ms()
        nl = len(cfg.cin_layers)
        per_layer = [statistics.median(layer_ms[i::nl]) for i in range(nl)]
        B = XDEEPFM_SERVE[name]
        emit({"phase": "xdeepfm_" + name, "B": B, "reps": reps,
              "init_ms": init_ms, "ms_median": statistics.median(lat),
              "ms_max": max(lat), "rows_per_s": B / statistics.median(lat)
              * 1e3, "cin_ms_per_layer": per_layer,
              "cin_share": sum(per_layer) / statistics.median(lat),
              "reduced": None})
    fu = cfg.n_fields // 2
    user = ids["serve_p99"][:1, :fu]
    cand = torch.randint(0, cfg.vocab_per_field,
                         (RETRIEVAL_CANDIDATES, cfg.n_fields - fu),
                         generator=gen, device=device)
    lat = []
    for _ in range(3):
        out["retrieval"], ms = synced_ms(
            lambda: retrieval_score(params, cfg, user, cand))
        lat.append(ms)
    emit({"phase": "xdeepfm_retrieval_cand", "candidates": cand.shape[0],
          "ms_median": statistics.median(lat),
          "candidates_per_s": cand.shape[0] / statistics.median(lat) * 1e3,
          "reduced": None})
    for name, v in out.items():
        if not torch.isfinite(v).all():
            fail(f"xdeepfm {name}: non-finite scores")
    return {"cfg": cfg, "params": params, "ids": ids, "out": out,
            "user": user, "cand": cand, "cin_args": cin.kept}


def xdeepfm_check(st: dict) -> None:
    """The kernel path against the plain CIN (``cin_layer_plain`` in
    place of the wrapper) at serve_p99 and on a 4,096-row slice of the
    bulk batch; retrieval against a float64 recomputation on 4,096
    candidates."""
    cfg, params, ids = st["cfg"], st["params"], st["ids"]
    rtol, atol = XDEEPFM_TOL
    real = kernel_ops.cin_layer
    kernel_ops.cin_layer = cin_layer_plain
    try:
        want = {"serve_p99": torch.sigmoid(xdeepfm_apply(
                    params, cfg, ids["serve_p99"])),
                "serve_bulk": torch.sigmoid(xdeepfm_apply(
                    params, cfg, ids["serve_bulk"][:4096]))}
        feats = cin_apply(params["cin"], params["tables"][
            torch.arange(cfg.n_fields, device=ids["serve_p99"].device)[None],
            ids["serve_p99"]])
    finally:
        kernel_ops.cin_layer = real
    gaps = {}
    for name, w in want.items():
        got = st["out"][name][:w.shape[0]]
        torch.testing.assert_close(got, w, rtol=rtol, atol=atol,
                                   msg=lambda m: f"xdeepfm {name}: {m}")
        gaps[name] = float((got - w).abs().max())
    got_feats = cin_apply(params["cin"], params["tables"][
        torch.arange(cfg.n_fields, device=feats.device)[None],
        ids["serve_p99"]])
    gaps["cin_features_relative"] = rel_gap(got_feats, feats)
    if not gaps["cin_features_relative"] <= rtol:
        fail(f"xdeepfm CIN features: {gaps['cin_features_relative']}")
    tab = params["tables"].double()
    fu = st["user"].shape[1]
    f_u = torch.arange(fu, device=tab.device)[None]
    u = tab[f_u, st["user"]].mean(1)[0]
    c = tab[fu + torch.arange(st["cand"].shape[1], device=tab.device)[None],
            st["cand"][:4096]].mean(1)
    torch.testing.assert_close(st["out"]["retrieval"][:4096].double(),
                               c @ u, rtol=1e-5, atol=1e-9)
    emit({"phase": "xdeepfm_check", "max_abs_gap": gaps,
          "tol": {"rtol": rtol, "atol": atol}, "ok": True})


def model_path(device) -> tuple[dict, dict, dict]:
    """Slice 3's main path: llama3.2-1b and gemma2-9b serve (prefill,
    decode), then xDeepFM serves, with the launch counts zeroed just
    before and read just after; the checks run after the read."""
    with CallTimer(kernel_ops, "flash_attention") as flash, \
            CallTimer(kernel_ops, "cin_layer") as cin:
        _build.reset_launch_counts()
        lms = {arch: lm_serve(arch, device, flash) for arch in LM_RUNS}
        rec = xdeepfm_serve(device, cin)
        counts = _build.launch_counts()
    emit({"phase": "model_path", "launches": counts})
    for name in ("flash_attention", "cin"):
        if counts[name] <= 0:
            fail(f"kernel {name} was never launched on the model path")
    for arch, st in lms.items():
        lm_check(arch, st)
    xdeepfm_check(rec)
    return lms, rec, counts


def model_kernel_rows(lms: dict, rec: dict | None, path: str = "model"
                      ) -> list:
    """Each model kernel at its path's shapes, on the path's own inputs:
    held against its plain version, then timed with CUDA events (L2
    flushed before each launch) beside the plain version, the bound of
    the card and one PyTorch call computing the same function where
    there is one (``scaled_dot_product_attention``, ``einsum``)."""
    rows = []

    def record(name, shape, args, kernel, plain, library, tol, nbytes, ops_,
               rate, reps):
        err = close_to(kernel(), plain(), tol, f"{name} {shape}")
        rows.append(kernel_row(name, shape, err, kernel, plain, library,
                               nbytes, ops_, reps, rate=rate, plain_reps=3,
                               **args))

    for arch, st in lms.items():
        cfg = st["cfg"]
        for li in (0, 1) if cfg.local_window else (0,):
            (q, k, v), kw = st["flash_args"][li]
            window, cap, scale = (kw["causal_window"], kw["softcap"],
                                  kw["scale"])
            B, T, H, d = q.shape
            Hk = k.shape[2]
            lib = None
            if window >= T and cap == 0.0:
                def lib(q=q, k=k, v=v, scale=scale):
                    return torch.nn.functional.scaled_dot_product_attention(
                        q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), is_causal=True, scale=scale,
                        enable_gqa=True)
            nbytes, ops_ = flash_work(B, T, H, Hk, d, window,
                                      q.element_size())
            record("flash_attention",
                   f"{arch} layer {li}: q {q.dtype} [{B}, {T}, {H}, {d}], "
                   f"kv [{B}, {T}, {Hk}, {d}], window {min(window, T)}, "
                   f"softcap {cap}",
                   {"arch": arch, "layer": li, "path": path},
                   lambda q=q, k=k, v=v, w=window, c=cap, s=scale:
                   kernel_ops.flash_attention(q, k, v, w, c, scale=s),
                   lambda q=q, k=k, v=v, w=window, c=cap:
                   flash_attention_plain_gqa(q, k, v, w, c),
                   lib, FLASH_TOL[q.dtype],
                   nbytes=nbytes, ops_=ops_,
                   rate=(BF16_OPS_PER_S if q.dtype == torch.bfloat16
                         else F32_OPS_PER_S), reps=10)
    for li, ((xk, x0, w), _) in enumerate(rec["cin_args"] if rec else ()):
        B, Hp, D = xk.shape
        F, H = x0.shape[1], w.shape[0]
        nbytes, ops_ = cin_work(B, H, Hp, F, D, xk.element_size())
        record("cin", f"serve_p99 layer {li}: xk f32 [{B}, {Hp}, {D}], x0 "
               f"[{B}, {F}, {D}], w [{H}, {Hp}, {F}]",
               {"layer": li, "path": path,
                "f32_bound_ms": bound(nbytes, ops_)[0]},
               lambda xk=xk, x0=x0, w=w: kernel_ops.cin_layer(xk, x0, w),
               lambda xk=xk, x0=x0, w=w: cin_layer_plain(xk, x0, w),
               lambda xk=xk, x0=x0, w=w: torch.einsum("hij,bid,bjd->bhd", w,
                                                      xk, x0),
               CIN_TOL[xk.dtype], nbytes=nbytes, ops_=3 * ops_,
               rate=TF32_OPS_PER_S, reps=20)
    torch.cuda.synchronize()
    return rows


# -- slice 10: training ----------------------------------------------------
# the training runs: global batch, sequence, microbatches, steps, the step
# the resumed run restarts from, and the layers kept
TRAIN_LM = {
    "llama3.2-1b": {"B": 8, "T": 4096, "micro": 4, "steps": 5,
                    "ckpt_at": 3, "layers": None,
                    "reduced": {"global_batch": "8 sequences of 4,096 in 4 "
                                                "microbatches of 2, not "
                                                "train_4k's 256",
                                "steps": "5 (a checkpoint at 3; a fresh "
                                         "loop resumes there and runs to 5)",
                                "why": "the smoke's time limit"}},
    "gemma2-9b": {"B": 1, "T": 4096, "micro": 1, "steps": 3,
                  "ckpt_at": None, "layers": 2,
                  "reduced": {"layers": "2 (one local, one global), not 42",
                              "global_batch": "1 × 4,096, not train_4k's "
                                              "256 × 4,096",
                              "steps": "3",
                              "window": "4,096 masks no key at T = 4,096; "
                                        "the gradient check of the layer "
                                        "runs T = 8,192, where it binds",
                              "why": "the smoke's time limit"}},
}
TRAIN_XDEEPFM = {"B": 65536, "steps": 5,
                 "reduced": {"steps": "5", "why": "the smoke's time limit"}}
TRAIN_LR = 1e-4
# kernel path against plain path, ‖g_kernel − g_plain‖ / ‖g_plain‖ per
# parameter: f32 sums in other orders; bf16 as LM_TOL (the kernel's bf16
# P, activations rounding at 2^-8, over 2 layers)
LM_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
XDEEPFM_GRAD_TOL = 1e-4
# the Functions' gradients against autograd through the plain versions,
# relative to the largest |entry|: the same formulas summed in other
# orders (f32), and one bf16 rounding of each gradient (bf16)
FLASH_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
# the kernel forward's row logsumexp against the plain one's, relative to
# its largest |entry|: f32 sums in other orders, the fast tanh and ex2
FLASH_LSE_TOL = 1e-5
CIN_GRAD_TOL = 1e-4
# resumed losses against the uninterrupted run's, relative, where they
# are not equal bit for bit
RESUME_TOL = 2e-3


def on_device(batch: dict, device) -> dict:
    return {k: v.to(device) for k, v in batch.items()}


def lm_train_flops(cfg, params: dict, B: int, T: int) -> float:
    """6 · N · tokens (N the parameters a token uses: without the input
    embedding, a gather, and of a MoE layer's routed experts only the
    top k) plus the attention's products three times over (forward, and
    the backward's two), as model FLOPs count them: the remat recompute
    is not counted."""
    n = param_count(params) - params["embed"].numel()
    if cfg.moe is not None:
        routed = sum(param_count(lp["moe"]["experts"])
                     for lp in params["layers"])
        n -= routed * (1 - cfg.moe.top_k / cfg.moe.n_experts)
    attn = sum(flash_work(B, T, cfg.n_heads, cfg.n_kv_heads, cfg.hd, w, 2)[1]
               for w in cfg.window_array(T))
    return 6.0 * n * B * T + 3.0 * attn


def lm_train(arch: str, device, fwd: CallTimer, bwd: CallTimer,
             run: dict | None = None, path: str = "train") -> dict:
    """``TrainLoop`` on the full-width config, AdamW, synthetic tokens;
    for llama a checkpoint at ``ckpt_at`` and a fresh loop resuming
    from it. ``run``: the arch's entry of ``TRAIN_LM`` unless given."""
    run = run or TRAIN_LM[arch]
    cfg = full_config(arch)
    if run["layers"]:
        cfg = dataclasses.replace(cfg, n_layers=run["layers"])
    B, T, steps = run["B"], run["T"], run["steps"]
    params = init_params(cfg, seed=0, device=device)
    stream = token_batches(B, T, cfg.vocab, seed=0)
    batches = [next(stream) for _ in range(steps)]

    def loss_fn(p, b):
        return lm_loss(p, cfg, b["tokens"], b["labels"])

    ckpt_dir = None
    if run["ckpt_at"]:
        ckpt_dir = str(_build.BUILD_DIR.parent
                       / f"train_ckpt-{os.getpid()}-{time.time_ns()}")
    opt = OptConfig(lr=TRAIN_LR, warmup_steps=2, total_steps=steps)
    loop_cfg = LoopConfig(total_steps=steps,
                          ckpt_every=run["ckpt_at"] or steps + 1,
                          ckpt_dir=ckpt_dir, log_every=1,
                          num_micro=run["micro"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fwd.take_ms(), bwd.take_ms()
    loop = TrainLoop(loss_fn, params, opt, loop_cfg,
                     decay=decay_mask(params))
    t0 = time.perf_counter()
    res = loop.run(iter(batches))
    run_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    fwd_ms, bwd_ms = fwd.take_ms(), bwd.take_ms()
    losses = [h["loss"] for h in res["history"]]
    dts = [h["dt"] * 1e3 for h in res["history"]]
    step_ms = statistics.median(dts[1:])
    flops = lm_train_flops(cfg, params, B, T)
    if not all(np.isfinite(losses)):
        fail(f"{arch}: non-finite training losses {losses}")
    calls = steps * run["micro"] * cfg.n_layers
    line = {"phase": "train", "path": path, "arch": arch, "B": B, "T": T,
            "microbatches": run["micro"], "layers": cfg.n_layers,
            "d_model": cfg.d_model, "params": param_count(params),
            "optimizer": "adamw", "losses": losses, "step_ms": dts,
            "step_ms_median_2_on": step_ms,
            "tokens_per_s": B * T / step_ms * 1e3,
            "model_flops_per_step": flops,
            "bf16_peak_share": flops / (step_ms / 1e3) / BF16_OPS_PER_S,
            "peak_memory_gb": peak_gb, "run_s": run_s,
            "flash_fwd_ms_per_call": statistics.median(fwd_ms),
            "flash_fwd_calls": len(fwd_ms),
            "attn_bwd_ms_per_call": statistics.median(bwd_ms),
            "attn_bwd_calls": len(bwd_ms),
            "attn_ms_per_step": (sum(fwd_ms) + sum(bwd_ms)) / steps,
            "attn_share": (sum(fwd_ms) + sum(bwd_ms)) / sum(dts),
            "remat_recompute": len(fwd_ms) == 2 * calls,
            "profile": device_profile(
                lambda: loop._step(on_device(batches[0], device))),
            "reduced": run["reduced"]}
    fwd.take_ms(), bwd.take_ms()
    del loop
    if ckpt_dir:
        line["resume"] = lm_resume(loss_fn, params, opt, loop_cfg,
                                   batches, losses, run["ckpt_at"])
    emit(line | {"card": card_line()})
    if ckpt_dir:
        import shutil
        shutil.rmtree(ckpt_dir)
    return line


def lm_resume(loss_fn, params, opt, loop_cfg, batches, losses,
              at: int) -> dict:
    """A crash after step ``at``'s checkpoint and before the last one
    committed: the last step's directory goes, and a fresh loop on the
    same directory resumes at ``at`` and runs to the end. Its losses
    against the uninterrupted run's."""
    import shutil
    d = loop_cfg.ckpt_dir
    last = os.path.join(d, f"step_{loop_cfg.total_steps:09d}")
    shutil.rmtree(last)
    t0 = time.perf_counter()
    loop = TrainLoop(loss_fn, params, opt, loop_cfg,
                     decay=decay_mask(params))
    restore_s = time.perf_counter() - t0
    if loop.start_step != at:
        fail(f"resumed at step {loop.start_step}, not {at}")
    t0 = time.perf_counter()
    res = loop.run(iter(batches[at:]))
    run_s = time.perf_counter() - t0
    got = [h["loss"] for h in res["history"]]
    want = losses[at:]
    gaps = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    bitwise = got == want
    out = {"from_step": at, "losses": got, "uninterrupted": want,
           "bitwise": bitwise, "relative_gap": max(gaps), "tol": RESUME_TOL,
           "restore_s": restore_s, "run_s": run_s,
           "checkpoint_gb": sum(os.path.getsize(os.path.join(r, f))
                                for r, _, fs in os.walk(d) for f in fs)
           / 1e9}
    if len(got) != len(want) or not (bitwise or max(gaps) <= RESUME_TOL):
        fail(f"resumed losses {got} against {want}")
    return out


def xdeepfm_train(device, fwd: CallTimer, bwd: CallTimer, dw: CallTimer,
                  dx0: CallTimer) -> dict:
    """``launch.train.main`` on the full xDeepFM config at train_batch
    (BCE, AdamW): its step time, and the CIN layers' forward launches and
    backward kernels (dxk, a layer launch; dw; dx0) in it, per layer in
    the backward's order (the last layer first)."""
    import contextlib
    import io
    B, steps = TRAIN_XDEEPFM["B"], TRAIN_XDEEPFM["steps"]
    for t in (fwd, bwd, dw, dx0):
        t.take_ms()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = launch_train.main(["--arch", "xdeepfm", "--full", "--batch",
                                str(B), "--steps", str(steps),
                                "--device", str(device)])
    run_s = time.perf_counter() - t0
    text = out.getvalue().strip()
    m = re.search(r"step=(\d+) loss=(\S+) median_step=([\d.]+)ms", text)
    if rc != 0 or not m or int(m.group(1)) != steps or \
            not np.isfinite(float(m.group(2))):
        fail(f"xdeepfm training: rc {rc}, {text!r}")
    step_ms = float(m.group(3))
    f_ms, b_ms, w_ms, x_ms = (fwd.take_ms(), bwd.take_ms(), dw.take_ms(),
                              dx0.take_ms())
    nl = len(full_config("xdeepfm").cin_layers)
    cin_ms = (sum(f_ms) + sum(b_ms) + sum(w_ms) + sum(x_ms)) / steps

    def per_layer(ms):
        return [statistics.median(ms[i::nl]) for i in range(nl)]
    line = {"phase": "train", "arch": "xdeepfm", "B": B, "steps": steps,
            "launcher": text, "step_ms_median": step_ms,
            "rows_per_s": B / step_ms * 1e3, "run_s": run_s,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "cin_fwd_ms_per_layer": per_layer(f_ms),
            "cin_dxk_ms_per_layer_bwd_order": per_layer(b_ms),
            "cin_dw_ms_per_layer_bwd_order": per_layer(w_ms),
            "cin_dx0_ms_per_layer_bwd_order": per_layer(x_ms),
            "cin_bwd_launches": {"dxk": len(b_ms), "dw": len(w_ms),
                                 "dx0": len(x_ms)},
            "cin_bwd_ms_per_step": (sum(b_ms) + sum(w_ms) + sum(x_ms))
            / steps,
            "cin_ms_per_step": cin_ms, "cin_share": cin_ms / step_ms,
            "reduced": TRAIN_XDEEPFM["reduced"], "card": card_line()}
    emit(line)
    return line


def rel_norm(got: torch.Tensor, want: torch.Tensor) -> float:
    """‖got − want‖ / ‖want‖ in f64."""
    w = want.double()
    return float(torch.linalg.vector_norm(got.double() - w)
                 / torch.linalg.vector_norm(w).clamp(min=1e-300))


def worst_leaf(got, want) -> float:
    return max(rel_norm(a, b) for a, b in zip(tree_leaves(got),
                                              tree_leaves(want)))


def lm_grad_check(device, arch: str = "llama3.2-1b",
                  pin: "RoutePin | None" = None) -> dict:
    """``arch`` at full width, 2 layers, bf16 and f32: every parameter's
    gradient with the kernel (``attn_impl="blockwise"``) against the
    plain path (``"naive"``), on one 4,096-token sequence. A MoE arch
    passes ``pin``: the kernel run's expert choices (the forward's and
    the remat recompute's, in call order) are replayed in the plain
    run."""
    gaps = {}
    vocab = full_config(arch).vocab
    batch = on_device(next(token_batches(1, 4096, vocab, seed=1)), device)
    for dt, name in ((torch.bfloat16, "bfloat16"), (torch.float32,
                                                    "float32")):
        cfg = dataclasses.replace(full_config(arch), n_layers=2,
                                  dtype=name)
        params = init_params(cfg, seed=1, device=device)
        grads = {}
        for impl in ("blockwise", "naive"):
            c = dataclasses.replace(cfg, attn_impl=impl)
            if pin is not None:
                pin.record = impl == "blockwise"
                pin.replay = None if pin.record else list(route)
            grads[impl] = value_and_grad(
                lambda p, b, c=c: lm_loss(p, c, b["tokens"], b["labels"]),
                params, batch)
            if pin is not None and impl == "blockwise":
                route = pin.take()
        if pin is not None:
            if pin.replay:
                fail(f"{arch}: the plain run routed fewer times than the "
                     "kernel run")
            pin.record, pin.replay = False, None
        gaps[name] = {"loss": abs(float(grads["blockwise"][0])
                                  - float(grads["naive"][0])),
                      "worst_grad": worst_leaf(grads["blockwise"][1],
                                               grads["naive"][1]),
                      "tol": LM_GRAD_TOL[dt]}
        del params, grads
        if not gaps[name]["worst_grad"] <= LM_GRAD_TOL[dt]:
            fail(f"{arch} {name} gradients: {gaps[name]}")
    return gaps


def xdeepfm_grad_check(device) -> dict:
    """xDeepFM at full width: one step's gradients through the CIN
    Function against the same loss on ``cin_layer_plain``, on 4,096
    rows; then the packing cache: after an in-place AdamW step, the
    kernel on the updated weights equals the plain layer on them."""
    cfg = full_config("xdeepfm")
    params = xdeepfm_init(cfg, seed=3, device=device)
    batch = on_device(next(recsys_batches(4096, cfg.n_fields,
                                          cfg.vocab_per_field, seed=3)),
                      device)

    def loss_fn(p, b):
        return bce_with_logits(xdeepfm_apply(p, cfg, b["ids"]),
                               b["labels"])

    loss_k, g_k = value_and_grad(loss_fn, params, batch)
    real = kernel_ops.cin_layer
    kernel_ops.cin_layer = cin_layer_plain
    try:
        loss_p, g_p = value_and_grad(loss_fn, params, batch)
    finally:
        kernel_ops.cin_layer = real
    out = {"loss": abs(float(loss_k) - float(loss_p)),
           "worst_grad": worst_leaf(g_k, g_p), "tol": XDEEPFM_GRAD_TOL}
    if not out["worst_grad"] <= XDEEPFM_GRAD_TOL:
        fail(f"xdeepfm gradients: {out}")
    # the packing cache follows an in-place update
    gen = torch.Generator(device=device).manual_seed(4)
    w = params["cin"][1]
    xk = normal((512, w.shape[1], cfg.embed_dim), gen)
    x0 = normal((512, cfg.n_fields, cfg.embed_dim), gen)
    before = kernel_ops.cin_layer(xk, x0, w)          # packs w
    version = w._version
    apply_updates(params, g_k, init_opt(params, OptConfig(warmup_steps=0)),
                  OptConfig(warmup_steps=0))
    after = kernel_ops.cin_layer(xk, x0, w)
    out["pack_cache"] = {
        "version_moved": w._version > version,
        "changed": float((after - before).abs().max()),
        "max_abs_err": close_to(after, cin_layer_plain(xk, x0, w),
                                CIN_TOL[torch.float32],
                                "cin after an optimizer step")}
    if not out["pack_cache"]["changed"] > 0:
        fail("the optimizer step left the CIN output as it was")
    return out


def flash_grad_row(name: str, shape: dict, device) -> dict:
    """The Function's (dq, dk, dv) at a layer's shape against autograd
    through ``flash_attention_plain_gqa``; the backward kernel held
    against ``flash_attention_bwd_plain`` on the same output and
    logsumexp, then timed beside that plain recompute (without them, as
    the card ran it before the kernel), the plain autograd backward,
    SDPA's backward where SDPA computes the same function, and the bound
    of its five products (``flash_bwd_work``)."""
    B, T, H, Hk, d = shape["B"], shape["T"], shape["H"], shape["Hk"], \
        shape["d"]
    window, cap, dt = shape["window"], shape["cap"], shape["dtype"]
    gen = torch.Generator(device=device).manual_seed(T + d)
    q, k, v = (normal((B, T, h, d), gen, dt).requires_grad_()
               for h in (H, Hk, Hk))
    dout = normal((B, T, H, d), gen, dt)
    got = torch.autograd.grad(flash_attention(q, k, v, window, cap),
                              (q, k, v), dout)
    plain_out = flash_attention_plain_gqa(q, k, v, window, cap)
    want = torch.autograd.grad(plain_out, (q, k, v), dout,
                               retain_graph=True)
    err = max(rel_gap(a, b) for a, b in zip(got, want))
    if not err <= FLASH_GRAD_TOL[dt]:
        fail(f"flash gradients {name}: {err} above {FLASH_GRAD_TOL[dt]}")
    del got, want
    qd, kd, vd = q.detach(), k.detach(), v.detach()
    out, lse = flash_attention_fwd(qd, kd, vd, window, cap, want_lse=True)
    got = flash_attention_bwd(qd, kd, vd, out, lse, dout, window, cap)
    want = flash_attention_bwd_plain(qd, kd, vd, dout, window, cap,
                                     out=out, lse=lse)
    mirror = max(grad_gaps(got, want))
    if not mirror <= FLASH_GRAD_TOL[dt]:
        fail(f"flash backward kernel {name}: {mirror} above "
             f"{FLASH_GRAD_TOL[dt]}")
    abs_err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(got, want))
    del got, want
    bwd_ms = time_ms(lambda: flash_attention_bwd(qd, kd, vd, out, lse, dout,
                                                 window, cap), 10)
    recompute_ms = time_ms(lambda: flash_attention_bwd_plain(
        qd, kd, vd, dout, window, cap), 3)
    plain_ms = time_ms(lambda: torch.autograd.grad(
        plain_out, (q, k, v), dout, retain_graph=True), 3)
    del plain_out
    lib_ms = None
    if window >= T and cap == 0.0:
        sd = torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True).transpose(1, 2)
        lib_ms = time_ms(lambda: torch.autograd.grad(
            sd, (q, k, v), dout, retain_graph=True), 10)
    nbytes, ops_ = flash_bwd_work(B, T, H, Hk, d, window, q.element_size())
    b_ms, b_by = bound(nbytes, ops_, BF16_OPS_PER_S
                       if dt == torch.bfloat16 else F32_OPS_PER_S)
    row = {"phase": "train_grad", "kernel": "flash_attention_bwd",
           "shape": name, "max_rel_err": err, "tol": FLASH_GRAD_TOL[dt],
           "kernel_vs_plain_rel_err": mirror, "bwd_ms": bwd_ms,
           "plain_recompute_ms": recompute_ms, "plain_autograd_ms": plain_ms,
           "library_bwd_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
           "card": card_line()}
    emit(row)
    # the kernels line's keys
    return row | {"name": "flash_attention_bwd", "route": "cuda",
                  "source": KERNEL_INFO["flash_attention_bwd"][0],
                  "replaces": KERNEL_INFO["flash_attention_bwd"][1],
                  "max_abs_err": abs_err, "ms": bwd_ms,
                  "plain_ms": recompute_ms, "library_ms": lib_ms}


def cin_grad_row(name: str, B: int, Hp: int, F: int, H: int, D: int,
                 device) -> list:
    """The Function's (dxk, dx0, dw) at a CIN layer's shape against
    autograd through ``cin_layer_plain``, and the dw and dx0 kernels
    against their plain versions on the same inputs (each within
    CIN_GRAD_TOL of its largest entry); then each backward piece timed:
    dxk (a layer launch), the dx0 kernel beside the route it replaced (a
    layer launch on w.permute(2, 0, 1), width 64, K = H · Hp), its plain
    version and one ``einsum``; the dw kernel beside the chunked GEMM it
    replaced (its plain version) and one ``einsum``; the Function's whole
    backward. Bounds: each kernel's bytes or its three TF32 products
    (the 3xTF32 floor it runs at), with its FLOP at the f32 rate beside
    them (``f32_bound_ms``); the Function's three products' 3xTF32 floor
    beside one TF32 pass of them. Returns the two kernels' rows for the
    kernels line."""
    gen = torch.Generator(device=device).manual_seed(B + Hp)
    xk = normal((B, Hp, D), gen).requires_grad_()
    x0 = normal((B, F, D), gen).requires_grad_()
    w = (normal((H, Hp, F), gen) * (2.0 / (Hp * F)) ** 0.5).requires_grad_()
    g = normal((B, H, D), gen)
    got = torch.autograd.grad(cin_layer(xk, x0, w), (xk, x0, w), g)
    want = torch.autograd.grad(cin_layer_plain(xk, x0, w), (xk, x0, w), g)
    errs = {k: rel_gap(a, b) for k, a, b in zip(("dxk", "dx0", "dw"), got,
                                                 want)}
    err = max(errs.values())
    if not err <= CIN_GRAD_TOL:
        fail(f"CIN gradients {name}: {err} above {CIN_GRAD_TOL}")
    del got, want
    xk, x0, w = xk.detach(), x0.detach(), w.detach()
    abs_err = {"cin_dw": cin_bwd_check(
        cin_weight_grad, cin_weight_grad_plain, (g, xk, x0), CIN_GRAD_TOL,
        f"dw {name}"), "cin_dx0": cin_bwd_check(
        cin_dx0, cin_dx0_plain, (g, xk, w), CIN_GRAD_TOL, f"dx0 {name}")}
    t = {"dxk": time_ms(lambda: cin_layer(g, x0, w.permute(1, 0, 2)), 5),
         "cin_dx0": time_ms(lambda: cin_dx0(g, xk, w), 5),
         "cin_dw": time_ms(lambda: cin_weight_grad(g, xk, x0), 5),
         "dx0_width64_launch": time_ms(
             lambda: cin_layer(g, xk, w.permute(2, 0, 1)), 3),
         "cin_dx0_plain": time_ms(lambda: cin_dx0_plain(g, xk, w), 3),
         "cin_dw_plain": time_ms(lambda: cin_weight_grad_plain(g, xk, x0),
                                 3),
         # one einsum a gradient, its operands ordered so that the first
         # pair contracts into [B, Hp, F, D], not [B, H, Hp, D]
         "dxk_einsum": time_ms(lambda: torch.einsum(
             "hij,bhd,bjd->bid", w, g, x0), 3),
         "dx0_einsum": time_ms(lambda: torch.einsum(
             "hij,bhd,bid->bjd", w, g, xk), 3),
         "dw_einsum": time_ms(lambda: torch.einsum(
             "bid,bjd,bhd->hij", xk, x0, g), 3)}
    leaves = [a.clone().requires_grad_() for a in (xk, x0, w)]
    out = cin_layer(*leaves)
    t["function_bwd"] = time_ms(lambda: torch.autograd.grad(
        out, leaves, g, retain_graph=True), 3)
    del out, leaves
    one = cin_tf32_floor_ms(B, H, Hp, F, D)       # one kernel's 3xTF32
    row = {"phase": "train_grad", "kernel": "cin", "shape": name,
           "max_rel_err": err, "rel_err": errs, "tol": CIN_GRAD_TOL,
           "bwd_ms": t["dxk"] + t["cin_dx0"] + t["cin_dw"], "ms": t,
           # the three products: 3xTF32, one TF32 pass, the f32 rate
           "tf32_floor_ms": 3 * one, "tf32_single_pass_ms": one,
           "f32_bound_ms": bound(0, 3 * 2 * B * H * Hp * F * D)[0],
           "card": card_line()}
    emit(row)
    rows = []
    for kname, which, lib in (("cin_dw", "dw", "dw_einsum"),
                              ("cin_dx0", "dx0", "dx0_einsum")):
        nbytes, ops_ = cin_bwd_work(which, B, H, Hp, F, D, 4)
        b_ms, b_by = bound(nbytes, 3 * ops_, TF32_OPS_PER_S)
        rows.append({"name": kname, "route": "cuda",
                     "source": KERNEL_INFO[kname][0],
                     "replaces": KERNEL_INFO[kname][1],
                     "shape": f"{name}: g f32 [{B}, {H}, {D}], xk [{B}, "
                              f"{Hp}, {D}], x0 [{B}, {F}, {D}], w [{H}, "
                              f"{Hp}, {F}]",
                     "max_abs_err": abs_err[kname], "ms": t[kname],
                     "plain_ms": t[kname + "_plain"], "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": t[lib],
                     "f32_bound_ms": bound(nbytes, ops_)[0]})
    return rows


FLASH_GRAD_SHAPES = {
    "llama3.2-1b layer, bf16 [2, 4096, 32, 64], kv 8, causal":
        {"B": 2, "T": 4096, "H": 32, "Hk": 8, "d": 64,
         "window": GLOBAL_WINDOW, "cap": 0.0, "dtype": torch.bfloat16},
    "gemma2-9b local layer, bf16 [1, 8192, 16, 256], kv 8, window 4096, "
    "softcap 50":
        {"B": 1, "T": 8192, "H": 16, "Hk": 8, "d": 256, "window": 4096,
         "cap": 50.0, "dtype": torch.bfloat16},
    "gemma2-9b global layer, bf16 [1, 4096, 16, 256], softcap 50":
        {"B": 1, "T": 4096, "H": 16, "Hk": 8, "d": 256,
         "window": GLOBAL_WINDOW, "cap": 50.0, "dtype": torch.bfloat16},
    "llama3.2-1b layer, f32 [1, 1024, 32, 64], kv 8, causal":
        {"B": 1, "T": 1024, "H": 32, "Hk": 8, "d": 64,
         "window": GLOBAL_WINDOW, "cap": 0.0, "dtype": torch.float32},
    "deepseek-moe-16b layer, bf16 [1, 4096, 16, 128], kv 16, causal":
        {"B": 1, "T": 4096, "H": 16, "Hk": 16, "d": 128,
         "window": GLOBAL_WINDOW, "cap": 0.0, "dtype": torch.bfloat16},
}
# (B, Hp, F, H, D): serve_p99's and train_batch's two layer shapes (the
# kernels line reads train_batch's Hp = 200 layer)
CIN_GRAD_SHAPES = {"serve_p99 layer 0": (512, 39, 39, 200, 10),
                   "serve_p99 layer 1": (512, 200, 39, 200, 10),
                   "train_batch layer 0": (65536, 39, 39, 200, 10),
                   "train_batch layer 1": (65536, 200, 39, 200, 10)}
CIN_KERNELS_LINE_SHAPE = "train_batch layer 1"


def no_plain_backward(timer: CallTimer, path: str) -> None:
    """Fail if the flash backward's plain version ran on the card."""
    if timer.events:
        fail(f"flash_attention_bwd_plain ran {len(timer.events)} times on "
             f"the {path} path")


def train_path(device) -> tuple[dict, list, list]:
    """Slice 10's main path: llama3.2-1b and gemma2-9b through
    ``TrainLoop`` and xDeepFM through ``launch.train.main``, with the
    launch counts zeroed just before and read just after; then the
    gradient checks. Returns the counts, the flash backward's rows (the
    llama layer's first) and the CIN backward kernels' rows at
    ``CIN_KERNELS_LINE_SHAPE``."""
    with CallTimer(kernel_ops, "flash_attention") as fwd, \
            CallTimer(flash_module, "flash_attention_bwd") as bwd, \
            CallTimer(flash_module, "flash_attention_bwd_plain") as plain, \
            CallTimer(kernel_ops, "cin_layer") as cin_fwd, \
            CallTimer(cin_module, "cin_layer") as cin_bwd, \
            CallTimer(cin_module, "cin_weight_grad") as cin_dw, \
            CallTimer(cin_module, "cin_dx0") as cin_dx0_t, \
            CallTimer(cin_module, "cin_weight_grad_plain") as dw_plain, \
            CallTimer(cin_module, "cin_dx0_plain") as dx0_plain:
        _build.reset_launch_counts()
        lines = {arch: lm_train(arch, device, fwd, bwd) for arch in TRAIN_LM}
        torch.cuda.empty_cache()
        lines["xdeepfm"] = xdeepfm_train(device, cin_fwd, cin_bwd, cin_dw,
                                         cin_dx0_t)
        counts = _build.launch_counts()
        no_plain_backward(plain, "training")
        for timer in (dw_plain, dx0_plain):
            if timer.events:
                fail(f"{timer.name} ran {len(timer.events)} times on the "
                     "training path")
    emit({"phase": "train_path", "launches": counts})
    for name in ("flash_attention", "flash_attention_bwd", "cin", "cin_dw",
                 "cin_dx0"):
        if counts[name] <= 0:
            fail(f"kernel {name} was never launched on the training path")
    torch.cuda.empty_cache()
    checks = {"llama": lm_grad_check(device)}
    torch.cuda.empty_cache()
    checks["xdeepfm"] = xdeepfm_grad_check(device)
    torch.cuda.empty_cache()
    emit({"phase": "train_check", **checks, "ok": True})
    grad_rows = []
    for name, shape in FLASH_GRAD_SHAPES.items():
        grad_rows.append(flash_grad_row(name, shape, device))
        torch.cuda.empty_cache()
    for name, shp in CIN_GRAD_SHAPES.items():
        rows = cin_grad_row(name, *shp, device)
        if name == CIN_KERNELS_LINE_SHAPE:
            cin_rows = rows
        torch.cuda.empty_cache()
    cin_train_rows(device)
    torch.cuda.empty_cache()
    return counts, grad_rows, cin_rows


def cin_train_rows(device) -> list:
    """The CIN layer at train_batch's two layer shapes (B = 65,536; Hp =
    39 and 200) on seeded inputs, held against its plain version within
    CIN_TOL of the largest output, then timed as in 11 beside
    ``einsum``, bound by its bytes or its three TF32 products (the
    3xTF32 floor), the f32 rate's bound beside them."""
    gen = torch.Generator(device=device).manual_seed(12)
    rows = []
    for li, Hp in enumerate((39, 200)):
        B, F, H, D = TRAIN_XDEEPFM["B"], 39, 200, 10
        xk, x0 = normal((B, Hp, D), gen), normal((B, F, D), gen)
        w = normal((H, Hp, F), gen) * (2.0 / (Hp * F)) ** 0.5
        # held relative to the largest |output|, as the train_grad rows
        # hold the Function: of 131 M outputs of unit-normal inputs, some
        # cancel to near 0 and keep the 3xTF32 error of their terms
        got, want = kernel_ops.cin_layer(xk, x0, w), cin_layer_plain(xk, x0,
                                                                     w)
        if not rel_gap(got, want) <= CIN_TOL[torch.float32]:
            fail(f"cin train_batch layer {li}: {rel_gap(got, want)} of the "
                 f"largest output, above {CIN_TOL[torch.float32]}")
        err = float((got - want).abs().max())
        del got, want
        nbytes, ops_ = cin_work(B, H, Hp, F, D, 4)
        rows.append(kernel_row(
            "cin", f"train_batch layer {li}: xk f32 [{B}, {Hp}, {D}], x0 "
            f"[{B}, {F}, {D}], w [{H}, {Hp}, {F}]", err,
            lambda xk=xk, x0=x0, w=w: kernel_ops.cin_layer(xk, x0, w),
            lambda xk=xk, x0=x0, w=w: cin_layer_plain(xk, x0, w),
            lambda xk=xk, x0=x0, w=w: torch.einsum("hij,bid,bjd->bhd", w,
                                                   xk, x0),
            nbytes, 3 * ops_, 5, rate=TF32_OPS_PER_S, plain_reps=2,
            path="train", layer=li, f32_bound_ms=bound(nbytes, ops_)[0]))
        del xk, x0, w
        torch.cuda.empty_cache()
    return rows


# -- slice 11: the GNN family ----------------------------------------------
GNN_ARCHS = ("egnn", "gin-tu", "graphsage-reddit", "graphcast")
GNN_INIT = {"egnn": gnn_module.egnn_init, "gin-tu": gnn_module.gin_init,
            "graphsage-reddit": gnn_module.sage_init,
            "graphcast": gnn_module.graphcast_init}
# the archs each shape trains; ogb_products cuts EGNN and graphcast
GNN_SHAPE_ARCHS = {"full_graph_sm": GNN_ARCHS, "molecule": GNN_ARCHS,
                   "minibatch_lg": GNN_ARCHS,
                   "ogb_products": ("gin-tu", "graphsage-reddit")}
GNN_STEPS = 3
GNN_OPT = OptConfig(lr=1e-3, warmup_steps=1, total_steps=GNN_STEPS)
# the reference's molecule cells: 16 synthetic atom features a node
GNN_ATOM_FEATS = 16
GNN_SHARDS = 4
# push against pull on the card, relative to the largest |output|: the
# same float32 math over the edges in another order (sums in float64)
GNN_DIR_TOL = 1e-5
# four shards against one device: the same sums, grouped by shard
GNN_MP_TOL = 1e-5
# the card's float32 forward against the port's CPU forward in float64
# (its layer norms compute in float32, as the reference's do), relative
# to the largest |output|: float32 roundings through up to 16 layers
GNN_F64_TOL = 1e-3
GNN_REDUCED = {
    "steps": f"{GNN_STEPS} AdamW steps (lr 1e-3), not a training run",
    "why": "the smoke's time limit"}
GNN_CARD_GRAPH = ("built on the card (uniform pairs, both directions, self "
                  "loops and duplicates dropped), not by erdos_renyi's "
                  "numpy code, which takes ~2 min on the host at these "
                  "sizes")
# graphcast keeps ~5.9 GB of activations a layer at minibatch_lg's
# 169,984 nodes and 168,960 edges (4.3 GB peak for 13,254 rows at
# full_graph_sm): 16 layers would need ~95 GB
GNN_DEPTH_CUT = {("minibatch_lg", "graphcast"): 8}
GNN_OGB_CUT = {"egnn": "EGNN's edge MLP keeps ~450 floats an edge, ~111 GB "
                       "at 61.9 M edges",
               "graphcast": "graphcast's [m, 3·512] edge input alone is "
                            "380 GB at 61.9 M edges"}


def pair_weights(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A weight in [1, 10) per undirected pair, the same both ways: a hash
    of the pair (erdos_renyi draws one per pair)."""
    lo, hi = torch.minimum(a, b).long(), torch.maximum(a, b).long()
    h = (lo * 2654435761 + hi * 40503) % 1000003
    return (1.0 + 9.0 * h.double() / 1000003).float()


def card_erdos_renyi(n: int, m: int, seed: int, device) -> "Graph":
    """An Erdős–Rényi graph of n vertices and about m directed edges,
    every view of ``build_graph`` built on the card: m / 2 uniform pairs
    without self loops, both directions, duplicates dropped; pull-major
    rows sorted by source."""
    gen = torch.Generator(device=device).manual_seed(seed)
    a = torch.randint(0, n, (m // 2,), generator=gen, device=device)
    b = torch.randint(0, n, (m // 2,), generator=gen, device=device)
    keep = a != b
    a, b = a[keep], b[keep]
    key = torch.unique(torch.cat([a * n + b, b * n + a]))
    del a, b, keep
    return card_graph(key % n, key // n, n, device)


def card_graph(p_src: torch.Tensor, p_dst: torch.Tensor, n: int, device,
               dense: bool = True) -> "Graph":
    """Every view of ``build_graph`` built on the card from a symmetric
    edge set without repeats or self loops, sorted by destination, then
    source (so the pairs turned round are its push-major order), with
    ``pair_weights``. ``dense`` False leaves out the dense ELL: the row
    layout, as ``build_graph`` gives a graph whose dense ELL would be
    mostly padding."""
    p_src = p_src.to(device=device, dtype=torch.int64)
    p_dst = p_dst.to(device=device, dtype=torch.int64)
    q_src, q_dst = p_dst, p_src
    in_deg = torch.bincount(p_dst, minlength=n)
    out_deg = torch.bincount(q_src, minlength=n)
    zero = torch.zeros(1, dtype=torch.int64, device=device)
    in_ptr = torch.cat([zero, in_deg.cumsum(0)])
    out_ptr = torch.cat([zero, out_deg.cumsum(0)])
    d_ell = max(8, -(-int(in_deg.max()) // 8) * 8)
    p_w, q_w = pair_weights(p_src, p_dst), pair_weights(q_src, q_dst)
    ell_idx = ell_w = None
    if dense:
        within = torch.arange(p_src.numel(), device=device) - in_ptr[p_dst]
        ell_idx = torch.full((n, d_ell), n, dtype=torch.int32,
                             device=device)
        ell_idx[p_dst, within] = p_src.to(torch.int32)
        ell_w = torch.zeros((n, d_ell), device=device)
        ell_w[p_dst, within] = p_w
        del within
    i32 = (lambda t: t.to(torch.int32))
    return Graph(coo_src=i32(p_src), coo_dst=i32(p_dst), coo_w=p_w,
                 in_ptr=i32(in_ptr), push_src=i32(q_src),
                 push_dst=i32(q_dst), push_w=q_w, out_ptr=i32(out_ptr),
                 dense_idx=ell_idx, dense_w=ell_w, in_deg=i32(in_deg),
                 out_deg=i32(out_deg), n=n, m=int(p_src.numel()),
                 d_ell=d_ell)


def sampled_graph(blocks, device):
    """The sampled blocks as one graph over their nodes, hop 0 first (the
    reference's minibatch_lg cell): an edge from each valid child to its
    parent. Returns (graph, the nodes' ids in the full graph)."""
    sizes = [ids.numel() for ids in blocks.node_ids]
    offs = np.concatenate([[0], np.cumsum(sizes)])
    src, dst, ok = [], [], []
    for k in range(1, len(sizes)):
        i = torch.arange(sizes[k], device=device)
        src.append(offs[k] + i)
        dst.append(offs[k - 1] + i // blocks.fanouts[k - 1])
        ok.append(blocks.valid[k])
    ok = torch.cat(ok)
    src, dst = torch.cat(src)[ok], torch.cat(dst)[ok]
    ids = torch.cat(blocks.node_ids).long()
    w = pair_weights(ids[src], ids[dst])
    g = build_graph(src.cpu().numpy(), dst.cpu().numpy(), n=int(offs[-1]),
                    weights=w.cpu().numpy(), device=device)
    return g, ids


def gnn_config(arch: str, shape: str, direction: str):
    """The reference's cell config: d_in the shape's features, d_out its
    classes (1 for molecule's graph regression; 0 for graphcast, which
    reads and predicts its variables)."""
    p = GNN_SHAPES[shape].params
    d_in = GNN_ATOM_FEATS if shape == "molecule" else p["d_feat"]
    d_out = (0 if arch == "graphcast" else 1 if shape == "molecule"
             else p["n_classes"])
    cfg = full_config(arch)
    return dataclasses.replace(
        cfg, d_in=d_in, d_out=d_out, direction=direction,
        n_layers=GNN_DEPTH_CUT.get((shape, arch), cfg.n_layers))


def gnn_forward(arch: str, p, cfg, g, b: dict, n_graphs: int):
    if arch == "egnn":
        return gnn_module.egnn_apply(p, cfg, g, b["feats"], b["coords"])[0]
    if arch == "gin-tu":
        return gnn_module.gin_apply(p, cfg, g, b["feats"],
                                    graph_ids=b.get("graph_ids"),
                                    num_graphs=n_graphs)
    if arch == "graphsage-reddit":
        return gnn_module.sage_apply(p, cfg, g, b["feats"])
    return gnn_module.graphcast_apply(p, cfg, g, b["vars"])


def gnn_loss(arch: str, shape: str, cfg, g, labeled: int, n_graphs: int):
    """The reference cell's loss: softmax cross entropy on the labeled
    rows, MSE on graph-pooled outputs (molecule), MSE on the variables
    (graphcast)."""
    def loss_fn(p, b):
        out = gnn_forward(arch, p, cfg, g, b, n_graphs)
        if arch == "graphcast":
            return mse(out, b["target"])
        if shape == "molecule":
            if out.shape[0] != n_graphs:          # per-node output: pool
                out = segment_sum(out, b["graph_ids"], n_graphs)
            return mse(out[:, 0], b["labels"])
        return softmax_xent_dense(out[:labeled], b["labels"][:labeled])
    return loss_fn


def gnn_batch(arch: str, shape: str, n: int, gen, device,
              feats=None, graph_ids=None, labels=None) -> dict:
    """Seeded inputs on the card: node features (``feats`` if given),
    coordinates (EGNN), labels; graphcast's variables and target."""
    if arch == "graphcast":             # reads and predicts its variables
        n_vars = full_config(arch).n_vars
        return {"vars": normal((n, n_vars), gen),
                "target": normal((n, n_vars), gen)}
    p = GNN_SHAPES[shape].params
    b = {"feats": feats if feats is not None else normal(
        (n, p["d_feat"]), gen)}
    if arch == "egnn":
        b["coords"] = normal((n, 3), gen)
    if graph_ids is not None:
        b["graph_ids"] = graph_ids
    b["labels"] = labels if labels is not None else torch.randint(
        0, p["n_classes"], (n,), generator=gen, device=device)
    return b


def gnn_train(arch: str, shape: str, direction: str, g, batch: dict,
              labeled: int, n_graphs: int, device, reduced: dict) -> tuple:
    """``TrainLoop`` (AdamW) on the arch's full-width cell; one line with
    the step times, peak memory and losses. Returns the forward at the
    initial weights and the weights."""
    cfg = gnn_config(arch, shape, direction)
    params = GNN_INIT[arch](cfg, seed=0, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loop = TrainLoop(gnn_loss(arch, shape, cfg, g, labeled, n_graphs),
                     params, GNN_OPT,
                     LoopConfig(total_steps=GNN_STEPS, log_every=1))
    res = loop.run(iter([batch] * GNN_STEPS))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    del loop
    losses = [h["loss"] for h in res["history"]]
    dts = [h["dt"] * 1e3 for h in res["history"]]
    if not all(np.isfinite(losses)):
        fail(f"gnn {arch} {shape} {direction}: non-finite losses {losses}")
    with torch.no_grad():
        out = gnn_forward(arch, params, cfg, g, batch, n_graphs)
    emit({"phase": "gnn", "shape": shape, "arch": arch,
          "direction": direction, "n": g.n, "m": g.m,
          "layers": cfg.n_layers, "d_hidden": cfg.d_hidden,
          "d_in": cfg.d_in, "d_out": cfg.d_out,
          "params": param_count(params), "losses": losses, "step_ms": dts,
          "step_ms_median_2_3": statistics.median(dts[1:]),
          "peak_memory_gb": peak_gb,
          "reduced": reduced | ({"layers": f"{cfg.n_layers} of "
                                           f"{full_config(arch).n_layers}: "
                                           "~5.9 GB of activations a layer"}
                               if (shape, arch) in GNN_DEPTH_CUT else {})})
    torch.cuda.empty_cache()
    return out, params


def cpu_float64_forward(arch: str, cfg, params, g, batch: dict,
                        n_graphs: int) -> torch.Tensor:
    """The port's forward on the CPU in float64, on the same graph,
    weights and inputs."""
    cpu = torch.device("cpu")
    g64 = graph_from_arrays({f: getattr(g, f).cpu().numpy()
                             for f in GRAPH_ARRAYS}, n=g.n, m=g.m,
                            d_ell=g.d_ell, device=cpu)
    p64 = tree_map(lambda t: t.detach().to(cpu, torch.float64), params)
    b64 = {k: v.to(cpu, torch.float64) if v.is_floating_point()
           else v.to(cpu) for k, v in batch.items()}
    with torch.no_grad():
        return gnn_forward(arch, p64, dataclasses.replace(
            cfg, dtype="float64"), g64, b64, n_graphs)


def gnn_shape(shape: str, g, batches: dict, labeled: int, n_graphs: int,
              device, reduced: dict, f64_check: bool) -> None:
    """Every arch of the shape, pull then push: push equals pull, and
    (``f64_check``) the card's forward equals the CPU's in float64."""
    for arch in GNN_SHAPE_ARCHS[shape]:
        outs = {}
        for direction in ("pull", "push"):
            outs[direction], params = gnn_train(
                arch, shape, direction, g, batches[arch], labeled, n_graphs,
                device, reduced)
        check = {"push_vs_pull": rel_gap(outs["push"], outs["pull"]),
                 "tol": GNN_DIR_TOL}
        if not check["push_vs_pull"] <= GNN_DIR_TOL:
            fail(f"gnn {arch} {shape}: push against pull {check}")
        if f64_check:
            cfg = gnn_config(arch, shape, "pull")
            want = cpu_float64_forward(arch, cfg, params, g, batches[arch],
                                       n_graphs)
            check["card_vs_cpu_float64"] = rel_gap(outs["pull"].cpu(), want)
            check["f64_tol"] = GNN_F64_TOL
            if not check["card_vs_cpu_float64"] <= GNN_F64_TOL:
                fail(f"gnn {arch} {shape}: card against CPU float64 {check}")
        emit({"phase": "gnn_check", "shape": shape, "arch": arch, **check,
              "ok": True})
        del outs, params
        torch.cuda.empty_cache()


def edges_by_owner(src: torch.Tensor, dst: torch.Tensor, n: int,
                   P: int) -> tuple:
    """[P, cap] rows of the edges each destination shard owns (n / P rows
    a shard), sentinel-padded with n: ``gin_apply_mp``'s layout."""
    owner = dst.long() // (n // P)
    order = torch.argsort(owner, stable=True)
    owner = owner[order]
    counts = torch.bincount(owner, minlength=P)
    cap = max(8, -(-int(counts.max()) // 8) * 8)
    start = torch.cat([counts.new_zeros(1), counts.cumsum(0)[:-1]])
    pos = torch.arange(owner.numel(), device=src.device) - start[owner]
    e_src = torch.full((P, cap), n, dtype=torch.int32, device=src.device)
    e_dst = torch.full_like(e_src, n)
    e_src[owner, pos] = src[order].to(torch.int32)
    e_dst[owner, pos] = dst[order].to(torch.int32)
    return e_src, e_dst


def gin_mp_check(shape: str, g, feats: torch.Tensor, device) -> dict:
    """``gin_apply_mp`` on four shards on one card against ``gin_apply``
    (forward, the arch's full width): rows padded to a multiple of 4
    with zero features and no edges; both timed (the second call)."""
    cfg = gnn_config("gin-tu", shape, "pull")
    params = gnn_module.gin_init(cfg, seed=0, device=device)
    n_pad = -(-g.n // GNN_SHARDS) * GNN_SHARDS
    h = torch.cat([feats, feats.new_zeros((n_pad - g.n, feats.shape[1]))])
    e_src, e_dst = edges_by_owner(g.coo_src, g.coo_dst, n_pad, GNN_SHARDS)
    mesh = make_shard_mesh(GNN_SHARDS, devices=[device] * GNN_SHARDS)
    with torch.no_grad():
        runs = {}
        for name, fn in (
                ("mp", lambda: gnn_module.gin_apply_mp(params, cfg, h, e_src,
                                                       e_dst, mesh)[:g.n]),
                ("single", lambda: gnn_module.gin_apply(params, cfg, g,
                                                        feats))):
            fn()
            runs[name] = synced_ms(fn)
    line = {"phase": "gnn_mp", "shape": shape, "shards": GNN_SHARDS,
            "devices": "one card, four shards", "n": g.n, "n_padded": n_pad,
            "edge_rows_cap": e_src.shape[1],
            "forward_ms_mp": runs["mp"][1],
            "forward_ms_single": runs["single"][1],
            "mp_vs_single": rel_gap(runs["mp"][0], runs["single"][0]),
            "tol": GNN_MP_TOL}
    emit(line)
    if not line["mp_vs_single"] <= GNN_MP_TOL:
        fail(f"gin_apply_mp {shape}: {line}")
    del runs
    torch.cuda.empty_cache()
    return line


def sage_blocks_train(g, feats: torch.Tensor, labels: torch.Tensor,
                      device) -> dict:
    """``sage_apply_blocks`` on blocks sampled from the full graph each
    step (1,024 seeds, the shape's fanouts), AdamW: step and sampling
    times beside each other."""
    p = GNN_SHAPES["minibatch_lg"].params
    fanouts = tuple(p["fanout"])
    cfg = dataclasses.replace(gnn_config("graphsage-reddit", "minibatch_lg",
                                         "pull"), fanouts=fanouts)
    params = gnn_module.sage_init(cfg, seed=0, device=device)
    gen = torch.Generator(device=device).manual_seed(7)
    padded = torch.cat([feats, feats.new_zeros((1, feats.shape[1]))])
    sample_ms = []

    def batches():
        while True:
            seeds = torch.randint(0, g.n, (p["batch_nodes"],),
                                  generator=gen, device=device)
            blocks, ms = synced_ms(lambda: sample_blocks(g, seeds, fanouts,
                                                         gen=gen))
            sample_ms.append(ms)
            yield {"ids": list(blocks.node_ids),
                   "valid": list(blocks.valid),
                   "feats": [padded[torch.clamp(ids.long(), max=g.n)]
                             for ids in blocks.node_ids],
                   "labels": labels[seeds]}

    def loss_fn(prm, b):
        blocks = SampledBlocks(node_ids=tuple(b["ids"]),
                               valid=tuple(b["valid"]), fanouts=fanouts,
                               sentinel=g.n)
        return softmax_xent_dense(gnn_module.sage_apply_blocks(
            prm, cfg, blocks, b["feats"]), b["labels"])

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    loop = TrainLoop(loss_fn, params, GNN_OPT,
                     LoopConfig(total_steps=GNN_STEPS, log_every=1))
    res = loop.run(batches())
    losses = [h["loss"] for h in res["history"]]
    dts = [h["dt"] * 1e3 for h in res["history"]]
    if not all(np.isfinite(losses)):
        fail(f"sage_apply_blocks: non-finite losses {losses}")
    line = {"phase": "gnn_blocks", "shape": "minibatch_lg",
            "arch": "graphsage-reddit", "seeds": p["batch_nodes"],
            "fanouts": list(fanouts), "graph_n": g.n, "graph_m": g.m,
            "losses": losses, "step_ms": dts,
            "step_ms_median_2_3": statistics.median(dts[1:]),
            "sample_ms": sample_ms,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "reduced": GNN_REDUCED | {"graph": GNN_CARD_GRAPH}}
    emit(line)
    return line


def gnn_path(device) -> dict:
    """Slice 11's GNN path: the four archs train (AdamW, full width, pull
    and push) on the reference's cells: full_graph_sm and molecule
    uncut, minibatch_lg's sampled subgraph, ogb_products (GIN and
    GraphSAGE); ``sage_apply_blocks`` on blocks sampled from the full
    minibatch_lg graph; ``gin_apply_mp`` on four shards on one card. The
    launch counts are zeroed before and read after: the GNN path reaches
    no kernel of the repo (its reductions are ``segment_sum``, as the
    reference's are)."""
    t0 = time.perf_counter()
    _build.reset_launch_counts()
    gen = torch.Generator(device=device).manual_seed(11)

    # full_graph_sm: the port's erdos_renyi at the shape's n and m
    p = GNN_SHAPES["full_graph_sm"].params
    g = erdos_renyi(p["n_nodes"], p["n_edges"] / (2 * p["n_nodes"]), seed=0,
                    weighted=True, device=device)
    feats = normal((g.n, p["d_feat"]), gen)
    labels = torch.randint(0, p["n_classes"], (g.n,), generator=gen,
                           device=device)
    batches = {a: gnn_batch(a, "full_graph_sm", g.n, gen, device, feats=feats,
                            labels=labels) for a in GNN_ARCHS}
    gnn_shape("full_graph_sm", g, batches, g.n, 1, device, GNN_REDUCED, True)
    gin_mp_check("full_graph_sm", g, feats, device)

    # molecule: 128 graphs of 30 atoms, 64 edges each
    p = GNN_SHAPES["molecule"].params
    mol = next(molecule_batches(p["batch"], p["n_nodes"], p["n_edges"],
                                GNN_ATOM_FEATS, seed=0))
    g = build_graph(mol["src"].numpy(), mol["dst"].numpy(),
                    n=p["batch"] * p["n_nodes"], device=device)
    mol = on_device(mol, device)
    batches = {a: gnn_batch(a, "molecule", g.n, gen, device,
                            feats=mol["feats"], graph_ids=mol["graph_ids"],
                            labels=mol["labels"]) for a in GNN_ARCHS}
    batches["egnn"]["coords"] = mol["coords"]
    gnn_shape("molecule", g, batches, 0, p["batch"], device, GNN_REDUCED,
              True)

    # minibatch_lg: the full graph on the card, then the reference's
    # sampled subgraph (1,024 seeds, fanout (15, 10))
    p = GNN_SHAPES["minibatch_lg"].params
    (full, build_ms) = synced_ms(lambda: card_erdos_renyi(
        p["n_nodes"], p["n_edges"], 1, device))
    emit({"phase": "gnn_graph", "shape": "minibatch_lg", "n": full.n,
          "m": full.m, "d_ell": full.d_ell, "build_ms": build_ms,
          "how": GNN_CARD_GRAPH})
    feats = normal((full.n, p["d_feat"]), gen)
    labels = torch.randint(0, p["n_classes"], (full.n,), generator=gen,
                           device=device)
    sage_blocks_train(full, feats, labels, device)
    seeds = torch.randint(0, full.n, (p["batch_nodes"],), generator=gen,
                          device=device)
    blocks = sample_blocks(full, seeds, tuple(p["fanout"]), gen=gen)
    g, ids = sampled_graph(blocks, device)
    sub_feats = torch.cat([feats, feats.new_zeros((1, p["d_feat"]))])[
        torch.clamp(ids, max=full.n)]
    sub_labels = labels[torch.clamp(ids, max=full.n - 1)]
    del full, feats, labels, blocks
    torch.cuda.empty_cache()
    batches = {a: gnn_batch(a, "minibatch_lg", g.n, gen, device,
                            feats=sub_feats, labels=sub_labels)
               for a in GNN_ARCHS}
    gnn_shape("minibatch_lg", g, batches, p["batch_nodes"], 1, device,
              GNN_REDUCED | {"graph": GNN_CARD_GRAPH}, False)
    del batches, g, sub_feats, sub_labels
    torch.cuda.empty_cache()

    # ogb_products: GIN and GraphSAGE on the full graph
    p = GNN_SHAPES["ogb_products"].params
    (g, build_ms) = synced_ms(lambda: card_erdos_renyi(
        p["n_nodes"], p["n_edges"], 2, device))
    emit({"phase": "gnn_graph", "shape": "ogb_products", "n": g.n, "m": g.m,
          "d_ell": g.d_ell, "build_ms": build_ms, "how": GNN_CARD_GRAPH})
    feats = normal((g.n, p["d_feat"]), gen)
    labels = torch.randint(0, p["n_classes"], (g.n,), generator=gen,
                           device=device)
    batches = {a: gnn_batch(a, "ogb_products", g.n, gen, device,
                            feats=feats, labels=labels)
               for a in GNN_SHAPE_ARCHS["ogb_products"]}
    gnn_shape("ogb_products", g, batches, g.n, 1, device,
              GNN_REDUCED | {"graph": GNN_CARD_GRAPH,
                             "archs": GNN_OGB_CUT}, False)
    del batches
    torch.cuda.empty_cache()
    gin_mp_check("ogb_products", g, feats, device)
    del g, feats, labels
    torch.cuda.empty_cache()
    counts = _build.launch_counts()
    emit({"phase": "gnn_path", "launches": counts,
          "seconds": time.perf_counter() - t0,
          "note": "no kernel of the repo on this path: the reductions are "
                  "segment_sum (float64 index_add_ on the card)"})
    return counts


# -- slice 11: the MoE family ----------------------------------------------
MOE_LM_RUNS = {
    "deepseek-moe-16b": {
        "B": 1, "T": 4096, "steps": 16, "layers": None,
        "reduced": {"batch": "1, not prefill_32k's 32",
                    "seq_len": "4,096, not 32,768",
                    "decode": "16 steps against a 4,112-slot cache, not "
                              "decode_32k's 128 rows at 32,768",
                    "why": "the smoke's time limit"}},
    "moonshot-v1-16b-a3b": {
        "B": 1, "T": 4096, "steps": 16, "layers": 4,
        "reduced": {"layers": "4 of 48 (full depth holds 57.8 GB of bf16 "
                              "weights; it differs from deepseek-moe-16b, "
                              "which runs at full depth, only in depth and "
                              "vocab)",
                    "batch": "1, not prefill_32k's 32",
                    "seq_len": "4,096, not 32,768", "decode": "16 steps",
                    "why": "the smoke's time limit"}},
}
MOE_TRAIN = {
    "deepseek-moe-16b": {
        "B": 1, "T": 4096, "micro": 1, "steps": 3, "ckpt_at": None,
        "layers": 4,
        "reduced": {"layers": "4 of 28 (~2.8 B parameters, ~34 GB with "
                              "AdamW's f32 moments; 28 layers do not fit in "
                              "80 GB)",
                    "global_batch": "1 × 4,096, not train_4k's 256 × 4,096",
                    "steps": "3", "why": "the smoke's time limit"}}}
MOE_EP_TOKENS = 4096
MOE_EP_SHARDS = 4
# a capacity that drops no token: cap = int(11 · S · 6 / 64) > S, and in
# the a2a schedule int(11 · S/4 · 6 / 64) > S/4 per (rank, expert)
MOE_EP_CAPACITY = 11.0
# the same routing (pinned, below), outputs relative to the largest
# |output|: f32 sums in other orders; bf16 as LM_TOL's per-op rounding,
# two more bf16 roundings of partial outputs
MOE_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


class RoutePin:
    """Pins the experts the router picks (``models.moe._route``): while
    ``record`` is set each call's expert ids are kept; while ``replay``
    holds a list, each call takes the next ids from it (rows as the
    call's tokens) and its gates from its own router probabilities. Two
    runs of one MoE model in bf16 (the flash kernel against plain
    attention, say) see router logits ~1e-2 apart, and a token whose
    k-th and (k+1)-th experts lie that close flips; pinned, they compute
    the same function and can be held to a rounding tolerance. The flips
    are counted, not hidden: see ``flips``."""

    def __init__(self):
        self.record, self.replay, self.kept = False, None, []
        self._real = moe_module._route

    def __enter__(self):
        def route(router, cfg, xf):
            probs, gate_vals, gate_idx = self._real(router, cfg, xf)
            if self.replay is not None:
                gate_idx = self.replay.pop(0)
                gate_vals = probs.gather(-1, gate_idx)
                gate_vals = gate_vals / torch.clamp(
                    gate_vals.sum(-1, keepdim=True), min=1e-9)
            elif self.record:
                self.kept.append(gate_idx)
            return probs, gate_vals, gate_idx
        moe_module._route = route
        return self

    def __exit__(self, *exc):
        moe_module._route = self._real

    def take(self) -> list:
        out, self.kept = self.kept, []
        return out


def flips(a: list, b: list) -> float:
    """Share of (call, token) expert sets that differ between two runs."""
    diff = sum(int((x.sort(-1).values != y.sort(-1).values).any(-1).sum())
               for x, y in zip(a, b))
    return diff / max(1, sum(x.shape[0] for x in a))


def moe_lm_check(arch: str, st: dict) -> dict:
    """lm_check for a MoE LM with its routing pinned: the kernel prefill
    (recorded) against ``attn_impl="naive"`` (replayed) on logits and
    cache; then, at a capacity that drops no token, the first decode
    step against a prefill one token longer (replaying the shorter
    prefill's and the step's routing), since a prefill drops the last
    tokens of a full expert queue and a decode step never does. Each
    within ``lm_tol`` of the largest value (LM_TOL scaled past 16
    layers). The naive prefill also runs unpinned: its share of flipped
    expert sets is printed."""
    cfg, params, toks, T = st["cfg"], st["params"], st["toks"], st["T"]
    naive = dataclasses.replace(cfg, attn_impl="naive")
    wide = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k + 1))
    with RoutePin() as pin:
        pin.record = True
        logits, cache = prefill(params, cfg, toks[:, :T], "bf16")
        rec_t = pin.take()
        prefill(params, naive, toks[:, :T], "bf16")
        free = pin.take()
        _, cache_w = prefill(params, wide, toks[:, :T], "bf16")
        rec_w = pin.take()
        first, _ = decode_step(params, wide, toks[:, T:T + 1],
                               pad_kv_cache(cache_w, T + 1), T)
        rec_d = pin.take()
        pin.record = False
        pin.replay = list(rec_t)
        logits_n, cache_n = prefill(params, naive, toks[:, :T], "bf16")
        pin.replay = [torch.cat([a, b]) for a, b in zip(rec_w, rec_d)]
        longer, _ = prefill(params, wide, toks[:, :T + 1], "bf16")
    gaps = {"logits": rel_gap(logits, logits_n),
            "decode_vs_prefill": rel_gap(first, longer)}
    for name, buf in cache.items():
        gaps["cache." + name] = rel_gap(buf, cache_n[name])
    tol = lm_tol(cfg)
    bad = {k: v for k, v in gaps.items() if not v <= tol}
    line = {"phase": "lm_check", "path": "moe", "arch": arch,
            "relative_gap": gaps, "tol": tol, "routing": "pinned",
            "decode_capacity_factor": wide.moe.capacity_factor,
            "unpinned_flipped_share": flips(rec_t, free), "ok": not bad}
    emit(line)
    if bad:
        fail(f"{arch}: {bad} above {tol} of the largest value")
    return line


def moe_dispatch_check(arch: str, st: dict) -> dict:
    """The first layer's MoE FFN on its prefill input, push dispatch
    against pull (bf16, the model's weights), both timed."""
    (lp, mcfg, h), _ = st["moe_args"]
    ys = {}
    for dispatch in ("pull", "push"):
        c = dataclasses.replace(mcfg, dispatch=dispatch)
        with torch.no_grad():
            ys[dispatch] = moe_module.moe_apply(lp, c, h)
            ms = [synced_ms(lambda c=c: moe_module.moe_apply(lp, c, h))[1]
                  for _ in range(3)]
        ys[dispatch + "_ms"] = statistics.median(ms)
    line = {"phase": "moe_dispatch", "arch": arch, "layer": 0,
            "tokens": h.shape[0] * h.shape[1], "dtype": str(h.dtype),
            "pull_ms": ys["pull_ms"], "push_ms": ys["push_ms"],
            "push_vs_pull": rel_gap(ys["push"], ys["pull"]),
            "tol": MOE_TOL[h.dtype]}
    emit(line)
    if not line["push_vs_pull"] <= MOE_TOL[h.dtype]:
        fail(f"{arch} MoE push against pull: {line}")
    return line


def moe_ep_check(device) -> list:
    """``moe_apply_ep`` at deepseek-moe-16b's width (one layer, S =
    4,096, a capacity that drops nothing) on four shards on one card,
    "psum" with f32 and bf16 combine and "a2a", against ``moe_apply``,
    in bf16 (the model's dtype) and f32, all timed. Each is run once
    with its own routing (the flipped share is printed: the a2a shards'
    router GEMMs over their slices round otherwise than one over all
    tokens), then with ``moe_apply``'s routing pinned and compared."""
    arch = "deepseek-moe-16b"
    base = dataclasses.replace(full_config(arch).moe,
                               capacity_factor=MOE_EP_CAPACITY)
    gen = torch.Generator(device=device).manual_seed(9)
    params = moe_module.moe_init(gen, base, torch.bfloat16)
    x16 = normal((1, MOE_EP_TOKENS, base.d_model), gen, torch.bfloat16)
    mesh = make_shard_mesh(MOE_EP_SHARDS, axis="model",
                           devices=[device] * MOE_EP_SHARDS)
    lines = []
    for dt in (torch.bfloat16, torch.float32):
        p = tree_map(lambda t: t.to(dt) if t.dtype == torch.bfloat16 else t,
                     params)
        x = x16.to(dt)
        with torch.no_grad(), RoutePin() as pin:
            pin.record = True
            want = moe_module.moe_apply(p, base, x)
            (route,) = pin.take()
            pin.record = False
            plain_ms = statistics.median(
                synced_ms(lambda: moe_module.moe_apply(p, base, x))[1]
                for _ in range(3))
            for mode, comb in (("psum", "f32"), ("psum", "bf16"),
                               ("a2a", "f32")):
                cfg = dataclasses.replace(base, ep_mode=mode,
                                          combine_dtype=comb)
                rows = ([route] * MOE_EP_SHARDS if mode == "psum" else
                        list(route.split(MOE_EP_TOKENS // MOE_EP_SHARDS)))
                set_activation_mesh(mesh)
                try:
                    pin.record = True
                    moe_module.moe_apply_ep(p, cfg, x)
                    flipped = flips(rows, pin.take())
                    pin.record = False
                    ms = []
                    for _ in range(3):
                        pin.replay = list(rows)
                        got, t = synced_ms(
                            lambda: moe_module.moe_apply_ep(p, cfg, x))
                        ms.append(t)
                finally:
                    set_activation_mesh(None)
                    pin.replay = None
                tol = MOE_TOL[torch.bfloat16 if comb == "bf16" else dt]
                line = {"phase": "moe_ep", "arch": arch, "dtype": str(dt),
                        "tokens": MOE_EP_TOKENS, "shards": MOE_EP_SHARDS,
                        "devices": "one card, four shards", "ep_mode": mode,
                        "combine_dtype": comb,
                        "capacity_factor": MOE_EP_CAPACITY,
                        "ep_ms": statistics.median(ms),
                        "moe_apply_ms": plain_ms,
                        "vs_moe_apply": rel_gap(got, want), "tol": tol,
                        "unpinned_flipped_share": flipped}
                emit(line)
                lines.append(line)
                if not line["vs_moe_apply"] <= tol:
                    fail(f"moe_apply_ep {mode}/{comb} {dt}: {line}")
        del p, x
    return lines


def moe_path(device) -> dict:
    """Slice 11's MoE path: deepseek-moe-16b serves at full depth (prefill
    1 × 4,096 with the flash kernel, 16 decode steps) and
    moonshot-v1-16b-a3b at 4 layers, then deepseek-moe-16b trains at 4
    layers through ``TrainLoop``; the launch counts are zeroed before
    each and read after it, and the serving checks run between the two:
    pinned-routing lm_check, the first layer's push against pull
    dispatch, the flash kernel at deepseek's layer shape. Then
    ``moe_apply_ep`` on four shards and the gradients with the kernel
    against the plain path."""
    t0 = time.perf_counter()
    with CallTimer(kernel_ops, "flash_attention") as flash, \
            CallTimer(flash_module, "flash_attention_bwd") as bwd, \
            CallTimer(flash_module, "flash_attention_bwd_plain") as plain, \
            CallTimer(transformer_module, "moe_apply_ep") as moe_t:
        _build.reset_launch_counts()
        lms = {}
        for arch, run in MOE_LM_RUNS.items():
            lms[arch] = lm_serve(arch, device, flash, run=run, path="moe",
                                 keep=(moe_t,))
            lms[arch]["moe_args"] = moe_t.kept[0]
            moe_t.kept = []
            moe_t.take_ms()
        counts = _build.launch_counts()
        for arch, st in lms.items():
            moe_lm_check(arch, st)
        deepseek = lms["deepseek-moe-16b"]
        moe_dispatch_check("deepseek-moe-16b", deepseek)
        rows = model_kernel_rows({"deepseek-moe-16b": deepseek}, None,
                                 path="moe")
        flash.take_ms()
        del lms, deepseek
        torch.cuda.empty_cache()
        _build.reset_launch_counts()
        train = {arch: lm_train(arch, device, flash, bwd, run=run,
                                path="moe")
                 for arch, run in MOE_TRAIN.items()}
        trained = _build.launch_counts()
        no_plain_backward(plain, "MoE")
    counts = {k: counts[k] + trained[k] for k in counts}
    emit({"phase": "moe_path", "launches": counts,
          "seconds": time.perf_counter() - t0})
    if counts["flash_attention"] <= 0 or trained["flash_attention"] <= 0:
        fail("kernel flash_attention was not launched on the MoE path")
    if trained["flash_attention_bwd"] <= 0:
        fail("kernel flash_attention_bwd was not launched on the MoE path")
    torch.cuda.empty_cache()
    moe_ep_check(device)
    torch.cuda.empty_cache()
    with RoutePin() as pin:
        grads = lm_grad_check(device, "deepseek-moe-16b", pin)
    emit({"phase": "moe_check", "grads": grads, "routing": "pinned",
          "ok": True})
    torch.cuda.empty_cache()
    return {"counts": counts, "rows": rows, "train": train}


# ------------------------------------------------- slice 12: the cells --
# the card runs every cell whose predicted arguments and peak stay below
CARD_RUN_LIMIT = 70e9
# measured peak against predicted, either way
PEAK_TOL = 0.2
# cells the card run must include (and one GNN cell)
CARD_MUST = ("xdeepfm@serve_p99", "xdeepfm@train_batch",
             "llama3.2-1b@long_500k")
# cells the card could not hold (graphcast at 16 layers, EGNN's edge MLPs)
NO_FIT = ("graphcast@minibatch_lg", "egnn@ogb_products")
HILLCLIMB_PICKS = (("qwen", "v1_pad_heads"), ("gin", "v1_shard_all"),
                   ("deepseek", "v1_bf16_combine"))


def _dry_cost(job) -> int:
    """A rough order for the pool: the MoE and long LM trains first."""
    arch, shape, _ = job
    moe = arch.startswith(("moonshot", "deepseek"))
    return -(4 * moe + 2 * (shape == "train_4k") + (ARCH_FAMILY[arch] == "lm"))


def dry_run_all(out_dir: Path) -> dict:
    """``"cells"`` and ``"hillclimb"``: the dry run of the 40 cells at the
    single-pod and multi-pod meshes and three hillclimb variants, on
    ``meta``, in worker processes (one per CPU core; the card idles).
    One line per cell; any failure fails. Returns {(arch, shape,
    multi_pod): result}."""
    import concurrent.futures as cf
    import multiprocessing
    jobs = sorted([(a, s, mp) for mp in (False, True) for a, s in all_cells()],
                  key=_dry_cost)
    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    results, errors = {}, []
    with cf.ProcessPoolExecutor(os.cpu_count() or 1, mp_context=ctx) as pool:
        hc = {pool.submit(hillclimb_main, ["--cell", c, "--variant", v,
                                           "--out", str(out_dir / f"{c}.json")]):
              (c, v) for c, v in HILLCLIMB_PICKS}
        futs = {pool.submit(run_cell, a, s, mp): (a, s, mp)
                for a, s, mp in jobs}
        for f in cf.as_completed(futs):
            a, s, mp = futs[f]
            try:
                r = f.result()
            except Exception as e:  # noqa: BLE001 — all cells, then fail
                errors.append(f"{a}@{s} [{'multi' if mp else 'single'}]: "
                              f"{e!r}")
                continue
            results[(a, s, mp)] = r
            m, rf = r["memory"], r["roofline"]
            emit({"phase": "cells", "cell": r["cell"], "mesh": r["mesh"],
                  "flops": r["cost"]["flops"],
                  "model_flops": r["model_flops"],
                  "kernel_flops": {k: v["flops"] for k, v in
                                   r["cost"]["kernels"].items()},
                  "bytes_accessed": r["cost"]["bytes_accessed"],
                  "argument_bytes_per_device": m["argument_bytes"],
                  "argument_bytes_total": m["argument_bytes_total"],
                  "one_controller_peak_bytes": m["temp_bytes"],
                  "fits_one_card": r["fits_one_card"],
                  "collective_bytes": r["collectives"]["total_bytes"],
                  "roofline_h100": {k: rf[k] for k in (
                      "compute_s", "memory_s", "collective_s", "dominant",
                      "bound_s")},
                  "t_lower_s": r["t_lower_s"]})
        rcs = {hc[f]: f.result() for f in hc}
    if errors:
        fail("dry run failed: " + "; ".join(errors))
    for c, v in HILLCLIMB_PICKS:
        if rcs[(c, v)] != 0:
            fail(f"hillclimb {c}/{v} exited {rcs[(c, v)]}")
        run = json.loads((out_dir / f"{c}.json").read_text())["runs"][0]
        r = run["result"]
        emit({"phase": "hillclimb", "cell_key": c, "variant": v,
              "cell": r["cell"], "flops": r["cost"]["flops"],
              "one_controller_peak_bytes": r["memory"]["temp_bytes"],
              "roofline_h100": {k: r["roofline"][k] for k in (
                  "compute_s", "memory_s", "collective_s", "dominant")}})
    for name in NO_FIT:
        a, s = name.split("@")
        if results[(a, s, False)]["fits_one_card"]:
            fail(f"{name}: the dry run says it fits one card, which it "
                 "did not")
    emit({"phase": "cells_summary", "cells": len(results),
          "seconds": time.perf_counter() - t0,
          "workers": os.cpu_count()})
    return results


def cells_card(device, dry: dict) -> dict:
    """``"cells_card"``: the cells the dry run puts at <= 70 GB, run for
    real on the card with seeded random weights and inputs. A first run
    measures the peak (``max_memory_allocated`` past the bytes held
    before it) against the dry run's; a second, under the dry run's
    counters, its FLOPs (equal to the meta count); a third its wall.
    Returns the launch counts of the three runs."""
    mesh = make_production_mesh()
    picked = [(a, s) for (a, s, mp), r in dry.items() if not mp and
              r["memory"]["argument_bytes_total"] + r["memory"]["temp_bytes"]
              <= CARD_RUN_LIMIT]
    names = {f"{a}@{s}" for a, s in picked}
    if not set(CARD_MUST) <= names or not any(
            ARCH_FAMILY[a] == "gnn" for a, _ in picked):
        fail(f"the card run lacks a required cell: {sorted(names)}")
    _build.reset_launch_counts()
    for a, s in sorted(picked, key=lambda c: all_cells().index(c)):
        r = dry[(a, s, False)]
        torch.cuda.empty_cache()
        cell = build_cell(a, s, mesh, device=device, seed=0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = cell.fn(*cell.args)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        if not all(bool(torch.isfinite(t).all()) for t in tree_leaves(out)
                   if t.is_floating_point()):
            fail(f"{a}@{s}: a non-finite output on the card")
        out_bytes = tree_bytes_per_device(mesh, cell.out_shardings, out)
        if out_bytes != r["memory"]["output_bytes"]:
            fail(f"{a}@{s}: outputs {out_bytes} B a device, the dry run "
                 f"{r['memory']['output_bytes']}")
        del out
        counted = count_step(cell)
        del counted["out"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = cell.fn(*cell.args)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        del out
        predicted = r["memory"]["temp_bytes"]
        ratio = peak / max(predicted, 1)
        line = {"phase": "cells_card", "cell": f"{a}@{s}", "wall_ms": wall,
                "peak_bytes": peak, "predicted_peak_bytes": predicted,
                "peak_ratio": ratio, "flops_card": counted["flops"],
                "flops_meta": r["cost"]["flops"],
                "kernel_flops_card": {k: v["flops"] for k, v in
                                      counted["kernels"].items()},
                "argument_bytes_total": r["memory"]["argument_bytes_total"],
                "card": card_line()}
        emit(line)
        if counted["flops"] != r["cost"]["flops"]:
            fail(f"{a}@{s}: {counted['flops']} FLOPs on the card, "
                 f"{r['cost']['flops']} on meta")
        if abs(ratio - 1) > PEAK_TOL:
            fail(f"{a}@{s}: peak {peak} B on the card against "
                 f"{predicted} B predicted")
        del cell
    set_activation_mesh(None)
    torch.cuda.empty_cache()
    counts = _build.launch_counts()
    emit({"phase": "cells_card_path", "launches": counts})
    if not counts["cin"]:
        fail(f"cells_card launches no CIN kernel: {counts}")
    return counts


def service_bench_phase() -> dict:
    """``"service_bench"``: ``service.bench.sweep(smoke=True)`` on the card
    through the autotuned CUDA backend, one line per row. Returns its
    launch counts: a pull and a push kernel must have launched."""
    _build.reset_launch_counts()
    for name, us, payload in bench_sweep(smoke=True):
        if payload["backend"] != "cuda" or us <= 0:
            fail(f"service bench row {name}: {payload}")
        emit({"phase": "service_bench", "name": name, "us_per_call": us,
              "derived": payload})
    counts = _build.launch_counts()
    emit({"phase": "service_bench_path", "launches": counts})
    if not counts["ell_spmv"] or not (counts["coo_push"]
                                      or counts["coo_push_mxu"]):
        fail(f"service bench launches: {counts}")
    return counts


def held(after: str) -> None:
    """Free what a phase left (the engines ``api`` cached for its
    backends, whose sharded ones hold views of a graph's ELL arrays, and
    its reference cycles, which only the cycle collector frees) and print
    the bytes the card still holds: what the next phase's peaks start
    from."""
    api.clear_engine_cache()
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "memory", "after": after,
          "allocated_bytes": torch.cuda.memory_allocated(),
          "reserved_bytes": torch.cuda.memory_reserved()})


def legacy_check(graphs: dict) -> None:
    """``"legacy"``: ``bfs``, ``sssp_delta`` and ``personalized_pagerank``
    on rca, on the card (their signatures take no backend: ``api.solve``'s
    default), against ``api.solve`` with the same arguments: equal
    states."""
    g, delta = graphs["rca"]
    root = top_sources(g, 1)[0]
    got = legacy_algs.bfs(g, root)
    want = api.solve(g, "bfs", policy=Fixed(Direction.PUSH), root=root)
    same = (torch.equal(got.dist, want.state["dist"])
            and torch.equal(got.parent, want.state["parent"])
            and got.levels == want.steps)
    got_s = legacy_algs.sssp_delta(g, root, delta=delta)
    want_s = api.solve(g, "sssp_delta", policy=Fixed(Direction.PUSH),
                       source=root, delta=delta, max_inner=64,
                       max_steps=1 << 14)
    same &= torch.equal(got_s.dist, want_s.state["dist"])
    got_p = legacy_algs.personalized_pagerank(g, root, iters=20)
    want_p = api.solve(g, "ppr", policy="pull", source=root, iters=20)
    same &= torch.equal(got_p.ranks, want_p.state["ranks"])
    emit({"phase": "legacy", "graph": "rca", "bfs_levels": int(got.levels),
          "sssp_epochs": int(got_s.epochs), "ppr_iterations":
          int(got_p.iterations), "equal": bool(same)})
    if not same:
        fail("a legacy wrapper differs from api.solve")


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
    results, walls, counts, dispatch = main_path(graphs)
    main = {"launches": dict(counts), "dispatch": dispatch}
    dense = check_answers(graphs, results)
    legacy_check(graphs)
    serving = serving_path(graphs, ways)
    counts = {k: counts[k] + serving[k] for k in counts}
    push_choice_phase(graphs, ways)
    more, by_alg = solve_more_path(graphs)
    counts = {k: counts[k] + sum(v[k] for v in by_alg.values())
              for k in counts}
    check_more(graphs, more, results)
    observed = observe_path(graphs, more)
    counts = {k: counts[k] + observed[k] for k in counts}
    sharded, shard_rows = shard_path(
        graphs, {"cuda": results, "dense": dense, "wall_ms": walls})
    counts = {k: counts[k] + sharded[k] for k in counts}
    errs["ell_spmv"] = max(errs["ell_spmv"],
                           *(r["max_abs_err"] for r in shard_rows))
    del dense

    rows = []
    for gname, (g, _) in graphs.items():
        rows += shaped_kernels(gname, g, device, ways)
        more_kernel_rows(gname, g, ways["auto"], more, by_alg)
    row_layout_rows("kron16", graphs["kron16"][0], BATCH["kron16"], device,
                    main)
    # the loop's g would hold kron16 (its ELL view is 5.2 GB) to the end
    del graphs, ways, more, g
    held("graph phases")
    ppr_step_row(device)
    held("ppr_step")
    row_layout_rows("kron21", card_kron(21, 16, 0, device), 256, device,
                    main)
    held("row_layout")

    errs.update(model_kernel_grid(device))
    lms, rec, model_counts = model_path(device)
    counts = {k: counts[k] + model_counts[k] for k in counts}
    model_rows = model_kernel_rows(lms, rec)
    del lms, rec
    held("model")
    train_counts, grad_rows, cin_grad_rows = train_path(device)
    counts = {k: counts[k] + train_counts[k] for k in counts}
    held("train")
    gnn_counts = gnn_path(device)
    counts = {k: counts[k] + gnn_counts[k] for k in counts}
    held("gnn")
    moe = moe_path(device)
    counts = {k: counts[k] + moe["counts"][k] for k in counts}
    model_rows += moe["rows"]
    held("moe")
    with tempfile.TemporaryDirectory() as tmp:
        dry = dry_run_all(Path(tmp))
    cell_counts = cells_card(device, dry)
    counts = {k: counts[k] + cell_counts[k] for k in counts}
    held("cells_card")
    counts = {k: counts[k] + v for k, v in service_bench_phase().items()}
    kernels = []
    for row in rows:
        # one row per kernel: the road graph, at width 1 where the kernel
        # runs there (slice 1), else at the serving path's width
        slice1 = row["name"] in ("coo_push", "ell_spmv")
        if row["graph"] != "rca" or \
                slice1 != (row.get("width", 1) == 1) and \
                row["name"] in ("coo_push", "ell_spmv", "coo_push_mxu"):
            continue
        name = row["name"]
        worst = max(errs[name], *(r["max_abs_err"] for r in rows
                                  if r["name"] == name))
        kernels.append({k: v for k, v in row.items()
                        if k not in ("width", "onehot_floor_ms")}
                       | {"launches": counts[name], "max_abs_err": worst})
    for row in model_rows:
        # one row per kernel: llama3.2-1b's prefill layer and the CIN
        # layer of Hp = 200 at serve_p99 (the MoE path's flash rows add
        # their errors only)
        if row.get("arch", "llama3.2-1b") != "llama3.2-1b" or (
                row["name"] == "cin" and row["layer"] != 1):
            continue
        name = row["name"]
        worst = max(errs[name], *(r["max_abs_err"] for r in model_rows
                                  if r["name"] == name))
        kernels.append({k: v for k, v in row.items()
                        if k not in ("arch", "layer", "path")}
                       | {"launches": counts[name], "max_abs_err": worst})
    # the backward's row: the llama3.2-1b layer in bf16
    row = grad_rows[0]
    kernels.append({k: row[k] for k in (
        "name", "route", "source", "replaces", "shape", "ms", "plain_ms",
        "bound_ms", "bound_by", "library_ms")}
        | {"launches": counts["flash_attention_bwd"],
           "max_abs_err": max(errs["flash_attention_bwd"],
                              *(r["max_abs_err"] for r in grad_rows))})
    # CIN's backward kernels: train_batch's Hp = 200 layer
    for row in cin_grad_rows:
        kernels.append(row | {"launches": counts[row["name"]],
                              "max_abs_err": max(errs[row["name"]],
                                                 row["max_abs_err"])})
    print(card_line(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
