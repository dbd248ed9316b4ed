"""Dry run: build every assigned (arch × shape) cell on the production
meshes, run its step once on the ``meta`` device, and report memory,
cost and collectives with the three roofline terms on one H100. PyTorch
port of ``repro.launch.dryrun``.

The reference lowers and compiles each cell for a 512-chip TPU mesh and
reads the compiled program's ``memory_analysis()``, ``cost_analysis()``
and HLO collectives. A PyTorch program has no compiled artifact, so the
port runs the step itself on ``meta`` tensors, which allocate nothing
and launch nothing, under three counters (:func:`count_step`):

  * ``FlopCounterMode`` for the PyTorch operators, plus the model
    kernels' own work (``kernels._build.kernel_work``: a launch is not an
    operator, so a kernel wrapper adds its work where it would launch);
  * :class:`StepCounter`, a dispatch mode that sums each operator's
    input and output bytes (views aside: the counterpart of XLA's
    ``bytes accessed``) and follows every storage the step allocates
    until it is freed, rounded as the card's caching allocator rounds
    (512 bytes): its peak is the bytes the program holds beyond its
    arguments, the whole program on one controller (``temp_bytes``);
  * ``dist.collectives``' wire counter: what the port's explicit
    exchanges carry between shards (``gin_apply_mp``'s all_gathers,
    ``moe_apply_ep``'s combine and all_to_alls). Collectives the
    reference's partitioner inserts (``zero="pull"``'s all-gathers, the
    gradients' reduce-scatters) have no counterpart: a cell with no
    explicit exchange reports 0 bytes.

Per-device argument, output and alias bytes come from the cell's specs
(``dist.sharding``) on the mesh. The layer loop runs in Python, so every
layer is counted and ``loop_factor`` is 1. ``fits_one_card`` says
whether the whole program's arguments and its peak fit the card's
80 GB. No XLA flag is involved, and the module imports nothing of JAX.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun          # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-9b \\
        --shape train_4k --mesh single --out results.json
    PYTHONPATH=src python -m repro_torch.launch.dryrun --list
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
import weakref
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from ..configs.registry import all_cells, build_cell
from ..dist.collectives import reset_wire, wire_bytes
from ..dist.sharding import tree_bytes_per_device
from ..kernels._build import kernel_work, reset_kernel_work
from ..kernels.roofline import HBM_CAPACITY_BYTES
from ..models.common import param_count, tree_leaves
from ..roofline.analysis import model_flops, roofline_report
from .mesh import make_production_mesh

__all__ = ["StepCounter", "count_step", "run_cell", "cell_model_flops",
           "main", "ALLOC_ROUND", "COUNTED_COLLECTIVES"]

# the caching allocator's block granularity
ALLOC_ROUND = 512
COUNTED_COLLECTIVES = (
    "dist.collectives all_gather and reduce_scatter (gin_apply_mp), "
    "models.moe expert-parallel combine and all_to_all; partitioner "
    "collectives (zero='pull' all-gathers, gradient reduce-scatters) have "
    "no counterpart")


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepCounter(TorchDispatchMode):
    """Over one run of a step: every operator's input and output bytes
    (views aside), the operators by name, and the storages allocated
    beyond ``baseline`` (tensors whose storages are not counted), live
    and at their peak, each rounded up to :data:`ALLOC_ROUND` bytes."""

    def __init__(self, baseline=()):
        super().__init__()
        self.bytes_accessed = 0
        self.ops = Counter()
        self.current = 0
        self.peak = 0
        self._base = {t.untyped_storage()._cdata for t in baseline}
        self._live: dict = {}

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live or key in self._base:
            return
        n = -(-st.nbytes() // ALLOC_ROUND) * ALLOC_ROUND
        self._live[key] = n
        self.current += n
        self.peak = max(self.peak, self.current)
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.current -= self._live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops[str(func.overloadpacket.__name__)] += 1
        outs = _tensors(out)
        if not getattr(func, "is_view", False):
            self.bytes_accessed += sum(
                _nbytes(t) for t in _tensors((args, kwargs)) + outs)
        for t in outs:
            self._track(t)
        return out


def count_step(cell) -> dict:
    """Run ``cell.fn`` once on its arguments under the three counters;
    the same on the card (real tensors) as on ``meta``."""
    reset_kernel_work()
    reset_wire()
    counter = StepCounter(tree_leaves(cell.args))
    with FlopCounterMode(display=False) as fc, counter:
        out = cell.fn(*cell.args)
    work = {k: v for k, v in kernel_work().items() if v["flops"]}
    flops_aten = int(fc.get_total_flops())
    flops_k = sum(v["flops"] for v in work.values())
    return {"out": out, "flops": flops_aten + flops_k,
            "flops_aten": flops_aten, "kernels": work,
            "bytes_accessed": counter.bytes_accessed
            + sum(v["bytes"] for v in work.values()),
            "peak_bytes": counter.peak, "ops": counter.ops,
            "collectives": wire_bytes()}


def cell_model_flops(cell) -> float | None:
    """``model_flops`` of an LM cell: its parameters a token uses (not the
    input embedding, a gather; of a MoE layer's routed experts the top k)
    times its tokens. None for the other families."""
    cfg = cell.meta["cfg"]
    if type(cfg).__name__ != "TransformerConfig":
        return None
    params = cell.args[0]
    n = param_count(params) - params["embed"].numel()
    if cfg.moe is not None:
        routed = sum(param_count(lp["moe"]["experts"])
                     for lp in params["layers"])
        n -= routed * (1 - cfg.moe.top_k / cfg.moe.n_experts)
    tokens = cell.args[1].numel() if cell.meta["kind"] != "train" else \
        cell.args[2]["tokens"].numel()
    return model_flops(cell.meta["kind"], n_active_params=n, tokens=tokens)


def run_cell(arch: str, shape: str, multi_pod: bool = False,
             direction: str = "pull", zero: str = "pull",
             overrides=None, want_text: bool = False) -> dict:
    mesh = make_production_mesh(multi_pod=multi_pod)
    t0 = time.perf_counter()
    cell = build_cell(arch, shape, mesh, direction=direction, zero=zero,
                      overrides=overrides, device="meta")
    c = count_step(cell)
    t_lower = time.perf_counter() - t0

    arg_total = sum(_nbytes(t) for t in tree_leaves(cell.args))
    memory = {
        "argument_bytes": tree_bytes_per_device(mesh, cell.in_shardings,
                                                cell.args),
        "output_bytes": tree_bytes_per_device(mesh, cell.out_shardings,
                                              c["out"]),
        "temp_bytes": c["peak_bytes"],
        "temp_basis": "one-controller peak beyond the arguments, whole "
                      "program",
        "generated_code_bytes": None,
        "alias_bytes": sum(tree_bytes_per_device(
            mesh, cell.in_shardings[i], cell.args[i]) for i in cell.donate),
        "argument_bytes_total": arg_total,
    }
    result = {
        "cell": f"{arch}@{shape}",
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_devices": int(mesh.size),
        "direction": direction,
        "zero": zero,
        "t_lower_s": round(t_lower, 2),
        "t_compile_s": None,
        "memory": memory,
        "cost": {"flops": float(c["flops"]),
                 "bytes_accessed": float(c["bytes_accessed"]),
                 "flops_aten": float(c["flops_aten"]),
                 "kernels": c["kernels"]},
        "collectives": {**c["collectives"], "counted": COUNTED_COLLECTIVES},
        "model_flops": cell_model_flops(cell),
        "fits_one_card": arg_total + c["peak_bytes"] <= HBM_CAPACITY_BYTES,
    }
    result["roofline"] = roofline_report(result, loop_factor=1)
    if want_text:
        result["ops_text"] = "\n".join(
            f"{n:8d} {op}" for op, n in c["ops"].most_common())[:4000]
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--direction", default="pull")
    ap.add_argument("--zero", default="pull")
    ap.add_argument("--out", default=None)
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)

    cells = all_cells()
    if args.list:
        for a, s in cells:
            print(f"{a}@{s}")
        return 0
    if args.arch:
        cells = [(a, s) for a, s in cells if a == args.arch]
    if args.shape:
        cells = [(a, s) for a, s in cells if s == args.shape]
    if not cells:
        print("no matching cells", file=sys.stderr)
        return 2

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    results, failures = [], []
    for arch, shape in cells:
        for mp in meshes:
            tag = f"{arch}@{shape} [{'multi' if mp else 'single'}]"
            try:
                r = run_cell(arch, shape, mp, direction=args.direction,
                             zero=args.zero)
                results.append(r)
                mb = (r["memory"]["argument_bytes"] or 0) / (1 << 20)
                coll = r["collectives"]["total_bytes"] / (1 << 20)
                print(f"OK   {tag:55s} lower={r['t_lower_s']:6.1f}s "
                      f"compile=   n/a "
                      f"args/dev={mb:9.1f}MiB "
                      f"coll={coll:9.1f}MiB "
                      f"fits={r['fits_one_card']}",
                      flush=True)
            except Exception as e:  # noqa: BLE001 — report, keep going
                failures.append({"cell": tag, "error": repr(e),
                                 "trace": traceback.format_exc()[-2000:]})
                print(f"FAIL {tag}: {e!r}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"results": results, "failures": failures}, f,
                      indent=1)
    print(f"\n{len(results)} ok, {len(failures)} failed")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
