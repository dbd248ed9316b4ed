"""Perf hillclimb: run named variants of the three chosen cells
through the dry run (``launch.dryrun.run_cell``, on ``meta``) and record
the roofline terms of each. PyTorch port of ``repro.launch.hillclimb``,
with the reference's variants unchanged; their descriptions speak of the
TPU they were written for (the MXU, 256 devices), while the terms here
price the port's whole program on one H100.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell qwen \
        --variant v1_pad_heads
    PYTHONPATH=src python -m repro_torch.launch.hillclimb --all \
        --out hillclimb_results.json

Results accumulate in ``--out`` (default ``hillclimb_results.json`` in
the working directory); a variant already recorded there is skipped.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from ..configs.archs import full_config
from .dryrun import run_cell

__all__ = ["VARIANTS", "load", "main", "OUT"]

OUT = "hillclimb_results.json"


def _moe_override(**kw):
    moe = full_config("deepseek-moe-16b").moe
    return dataclasses.replace(moe, **kw)


# variant registry: cell -> variant -> (description, kwargs for run_cell)
VARIANTS = {
    "qwen": {
        "_cell": ("qwen1.5-32b", "train_4k"),
        "v1_pad_heads": (
            "pad 40->48 heads (+20% attn FLOPs) so heads shard 16-way "
            "instead of replicating attention on every TP rank",
            dict(overrides={"n_heads": 48, "n_kv_heads": 48,
                            "head_dim": 128})),
        "v2_loss_chunk": (
            "v1 + loss_chunk 512->4096: one unembed pass per sequence "
            "(8x fewer streamed reads of the [5120,152064] matrix)",
            dict(overrides={"n_heads": 48, "n_kv_heads": 48,
                            "head_dim": 128, "loss_chunk": 4096})),
        "v3_attn_chunks": (
            "v2 + blockwise attention chunks 512/1024 -> 2048/2048 "
            "(4x fewer q-block iterations; less carry re-materialization)",
            dict(overrides={"n_heads": 48, "n_kv_heads": 48,
                            "head_dim": 128, "loss_chunk": 4096,
                            "q_chunk": 2048, "kv_chunk": 2048})),
        "v4_bf16_mxu": (
            "v1 + bf16 q/k/v streamed straight to the MXU "
            "(preferred_element_type=f32) instead of materializing f32 "
            "copies of every attention operand",
            dict(overrides={"n_heads": 48, "n_kv_heads": 48,
                            "head_dim": 128})),
    },
    "gin": {
        "_cell": ("gin-tu", "ogb_products"),
        "v1_shard_all": (
            "shard nodes/edges over all 256 devices (model axis was 16x "
            "replicated work+memory)",
            dict(overrides={"shard_axes": "all"})),
        "v2_bf16": (
            "v1 + bf16 feature payloads (halve the pull-exchange "
            "all-gather bytes)",
            dict(overrides={"shard_axes": "all", "dtype": "bfloat16"})),
        "v3_pa_exchange": (
            "v2 + the paper's PA pull-exchange via shard_map: edges "
            "pre-grouped by destination owner -> one all_gather/layer, "
            "no scatter all-reduce (GSPMD's generic lowering pays both)",
            dict(overrides={"mp_exchange": True, "dtype": "bfloat16"})),
    },
    "deepseek": {
        "_cell": ("deepseek-moe-16b", "train_4k"),
        "v1_bf16_combine": (
            "EP combine psum in bf16 (<= top_k contributions per token: "
            "halves the dominant expert-combine collective)",
            dict(overrides={"moe": _moe_override(combine_dtype="bf16")})),
        "v2_loss_attn": (
            "v1 + loss_chunk 4096 + attention chunks 1024/2048",
            dict(overrides={"moe": _moe_override(combine_dtype="bf16"),
                            "loss_chunk": 4096, "q_chunk": 1024,
                            "kv_chunk": 2048})),
        "v3_a2a": (
            "a2a EP: ranks split the token sequence and route via "
            "all_to_all (paper's MP combined-alltoall push) — 16x less "
            "redundant dispatch gather/scatter traffic than psum-EP",
            dict(overrides={"moe": _moe_override(ep_mode="a2a")})),
        "v4_a2a_shared": (
            "v3 + shared experts computed on the sequence slice (they "
            "were 16x redundant across model ranks; now folded into the "
            "a2a block before its all_gather)",
            dict(overrides={"moe": _moe_override(ep_mode="a2a")})),
        "v5_bf16_mxu": (
            "v4 + bf16 attention operands straight to the MXU (no f32 "
            "copies of q/k/v)",
            dict(overrides={"moe": _moe_override(ep_mode="a2a"),
                            "q_chunk": 512})),
    },
}


def load(path: str = OUT) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        return {"runs": []}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", choices=list(VARIANTS), default=None)
    ap.add_argument("--variant", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args(argv)

    todo = []
    for cell, table in VARIANTS.items():
        if args.cell and cell != args.cell:
            continue
        for vname, (desc, kw) in table.items():
            if vname == "_cell":
                continue
            if args.variant and vname != args.variant:
                continue
            todo.append((cell, vname, desc, kw, table["_cell"]))

    data = load(args.out)
    done = {(r["cell_key"], r["variant"]) for r in data["runs"]}
    failed = 0
    for cell, vname, desc, kw, (arch, shape) in todo:
        if (cell, vname) in done:
            print(f"skip {cell}/{vname} (already recorded)")
            continue
        print(f"=== {cell}/{vname}: {desc}", flush=True)
        try:
            r = run_cell(arch, shape, multi_pod=False, **kw)
        except Exception as e:  # noqa: BLE001
            print(f"FAIL {cell}/{vname}: {e!r}")
            failed += 1
            continue
        rec = {"cell_key": cell, "variant": vname, "description": desc,
               "result": r}
        data["runs"].append(rec)
        with open(args.out, "w") as f:
            json.dump(data, f, indent=1)
        rf = r["roofline"]
        print(f"    compute={rf['compute_s']:.3e} memory={rf['memory_s']:.3e} "
              f"collective={rf['collective_s']:.3e} dom={rf['dominant']}",
              flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
