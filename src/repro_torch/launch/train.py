"""Training launcher (port of ``repro.launch.train``): --arch selects an
assigned architecture and runs real steps on synthetic data with
checkpointing and the straggler watchdog, on the card unless
``--device cpu``.

``--smoke`` (the default) trains the reduced same-family config;
``--full`` trains the full config at its published widths.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --full --steps 5 --batch 8 --seq 4096 --num-micro 4
    PYTHONPATH=src python -m repro_torch.launch.train --arch gin-tu \\
        --steps 20 --device cpu

A GNN arch trains full-graph on ``erdos_renyi(256, 4.0)`` with seeded
numpy features and an MSE loss, as the reference's launcher does; its
batch is the whole graph, so it takes no ``--num-micro`` above 1.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..configs.archs import ARCH_FAMILY, full_config, smoke_config
from ..data import prefetch, recsys_batches, token_batches
from ..dist.compression import CompressionConfig
from ..graphs.generators import erdos_renyi
from ..graphs.structure import resolve_device
from ..models import gnn as gnn_mod
from ..models.recsys import xdeepfm_apply, xdeepfm_init
from ..models.transformer import decay_mask, init_params, lm_loss
from ..train import LoopConfig, OptConfig, TrainLoop
from ..train.losses import bce_with_logits, mse

__all__ = ["main"]


def _lm_setup(arch, smoke, batch, seq, device):
    cfg = smoke_config(arch) if smoke else full_config(arch)
    params = init_params(cfg, seed=0, device=device)
    data = prefetch(token_batches(batch, seq, cfg.vocab), 2)
    loss_fn = lambda p, b: lm_loss(p, cfg, b["tokens"], b["labels"])  # noqa
    return params, loss_fn, data, decay_mask(params)


def _gnn_setup(arch, smoke, batch, seq, device):
    cfg = smoke_config(arch) if smoke else full_config(arch)
    g = erdos_renyi(256, 4.0, seed=0, weighted=True, device=device)
    rng = np.random.default_rng(0)
    init_fn = {"egnn": gnn_mod.egnn_init, "gin-tu": gnn_mod.gin_init,
               "graphsage-reddit": gnn_mod.sage_init,
               "graphcast": gnn_mod.graphcast_init}[arch]
    params = init_fn(cfg, seed=0, device=device)

    def normal(cols):
        return torch.from_numpy(rng.normal(size=(g.n, cols)).astype(
            np.float32)).to(device)

    if arch == "graphcast":
        nv = normal(cfg.n_vars)

        def loss_fn(p, b):
            return mse(gnn_mod.graphcast_apply(p, cfg, g, b["x"]), b["x"])

        def batches():
            while True:
                yield {"x": nv}
    else:
        feats, coords, target = normal(cfg.d_in), normal(3), normal(
            cfg.d_out)

        def loss_fn(p, b):
            if arch == "egnn":
                out, _ = gnn_mod.egnn_apply(p, cfg, g, b["h"], coords)
            elif arch == "gin-tu":
                out = gnn_mod.gin_apply(p, cfg, g, b["h"])
            else:
                out = gnn_mod.sage_apply(p, cfg, g, b["h"])
            return mse(out, target)

        def batches():
            while True:
                yield {"h": feats}
    return params, loss_fn, batches(), None


def _recsys_setup(arch, smoke, batch, seq, device):
    cfg = smoke_config(arch) if smoke else full_config(arch)
    params = xdeepfm_init(cfg, seed=0, device=device)
    data = prefetch(recsys_batches(batch, cfg.n_fields,
                                   cfg.vocab_per_field), 2)
    loss_fn = lambda p, b: bce_with_logits(  # noqa: E731
        xdeepfm_apply(p, cfg, b["ids"]), b["labels"])
    return params, loss_fn, data, None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(ARCH_FAMILY))
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--compression", choices=["none", "topk", "int8"],
                    default="none")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--num-micro", type=int, default=1)
    args = ap.parse_args(argv)
    if ARCH_FAMILY[args.arch] == "gnn" and args.num_micro > 1:
        raise ValueError(f"{args.arch} trains on the whole graph, which "
                         "does not split into microbatches: --num-micro "
                         f"{args.num_micro}")

    setup = {"lm": _lm_setup, "gnn": _gnn_setup,
             "recsys": _recsys_setup}[ARCH_FAMILY[args.arch]]
    params, loss_fn, data, decay = setup(args.arch, args.smoke, args.batch,
                                         args.seq,
                                         resolve_device(args.device))
    loop = TrainLoop(
        loss_fn, params,
        OptConfig(lr=args.lr, total_steps=args.steps, warmup_steps=2),
        LoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                   ckpt_every=max(5, args.steps // 2), log_every=5,
                   num_micro=args.num_micro,
                   compression=CompressionConfig(kind=args.compression)),
        decay=decay)
    res = loop.run(data)
    print(f"{args.arch}: step={res['final_step']} "
          f"loss={res['final_loss']:.4f} "
          f"median_step={res['median_dt']*1e3:.1f}ms "
          f"stragglers={len(res['stragglers'])}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
