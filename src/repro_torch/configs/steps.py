"""Cells: (arch × shape × mesh) → step functions and their
arguments. PyTorch port of ``repro.configs.steps``.

Each ``build_*_cell`` returns a :class:`BuiltCell`:

    fn            the step function (the port's own: it runs with real
                  tensors on the card and with meta tensors in the dry run)
    args          the arguments, in the reference's tree structure after
                  the port's own parameter layout (the one each model's
                  ``params_from_arrays`` reads: transformer layers as a
                  list of per-layer trees)
    in_shardings  matching specs (``dist.sharding``)
    out_shardings for state-carrying outputs (params/opt/cache: same as in)
    donate        argnums whose buffers the outputs reuse

On ``device="meta"`` (the default) the arguments are shapes and dtypes
only; on another device they are seeded random values: weights from the
models' initializers, token and id inputs uniform within their ranges,
graph edges uniform over the padded node count, features normal.

Conventions: batch dims shard over the flattened ('pod', 'data') axes;
parameters follow ``dist.sharding``'s rules; graph cells pad node/edge
counts to the batch-axis multiple (padded tail is masked; true sizes stay
in meta). A training step writes its parameters and optimizer state in
place (``train.optimizer.apply_updates``), which is what donation means
here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch

from ..dist.overlap import value_and_grad
from ..dist.sharding import (REPLICATED, batch_axes, make_sharding,
                             recsys_param_specs, transformer_param_specs)
from ..graphs.structure import EdgeView, resolve_device
from ..models import gnn as gnn_mod
from ..models.common import generator, randn, tree_leaves, tree_map
from ..models.recsys import retrieval_score, xdeepfm_apply, xdeepfm_init
from ..models.transformer import (decay_mask, decode_step, init_kv_cache,
                                  init_params, lm_loss, prefill)
from ..shard.mesh import ShardMesh
from ..sparse.segment import segment_sum
from ..train.losses import bce_with_logits, mse, softmax_xent_dense
from ..train.optimizer import OptConfig, OptState, apply_updates, init_opt
from .archs import full_config
from .shapes import ShapeSpec

__all__ = ["BuiltCell", "build_lm_cell", "build_gnn_cell",
           "build_gnn_mp_cell", "build_recsys_cell", "OPT_CFG"]

OPT_CFG = OptConfig(lr=3e-4, total_steps=10_000)

F32 = torch.float32
I32 = torch.int32


@dataclasses.dataclass
class BuiltCell:
    name: str
    fn: Callable
    args: tuple
    in_shardings: tuple
    out_shardings: Any
    donate: tuple = ()
    meta: dict = dataclasses.field(default_factory=dict)


class _Inputs:
    """Seeded inputs on one device; on ``meta`` shapes and dtypes only."""

    def __init__(self, device, seed: int):
        self.device = resolve_device(device)
        self.gen = generator(seed, self.device)
        self.meta = self.device.type == "meta"

    def normal(self, shape) -> torch.Tensor:
        return randn(self.gen, shape)

    def ints(self, shape, high: int) -> torch.Tensor:
        if self.meta:
            return torch.empty(shape, dtype=I32, device=self.device)
        return torch.randint(0, high, shape, generator=self.gen,
                             device=self.device, dtype=I32)

    def uniform(self, shape) -> torch.Tensor:
        if self.meta:
            return torch.empty(shape, device=self.device)
        return torch.rand(shape, generator=self.gen, device=self.device)


def _trainable(params: Any) -> Any:
    """The float leaves of ``params`` marked as requiring grad (in
    place), so that a step differentiates the tensors themselves."""
    for t in tree_leaves(params):
        if t.is_floating_point():
            t.requires_grad_()
    return params


def _replicated(tree: Any) -> Any:
    return tree_map(lambda _: REPLICATED, tree)


def _opt_specs(spec_fn: Callable, opt: OptState) -> OptState:
    return OptState(step=REPLICATED, mu=spec_fn(opt.mu), nu=spec_fn(opt.nu))


def _batch_sharding(mesh, shape, extra=()):
    return make_sharding(mesh, (batch_axes(mesh), *extra), shape)


def _pad_to(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def _train_step(loss_fn: Callable, decay: Any = None) -> Callable:
    """One AdamW step of ``loss_fn(params, batch)``, in place."""

    def step(params, opt_state, batch):
        loss, grads = value_and_grad(loss_fn, params, batch)
        params, opt_state = apply_updates(params, grads, opt_state,
                                          OPT_CFG, decay=decay)
        return params, opt_state, loss

    return step


# ------------------------------------------------------------------ LM --
def _lm_state(mesh, cfg, zero: str, inp: _Inputs, seed: int):
    params = _trainable(init_params(cfg, seed=seed, device=inp.device))
    opt = init_opt(params, OPT_CFG)
    spec = lambda t: transformer_param_specs(mesh, t, zero=zero)  # noqa
    return params, opt, spec(params), _opt_specs(spec, opt)


def _cache_shardings(mesh, cache: dict, seq_shard: bool) -> dict:
    """KV cache sharding: batch over batch axes when divisible, sequence
    over 'model' (flash-decoding split) — or over everything for B=1."""
    ba = batch_axes(mesh)
    # leaf: [L, B, S, Hk, Dh] or scale [L, B, S, Hk, 1]
    spec = ((None, None, (*ba, "model"), None, None) if seq_shard
            else (None, ba, "model", None, None))
    return tree_map(lambda leaf: make_sharding(mesh, spec, leaf.shape),
                    cache)


def build_lm_cell(arch: str, shape: ShapeSpec, mesh, zero: str = "pull",
                  overrides: Optional[dict] = None, device="meta",
                  seed: int = 0) -> BuiltCell:
    cfg = full_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    T = shape.params["seq_len"]
    B = shape.params["global_batch"]
    ba = batch_axes(mesh)
    inp = _Inputs(device, seed + 1)
    name = f"{arch}@{shape.name}"
    logits_sh = make_sharding(mesh, (ba, "model"), (B, cfg.vocab))

    if shape.kind == "train":
        params, opt, p_sh, o_sh = _lm_state(mesh, cfg, zero, inp, seed)
        batch = {"tokens": inp.ints((B, T), cfg.vocab),
                 "labels": inp.ints((B, T), cfg.vocab)}
        batch_sh = {k: _batch_sharding(mesh, (B, T), (None,))
                    for k in batch}
        step = _train_step(
            lambda p, b: lm_loss(p, cfg, b["tokens"], b["labels"]),
            decay=decay_mask(params))
        return BuiltCell(
            name=name, fn=step, args=(params, opt, batch),
            in_shardings=(p_sh, o_sh, batch_sh),
            out_shardings=(p_sh, o_sh, REPLICATED),
            donate=(0, 1), meta={"cfg": cfg, "kind": "train"})

    params = init_params(cfg, seed=seed, device=inp.device)
    p_sh = transformer_param_specs(mesh, params, zero="push")
    if shape.kind == "prefill":
        cache_kind = "int8" if arch == "qwen1.5-32b" else "bf16"

        @torch.no_grad()
        def step(params, tokens):
            return prefill(params, cfg, tokens, cache_kind=cache_kind)

        out_cache = init_kv_cache(cfg, B, T, kind=cache_kind, device="meta")
        return BuiltCell(
            name=name, fn=step, args=(params, inp.ints((B, T), cfg.vocab)),
            in_shardings=(p_sh, _batch_sharding(mesh, (B, T), (None,))),
            out_shardings=(logits_sh, _cache_shardings(mesh, out_cache,
                                                       seq_shard=False)),
            meta={"cfg": cfg, "kind": "prefill", "cache_kind": cache_kind})

    # decode (decode_32k / long_500k)
    kind = "int8" if arch == "qwen1.5-32b" or T >= 262144 else "bf16"
    cache = init_kv_cache(cfg, B, T, kind=kind, device=inp.device)
    # long_500k: flash-decoding over the sequence
    cache_sh = _cache_shardings(mesh, cache, seq_shard=B == 1)

    @torch.no_grad()
    def step(params, tokens, cache, cur_len):
        return decode_step(params, cfg, tokens, cache, cur_len)

    return BuiltCell(
        name=name, fn=step,
        args=(params, inp.ints((B, 1), cfg.vocab), cache,
              torch.full((), T - 1, dtype=I32, device=inp.device)),
        in_shardings=(p_sh, _batch_sharding(mesh, (B, 1), (None,)),
                      cache_sh, REPLICATED),
        out_shardings=(logits_sh, cache_sh),
        donate=(2,), meta={"cfg": cfg, "kind": "decode", "cache_kind": kind})


# ----------------------------------------------------------------- GNN --
def _gnn_batch_spec(arch: str, shape: ShapeSpec, mesh,
                    shard_axes: str = "batch"):
    """Padded node/edge buffers + per-arch extras, as meta tensors.
    Returns (spec, sh, meta). shard_axes='all' spreads nodes/edges over
    every mesh axis (removes the 16x model-replica waste — hillclimb
    lever)."""
    ba = (tuple(mesh.axis_names) if shard_axes == "all"
          else batch_axes(mesh))
    mult = max(1, math.prod(mesh.shape[a] for a in ba)) * 8
    p = shape.params

    def sds(shape_, dtype=F32):
        return torch.empty(shape_, dtype=dtype, device="meta")

    if shape.name == "minibatch_lg":
        seeds = p["batch_nodes"]
        f1, f2 = p["fanout"]
        n1, n2 = seeds * f1, seeds * f1 * f2
        N = seeds + n1 + n2
        E = n1 + n2
        Np, Ep = _pad_to(N, mult), _pad_to(E, mult)
        d = p["d_feat"]
        spec = {"feats": sds((Np, d)),
                "src": sds((Ep,), I32), "dst": sds((Ep,), I32),
                "w": sds((Ep,)),
                "labels": sds((seeds,), I32)}
        meta = dict(n=Np, m=Ep, n_true=N, labeled=seeds,
                    n_classes=p["n_classes"], d_feat=d, task="node_class")
    elif shape.name == "molecule":
        Bg = p["batch"]
        N, E = p["n_nodes"] * Bg, p["n_edges"] * Bg
        Np, Ep = _pad_to(N, mult), _pad_to(E, mult)
        d = 16     # synthetic atom features
        spec = {"feats": sds((Np, d)),
                "src": sds((Ep,), I32), "dst": sds((Ep,), I32),
                "w": sds((Ep,)),
                "graph_ids": sds((Np,), I32),
                "labels": sds((Bg,))}
        meta = dict(n=Np, m=Ep, n_true=N, n_graphs=Bg, d_feat=d,
                    task="graph_reg")
    else:
        N, E, d = p["n_nodes"], p["n_edges"], p["d_feat"]
        Np, Ep = _pad_to(N, mult), _pad_to(E, mult)
        spec = {"feats": sds((Np, d)),
                "src": sds((Ep,), I32), "dst": sds((Ep,), I32),
                "w": sds((Ep,)),
                "labels": sds((Np,), I32)}
        meta = dict(n=Np, m=Ep, n_true=N, labeled=N,
                    n_classes=p["n_classes"], d_feat=d, task="node_class")

    if arch == "egnn":
        spec["coords"] = sds((meta["n"], 3))
    if arch == "graphcast":
        # graphcast defines its own variable set (227 vars in/out)
        spec["feats"] = sds((meta["n"], 227))
        spec["target"] = sds((meta["n"], 227))
        meta["task"] = "var_reg"

    sh = {k: make_sharding(mesh, (ba, *(None,) * (v.ndim - 1)), v.shape)
          for k, v in spec.items()}
    return spec, sh, meta


def _gnn_inputs(spec: dict, meta: dict, inp: _Inputs) -> dict:
    """The batch of ``spec`` on the inputs' device: edges uniform over the
    padded nodes, weights uniform in [0, 1), labels within their classes,
    each node's graph id by contiguous blocks, features normal."""
    if inp.meta:
        return dict(spec)
    out = {}
    for k, v in spec.items():
        if k in ("src", "dst"):
            out[k] = inp.ints(v.shape, meta["n"])
        elif k == "w":
            out[k] = inp.uniform(v.shape)
        elif k == "graph_ids":
            out[k] = (torch.arange(meta["n"], device=inp.device)
                      * meta["n_graphs"] // meta["n"]).to(I32)
        elif k == "labels" and v.dtype == I32:
            out[k] = inp.ints(v.shape, meta["n_classes"])
        else:
            out[k] = inp.normal(v.shape)
    return out


_GNN_INIT = {"egnn": gnn_mod.egnn_init, "gin-tu": gnn_mod.gin_init,
             "graphsage-reddit": gnn_mod.sage_init,
             "graphcast": gnn_mod.graphcast_init}


def _gnn_state(init_fn: Callable, gcfg, inp: _Inputs, seed: int):
    params = _trainable(init_fn(gcfg, seed=seed, device=inp.device))
    opt = init_opt(params, OPT_CFG)
    return params, opt, _replicated(params), _opt_specs(_replicated, opt)


def build_gnn_mp_cell(arch: str, shape: ShapeSpec, mesh, overrides: dict,
                      device="meta", seed: int = 0) -> BuiltCell:
    """gin-tu with the explicit PA pull-exchange (edges pre-grouped by
    destination owner, all_gather + local combine) over one shard per
    device of ``mesh``: a ShardMesh of that many shards on ``device``."""
    base = full_config(arch)
    p = shape.params
    axes = tuple(mesh.axis_names)
    nparts = math.prod(mesh.shape[a] for a in axes)
    N, E, d = p["n_nodes"], p["n_edges"], p["d_feat"]
    Np = _pad_to(N, nparts * 8)
    cap = _pad_to(int(E * 1.2 // nparts) + 1, 8)
    gcfg = dataclasses.replace(base, d_in=d, d_out=p["n_classes"],
                               **{k: v for k, v in overrides.items()
                                  if k not in ("mp_exchange",)})
    inp = _Inputs(device, seed + 1)
    batch = {"feats": inp.normal((Np, d)),
             "e_src": inp.ints((nparts, cap), Np),
             "e_dst": inp.ints((nparts, cap), Np),
             "labels": inp.ints((Np,), p["n_classes"])}     # -1 = padding
    row = make_sharding(mesh, (axes, None), (Np, d))
    erow = make_sharding(mesh, (axes, None), (nparts, cap))
    lrow = make_sharding(mesh, (axes,), (Np,))
    batch_sh = {"feats": row, "e_src": erow, "e_dst": erow, "labels": lrow}
    shards = ShardMesh(devices=(inp.device,) * nparts)
    params, opt, p_sh, o_sh = _gnn_state(gnn_mod.gin_init, gcfg, inp, seed)

    def loss_fn(params, batch):
        out = gnn_mod.gin_apply_mp(params, gcfg, batch["feats"],
                                   batch["e_src"], batch["e_dst"], shards)
        lse = torch.logsumexp(out.float(), dim=-1)
        labels = batch["labels"].long()
        valid = labels >= 0
        picked = torch.gather(out.float(), -1,
                              labels.clamp(min=0)[:, None])[:, 0]
        return (torch.where(valid, lse - picked, 0.0).sum()
                / valid.sum().clamp(min=1))

    return BuiltCell(
        name=f"{arch}@{shape.name}", fn=_train_step(loss_fn),
        args=(params, opt, batch),
        in_shardings=(p_sh, o_sh, batch_sh),
        out_shardings=(p_sh, o_sh, REPLICATED),
        donate=(0, 1),
        meta={"cfg": gcfg, "kind": "train", "n": Np, "m": nparts * cap,
              "mp_exchange": True})


def build_gnn_cell(arch: str, shape: ShapeSpec, mesh,
                   direction: str = "pull",
                   overrides: Optional[dict] = None, device="meta",
                   seed: int = 0) -> BuiltCell:
    base = full_config(arch)
    overrides = dict(overrides or {})
    if overrides.get("mp_exchange"):
        return build_gnn_mp_cell(arch, shape, mesh, overrides, device, seed)
    shard_axes = overrides.pop("shard_axes", "batch")
    spec, batch_sh, meta = _gnn_batch_spec(arch, shape, mesh,
                                           shard_axes=shard_axes)
    if meta["task"] == "node_class":
        d_out = meta["n_classes"]
    elif meta["task"] == "graph_reg":
        d_out = 1
    else:
        d_out = 0
    gcfg = dataclasses.replace(base, d_in=meta["d_feat"], d_out=d_out,
                               direction=direction, **overrides)
    inp = _Inputs(device, seed + 1)
    params, opt, p_sh, o_sh = _gnn_state(_GNN_INIT[arch], gcfg, inp, seed)
    batch = _gnn_inputs(spec, meta, inp)
    N, M = meta["n"], meta["m"]

    def apply_model(params, batch):
        ev = EdgeView(src=batch["src"], dst=batch["dst"], w=batch["w"],
                      n=N, m=M)
        if arch == "egnn":
            out, _ = gnn_mod.egnn_apply(params, gcfg, ev, batch["feats"],
                                        batch["coords"])
        elif arch == "gin-tu":
            out = gnn_mod.gin_apply(
                params, gcfg, ev, batch["feats"],
                graph_ids=batch.get("graph_ids"),
                num_graphs=meta.get("n_graphs", 1))
        elif arch == "graphsage-reddit":
            out = gnn_mod.sage_apply(params, gcfg, ev, batch["feats"])
        else:
            out = gnn_mod.graphcast_apply(params, gcfg, ev, batch["feats"])
        return out

    def loss_fn(params, batch):
        out = apply_model(params, batch)
        if meta["task"] == "node_class":
            k = meta["labeled"]
            return softmax_xent_dense(out[:k], batch["labels"][:k])
        if meta["task"] == "graph_reg":
            if out.shape[0] == meta["n"]:      # per-node output: pool
                out = segment_sum(out, batch["graph_ids"], meta["n_graphs"])
            return mse(out[:, 0] if out.ndim > 1 else out, batch["labels"])
        return mse(out[:meta["n_true"]], batch["target"][:meta["n_true"]])

    return BuiltCell(
        name=f"{arch}@{shape.name}", fn=_train_step(loss_fn),
        args=(params, opt, batch),
        in_shardings=(p_sh, o_sh, batch_sh),
        out_shardings=(p_sh, o_sh, REPLICATED),
        donate=(0, 1), meta={"cfg": gcfg, "kind": "train", **meta})


# -------------------------------------------------------------- recsys --
def build_recsys_cell(arch: str, shape: ShapeSpec, mesh, device="meta",
                      seed: int = 0) -> BuiltCell:
    cfg = full_config(arch)
    inp = _Inputs(device, seed + 1)
    name = f"{arch}@{shape.name}"
    V = cfg.vocab_per_field

    if shape.kind == "train":
        B = shape.params["batch"]
        params = _trainable(xdeepfm_init(cfg, seed=seed, device=inp.device))
        p_sh = recsys_param_specs(mesh, params)
        opt = init_opt(params, OPT_CFG)
        o_sh = _opt_specs(lambda t: recsys_param_specs(mesh, t), opt)
        batch = {"ids": inp.ints((B, cfg.n_fields), V),
                 "labels": inp.ints((B,), 2).to(F32)}
        batch_sh = {"ids": _batch_sharding(mesh, (B, cfg.n_fields),
                                           (None,)),
                    "labels": _batch_sharding(mesh, (B,))}
        step = _train_step(lambda p, b: bce_with_logits(
            xdeepfm_apply(p, cfg, b["ids"]), b["labels"]))
        return BuiltCell(
            name=name, fn=step, args=(params, opt, batch),
            in_shardings=(p_sh, o_sh, batch_sh),
            out_shardings=(p_sh, o_sh, REPLICATED),
            donate=(0, 1), meta={"cfg": cfg, "kind": "train"})

    params = xdeepfm_init(cfg, seed=seed, device=inp.device)
    p_sh = recsys_param_specs(mesh, params)
    if shape.kind == "serve":
        B = shape.params["batch"]

        @torch.no_grad()
        def step(params, ids):
            return torch.sigmoid(xdeepfm_apply(params, cfg, ids))

        return BuiltCell(
            name=name, fn=step,
            args=(params, inp.ints((B, cfg.n_fields), V)),
            in_shardings=(p_sh, _batch_sharding(mesh, (B, cfg.n_fields),
                                                (None,))),
            out_shardings=_batch_sharding(mesh, (B,)),
            meta={"cfg": cfg, "kind": "serve"})

    # retrieval: 1 user row vs n_candidates item rows
    NC = shape.params["n_candidates"]
    Fu = cfg.n_fields // 2
    Fc = cfg.n_fields - Fu

    @torch.no_grad()
    def step(params, user_ids, cand_ids):
        return retrieval_score(params, cfg, user_ids, cand_ids)

    return BuiltCell(
        name=name, fn=step,
        args=(params, inp.ints((1, Fu), V), inp.ints((NC, Fc), V)),
        in_shardings=(p_sh, REPLICATED,
                      _batch_sharding(mesh, (NC, Fc), (None,))),
        out_shardings=_batch_sharding(mesh, (NC,)),
        meta={"cfg": cfg, "kind": "retrieval"})
