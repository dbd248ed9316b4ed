"""xDeepFM (port of ``repro.models.recsys``): CIN + DNN + linear over
per-field embedding tables, for serving and training.

The embedding lookup is a pull: each (row, field) gathers one row of its
field's table. CIN (Compressed Interaction Network), xDeepFM eq. (6):

    X^k[b, h, d] = sum_{i, j} W^k[h, i, j] * X^{k-1}[b, i, d] * X^0[b, j, d]

one call of ``kernels.ops.cin_layer`` per layer (on the card the CUDA
kernel, which never forms the outer product; under autograd its
``CinLayer`` Function, whose backward launches the kernel twice more),
each layer's output pooled over d.
"""

from __future__ import annotations

import dataclasses

import torch

from ..graphs.structure import resolve_device
from ..kernels import ops
from .common import (dense_apply, dense_init, generator, mlp_apply,
                     mlp_init, randn, tree_from_arrays)

__all__ = ["XDeepFMConfig", "xdeepfm_init", "params_from_arrays",
           "xdeepfm_apply", "cin_apply", "retrieval_score"]


@dataclasses.dataclass(frozen=True)
class XDeepFMConfig:
    n_fields: int = 39
    vocab_per_field: int = 100_000
    embed_dim: int = 10
    cin_layers: tuple[int, ...] = (200, 200, 200)
    mlp_dims: tuple[int, ...] = (400, 400)
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


def xdeepfm_init(cfg: XDeepFMConfig, seed: int = 0, device=None) -> dict:
    """Random weights from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (the card unless given): the reference's initializers.
    The tables stack as one [F, V, D] tensor. On ``meta``: the shapes and
    dtypes only."""
    gen = generator(seed, device)
    dt = cfg.torch_dtype
    F, V, D = cfg.n_fields, cfg.vocab_per_field, cfg.embed_dim

    def normal(shape, std):
        return randn(gen, shape).mul_(std).to(dt)

    params = {"tables": normal((F, V, D), 0.01),
              "linear": normal((F, V), 0.01)}
    cin, h_prev = [], F
    for h in cfg.cin_layers:
        cin.append(normal((h, h_prev, F), (2.0 / (h_prev * F)) ** 0.5))
        h_prev = h
    params["cin"] = cin
    params["cin_out"] = dense_init(gen, sum(cfg.cin_layers), 1, dt)
    params["mlp"] = mlp_init(gen, [F * D, *cfg.mlp_dims], dt)
    params["mlp_out"] = dense_init(gen, cfg.mlp_dims[-1], 1, dt)
    return params


def params_from_arrays(tree: dict, device=None) -> dict:
    """The reference's parameter tree (``repro.models.recsys.
    xdeepfm_init``, as numpy arrays: the tables, the ``cin`` list, the
    ``mlp`` list) as this module's parameters on ``device`` (the card
    unless given)."""
    return tree_from_arrays(tree, resolve_device(device))


def cin_apply(cin_weights: list, x0: torch.Tensor) -> torch.Tensor:
    """x0: [B, F, D] -> pooled CIN features [B, sum(H_k)]."""
    xs, xk = [], x0
    for w in cin_weights:
        xk = ops.cin_layer(xk, x0, w)
        xs.append(xk.sum(dim=-1))          # pool over D
    return torch.cat(xs, dim=-1)


def _lookup(table: torch.Tensor, field0: int,
            ids: torch.Tensor) -> torch.Tensor:
    """table[field0 + f, ids[b, f]] for every (b, f): [B, F(, D)]."""
    fields = field0 + torch.arange(ids.shape[1], device=ids.device)
    return table[fields[None, :], ids.long()]


def xdeepfm_apply(params: dict, cfg: XDeepFMConfig,
                  ids: torch.Tensor) -> torch.Tensor:
    """ids: int [B, F], one id per field, each in [0, vocab_per_field)
    -> f32 logits [B]."""
    B, F = ids.shape
    x0 = _lookup(params["tables"], 0, ids)                 # [B, F, D]
    linear_term = _lookup(params["linear"], 0, ids).sum(dim=1)
    cin_term = dense_apply(params["cin_out"],
                           cin_apply(params["cin"], x0))[:, 0]
    mlp_feat = mlp_apply(params["mlp"], x0.reshape(B, F * cfg.embed_dim),
                         act=torch.relu, final_act=True)
    mlp_term = dense_apply(params["mlp_out"], mlp_feat)[:, 0]
    return (linear_term + cin_term + mlp_term).float()


def retrieval_score(params: dict, cfg: XDeepFMConfig,
                    user_ids: torch.Tensor,
                    cand_ids: torch.Tensor) -> torch.Tensor:
    """One query row [1, F_user] against N candidate rows [N, F_cand]:
    the dot of the mean-pooled user and candidate embeddings. User fields
    are the first F_user tables, candidate fields the next F_cand.
    Returns f32 [N]."""
    u = _lookup(params["tables"], 0, user_ids).mean(dim=1)        # [1, D]
    c = _lookup(params["tables"], user_ids.shape[-1],
                cand_ids).mean(dim=1)                              # [N, D]
    return (c @ u[0]).float()
