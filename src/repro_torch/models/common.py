"""Shared model building blocks (port of ``repro.models.common``).

Parameters are plain nested dicts and lists of tensors, with the JAX
package's names and layouts (a dense weight is ``[d_in, d_out]``), so a
tree carries across as numpy arrays. Initializers draw from an explicit
``torch.Generator``: the distributions are the reference's, the numbers
are not (tests carry the reference's weights across instead). On the
``meta`` device, which has no generator, the initializers draw nothing
and make only the shapes and dtypes (:func:`generator`, :func:`randn`):
the dry run builds its cells there.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as nnf

from ..graphs.structure import resolve_device

__all__ = ["generator", "randn", "rms_norm", "layer_norm", "gelu", "silu",
           "dense_init", "dense_apply", "Dense", "embed_init", "mlp_init",
           "mlp_apply", "softcap",
           "param_count", "tree_size_bytes", "tree_leaves", "tree_map",
           "tensor_from_array", "tree_from_arrays"]

Params = Any


class _MetaGenerator:
    """Stands in for a ``torch.Generator`` on ``meta``, which has none."""
    device = torch.device("meta")


def generator(seed: int, device=None):
    """A ``torch.Generator`` on ``device`` (the card unless given) seeded
    with ``seed``; on ``meta`` a stand-in that :func:`randn` reads as
    "draw nothing"."""
    dev = resolve_device(device)
    if dev.type == "meta":
        return _MetaGenerator()
    return torch.Generator(device=dev).manual_seed(seed)


def randn(gen, shape) -> torch.Tensor:
    """f32 standard normals from ``gen`` on its device (uninitialised
    storage of the same shape on ``meta``)."""
    if gen.device.type == "meta":
        return torch.empty(shape, device=gen.device)
    return torch.randn(shape, generator=gen, device=gen.device)


def _normal(gen: torch.Generator, shape, std: float,
            dtype: torch.dtype) -> torch.Tensor:
    return randn(gen, shape).mul_(std).to(dtype)


def dense_init(gen: torch.Generator, d_in: int, d_out: int,
               dtype: torch.dtype = torch.float32,
               bias: bool = False) -> Params:
    """He-normal weight [d_in, d_out] (std sqrt(2 / d_in)), zero bias."""
    p = {"w": _normal(gen, (d_in, d_out), math.sqrt(2.0 / max(1, d_in)),
                      dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def dense_apply(p: Params, x: torch.Tensor) -> torch.Tensor:
    """``x @ w (+ b)``; mixed dtypes promote, as ``jnp``'s matmul does
    (an f32 input through bf16 weights computes in f32)."""
    w = p["w"]
    if w.dtype != x.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    y = x @ w
    if "b" in p:
        y = y + p["b"]
    return y


class Dense:
    """Tiny functional linear layer namespace."""
    init = staticmethod(dense_init)
    apply = staticmethod(dense_apply)


def embed_init(gen: torch.Generator, vocab: int, d: int,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return _normal(gen, (vocab, d), 0.02, dtype)


def mlp_init(gen: torch.Generator, dims: list[int],
             dtype: torch.dtype = torch.float32,
             bias: bool = True) -> list[Params]:
    return [dense_init(gen, dims[i], dims[i + 1], dtype, bias=bias)
            for i in range(len(dims) - 1)]


def mlp_apply(layers: list[Params], x: torch.Tensor,
              act: Callable = torch.relu,
              final_act: bool = False) -> torch.Tensor:
    for i, p in enumerate(layers):
        x = dense_apply(p, x)
        if i < len(layers) - 1 or final_act:
            x = act(x)
    return x


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in f32 with a ``1 + scale`` gain, back in x's dtype."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = ((x32 - mu) ** 2).mean(dim=-1, keepdim=True)
    out = (x32 - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    return cap * torch.tanh(x / cap)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation (``jax.nn.gelu``'s default)."""
    return nnf.gelu(x, approximate="tanh")


silu = nnf.silu


def tensor_from_array(a, device) -> torch.Tensor:
    """A numpy (or array-like) value as a tensor on ``device``; bfloat16
    arrays (``ml_dtypes``, which torch cannot read) go by their bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.array(a).view(np.uint16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def tree_map(fn: Callable, tree: Params) -> Params:
    """``fn`` applied to every leaf of a nested dict / list / tuple."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_from_arrays(tree: Params, device) -> Params:
    """A parameter tree of numpy arrays (the JAX package's, carried
    across) as tensors on ``device``."""
    return tree_map(lambda a: tensor_from_array(a, device), tree)


def tree_leaves(tree: Params) -> list[torch.Tensor]:
    """The tensors of a nested dict / list / tuple, in key order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return []


def param_count(params: Params) -> int:
    return sum(x.numel() for x in tree_leaves(params))


def tree_size_bytes(params: Params) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(params))
