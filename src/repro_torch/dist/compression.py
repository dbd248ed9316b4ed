"""Compression with error feedback (DM traffic reduction). PyTorch port
of ``repro.dist.compression``.

The paper reduces DM traffic by *combining* messages; compressing what
crosses the wire is the other lever. Both schemes keep an error-feedback
accumulator so the compressed stream is unbiased over time:

  * ``topk``  — keep the largest ``topk_frac`` entries per leaf (value +
    int32 index on the wire); ties in ``|x|`` keep the lower index, as
    ``jax.lax.top_k`` does;
  * ``int8``  — symmetric per-leaf quantization (1 byte/entry + scale),
    rounding half to even;
  * ``none``  — identity.

``compress_tree`` returns the *decompressed* values (what the receiver
consumes after the exchange) plus the new error state;
``compressed_bytes`` is the analytic wire footprint. Trees are dicts,
lists, tuples and tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

__all__ = ["CompressionConfig", "init_error_state", "compress_tree",
           "compressed_bytes"]


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    kind: str = "none"            # 'none' | 'topk' | 'int8'
    topk_frac: float = 0.01


def _map(fn: Callable, *trees):
    """``fn`` over the leaves of trees of one structure, keeping each
    container's type."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: _map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def init_error_state(params: Any) -> Any:
    """Zero error-feedback accumulator shaped like ``params``."""
    return _map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def _topk_leaf(x: torch.Tensor, frac: float) -> torch.Tensor:
    flat = x.reshape(-1)
    k = max(1, int(frac * flat.shape[0]))
    # a stable descending sort keeps the lower index first among equal
    # magnitudes (torch.topk promises no order on ties)
    idx = torch.sort(flat.abs(), descending=True, stable=True).indices[:k]
    kept = torch.zeros_like(flat)
    kept[idx] = flat[idx]
    return kept.reshape(x.shape)


def _int8_leaf(x: torch.Tensor) -> torch.Tensor:
    scale = torch.clamp(x.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q.to(x.dtype) * scale


def compress_tree(grads: Any, err_state: Any,
                  cfg: CompressionConfig) -> tuple[Any, Any]:
    """Error-feedback compression: compress (value + carried error), carry
    the residual forward. Returns (decompressed, new_err_state)."""
    if cfg.kind == "none":
        return grads, err_state
    if cfg.kind == "topk":
        compress = lambda acc: _topk_leaf(acc, cfg.topk_frac)  # noqa: E731
    elif cfg.kind == "int8":
        compress = _int8_leaf
    else:
        raise ValueError(f"unknown compression kind {cfg.kind!r}")
    accs = _map(lambda g, e: g.to(torch.float32) + e, grads, err_state)
    decs = _map(compress, accs)
    err = _map(torch.subtract, accs, decs)
    dec = _map(lambda d, g: d.to(g.dtype), decs, grads)
    return dec, err


def compressed_bytes(tree: Any, cfg: CompressionConfig) -> int:
    """Analytic wire bytes of one compressed exchange of ``tree``."""
    total = 0
    for leaf in _leaves(tree):
        n = int(leaf.numel())
        if cfg.kind == "none":
            total += n * 4
        elif cfg.kind == "int8":
            total += n * 1 + 4                      # payload + scale
        elif cfg.kind == "topk":
            k = max(1, int(cfg.topk_frac * n))
            total += k * (4 + 4)                    # value + index
        else:
            raise ValueError(f"unknown compression kind {cfg.kind!r}")
    return total
