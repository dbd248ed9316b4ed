"""Decoder-only transformer LM (port of ``repro.models.transformer``):
serving and training, dense and MoE layers.

The serving path: :func:`prefill` runs a prompt and returns the
last-position logits and a KV cache laid out as :func:`init_kv_cache`
and :func:`decode_step` expect; :func:`decode_step` adds one token.
:func:`forward` returns the final hidden states and :func:`lm_loss` the
sequence-chunked cross entropy that training differentiates.

Differences from the reference, none of which changes a result:

  * layers are a list of per-layer dicts and the layer loop runs on the
    host, each layer's window a Python int (the reference stacks layers
    on a leading axis for ``jax.lax.scan``); :func:`params_from_arrays`
    takes the reference's stacked tree as numpy arrays (and carries its
    gradients and optimizer moments across the same way), and
    :func:`decay_mask` marks the leaves the reference's AdamW decays;
  * with ``remat`` (the default) and grad enabled, :func:`forward`
    checkpoints each layer (``torch.utils.checkpoint``, non-reentrant),
    as the reference's ``jax.checkpoint`` does: the backward pass runs
    the layer again, the flash-attention kernel included;
  * with ``attn_impl="blockwise"`` (the default) attention on the card
    is the flash-attention kernel, with a gradient
    (``kernels.flash_attention.FlashAttention``); ``"naive"`` runs the
    plain materialized-scores ``_sdpa``;
  * :func:`lm_loss` casts the unembed to f32 once per call (the
    reference casts it inside each chunk of its scan, where XLA keeps
    one copy; eager autograd would keep one per chunk) and picks the
    label's logit with a gather (the reference's iota mask keeps the
    vocab axis sharded; the value is the same);
  * :func:`decode_step` writes the new token into the cache in place;
  * the reference's sharding hints have no counterpart on one card.

MoE layers (``cfg.moe`` set: moonshot, deepseek) replace each layer's
FFN by ``models.moe.moe_apply_ep`` (which is ``moe_apply`` unless an
activation mesh is installed), in prefill, decode and training alike;
a layer holds ``moe`` instead of ``ffn``, its experts stacked on a
leading [E] axis.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..graphs.structure import resolve_device
from ..kernels.flash_attention import GLOBAL_WINDOW
from .attention import (AttnConfig, _sdpa, attn_init, blockwise_sdpa,
                        decode_attn_apply, quantize_kv, rope)
from .common import (dense_apply, dense_init, embed_init, generator,
                     rms_norm, silu, softcap, tree_from_arrays, tree_leaves,
                     tree_map)
from .moe import MoEConfig, moe_apply_ep, moe_init

__all__ = ["TransformerConfig", "init_params", "params_from_arrays",
           "decay_mask", "forward", "lm_loss", "prefill", "decode_step",
           "init_kv_cache", "pad_kv_cache", "quantize_kv_tree",
           "GLOBAL_WINDOW"]

ATTN_IMPLS = ("blockwise", "naive")
CACHE_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    rope_theta: float = 500000.0
    qkv_bias: bool = False
    # gemma2: every other layer local with this window; None = all global
    local_window: Optional[int] = None
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    embed_scale: bool = False          # gemma multiplies embed by sqrt(D)
    moe: Optional[MoEConfig] = None
    dtype: str = "bfloat16"
    loss_chunk: int = 512
    remat: bool = True
    attn_impl: str = "blockwise"       # 'naive' | 'blockwise'
    q_chunk: int = 512
    kv_chunk: int = 1024

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def attn_cfg(self, window: Optional[int] = None) -> AttnConfig:
        return AttnConfig(
            d_model=self.d_model, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, head_dim=self.hd,
            rope_theta=self.rope_theta, qkv_bias=self.qkv_bias,
            window=window, logit_softcap=self.attn_softcap)

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32

    def window_array(self, seq_len: int) -> list[int]:
        """Per-layer window (``GLOBAL_WINDOW`` = global): even layers are
        local when ``local_window`` is set."""
        if self.local_window is None:
            return [GLOBAL_WINDOW] * self.n_layers
        return [self.local_window if i % 2 == 0 else GLOBAL_WINDOW
                for i in range(self.n_layers)]


def _check(cfg: TransformerConfig) -> None:
    if cfg.attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl {cfg.attn_impl!r} not in {ATTN_IMPLS}")


def init_params(cfg: TransformerConfig, seed: int = 0,
                device=None) -> dict:
    """Random weights from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (the card unless given): the reference's initializers.
    On ``meta``: the shapes and dtypes only."""
    _check(cfg)
    gen = generator(seed, device)
    dt, dev = cfg.torch_dtype, gen.device
    embed = embed_init(gen, cfg.vocab, cfg.d_model, dt)
    layers = []
    for _ in range(cfg.n_layers):
        layer = {"attn": attn_init(gen, cfg.attn_cfg(), dt),
                 "ln1": torch.zeros(cfg.d_model, device=dev),
                 "ln2": torch.zeros(cfg.d_model, device=dev)}
        if cfg.moe is not None:
            layer["moe"] = moe_init(gen, cfg.moe, dt)
        else:
            layer["ffn"] = {"wi": dense_init(gen, cfg.d_model, cfg.d_ff, dt),
                            "wg": dense_init(gen, cfg.d_model, cfg.d_ff, dt),
                            "wo": dense_init(gen, cfg.d_ff, cfg.d_model, dt)}
        layers.append(layer)
    return {"embed": embed, "layers": layers,
            "final_ln": torch.zeros(cfg.d_model, device=dev),
            "unembed": dense_init(gen, cfg.d_model, cfg.vocab, dt)}


def params_from_arrays(tree: dict, device=None) -> dict:
    """The reference's parameter tree (``repro.models.transformer.
    init_params``, as numpy arrays, layers stacked on a leading [L] axis)
    as this module's parameters on ``device`` (the card unless given).
    A MoE layer's [L, E, ...] leaves become its own [E, ...] stacks."""
    dev = resolve_device(device)
    n_layers = np.asarray(tree["layers"]["ln1"]).shape[0]
    out = tree_from_arrays({k: v for k, v in tree.items()
                            if k != "layers"}, dev)
    out["layers"] = [
        tree_from_arrays(tree_map(lambda a, i=i: np.asarray(a)[i],
                                  tree["layers"]), dev)
        for i in range(n_layers)]
    return out


def decay_mask(params: dict) -> dict:
    """Which leaves the reference's AdamW decays (``ndim >= 2`` on its
    tree): the embeddings, and every per-layer leaf, since the
    reference stacks layers on a leading [L] axis (its norm scales and
    biases are [L, D] there); not the final norm."""
    out = tree_map(lambda p: p.ndim >= 2,
                   {k: v for k, v in params.items() if k != "layers"})
    out["layers"] = tree_map(lambda p: True, params["layers"])
    return out


def _embed(params: dict, cfg: TransformerConfig,
           tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens]
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                             device=x.device)
    return x


def _ffn(cfg: TransformerConfig, lp: dict, h: torch.Tensor) -> torch.Tensor:
    if cfg.moe is not None:
        return moe_apply_ep(lp["moe"], cfg.moe, h)
    ffn = lp["ffn"]
    return (silu(h @ ffn["wg"]["w"]) * (h @ ffn["wi"]["w"])) @ ffn["wo"]["w"]


def _layer_apply(cfg: TransformerConfig, lp: dict, x: torch.Tensor,
                 window: int, positions: torch.Tensor):
    """One prefill layer; returns (output, (k, v))."""
    acfg = cfg.attn_cfg()
    B, T, _ = x.shape
    h = rms_norm(x, lp["ln1"])
    q = dense_apply(lp["attn"]["wq"], h).reshape(B, T, acfg.n_heads,
                                                 acfg.head_dim)
    k = dense_apply(lp["attn"]["wk"], h).reshape(B, T, acfg.n_kv_heads,
                                                 acfg.head_dim)
    v = dense_apply(lp["attn"]["wv"], h).reshape(B, T, acfg.n_kv_heads,
                                                 acfg.head_dim)
    q = rope(q, positions, acfg.rope_theta)
    k = rope(k, positions, acfg.rope_theta)
    if cfg.attn_impl == "blockwise":
        attn = blockwise_sdpa(q, k, v, acfg, window, cfg.q_chunk,
                              cfg.kv_chunk)
    else:
        pos = torch.arange(T, device=x.device)
        q_pos, k_pos = pos[:, None], pos[None, :]
        mask = (k_pos <= q_pos) & (k_pos > q_pos - window)
        attn = _sdpa(q, k, v, mask, acfg)
    x = x + dense_apply(lp["attn"]["wo"], attn.reshape(B, T, -1))
    return x + _ffn(cfg, lp, rms_norm(x, lp["ln2"])), (k, v)


def _layer_out(cfg: TransformerConfig, lp: dict, x: torch.Tensor,
               window: int, positions: torch.Tensor) -> torch.Tensor:
    return _layer_apply(cfg, lp, x, window, positions)[0]


def forward(params: dict, cfg: TransformerConfig,
            tokens: torch.Tensor) -> torch.Tensor:
    """tokens [B, T] -> final hidden states [B, T, D]. Under autograd
    with ``cfg.remat``, each layer is checkpointed."""
    _check(cfg)
    T = tokens.shape[1]
    x = _embed(params, cfg, tokens)
    positions = torch.arange(T, device=x.device)[None, :]
    remat = cfg.remat and torch.is_grad_enabled() and any(
        t.requires_grad for t in tree_leaves(params))
    for lp, window in zip(params["layers"], cfg.window_array(T)):
        if remat:
            x = checkpoint(_layer_out, cfg, lp, x, window, positions,
                           use_reentrant=False)
        else:
            x = _layer_out(cfg, lp, x, window, positions)
    return rms_norm(x, params["final_ln"])


def lm_loss(params: dict, cfg: TransformerConfig, tokens: torch.Tensor,
            labels: torch.Tensor) -> torch.Tensor:
    """Sequence-chunked cross entropy, the mean over tokens whose label
    is not negative: the logits exist for ``cfg.loss_chunk`` positions
    at a time, never at [B, T, V]. tokens, labels: int [B, T]."""
    T = tokens.shape[1]
    x = forward(params, cfg, tokens)                   # [B, T, D]
    chunk = min(cfg.loss_chunk, T)
    w = params["unembed"]["w"].float()                 # once per call
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    count = torch.zeros((), dtype=torch.int64, device=x.device)
    for lo in range(0, T, chunk):
        logits = x[:, lo:lo + chunk].float() @ w       # [B, chunk, V]
        if cfg.final_softcap is not None:
            logits = softcap(logits, cfg.final_softcap)
        lse = torch.logsumexp(logits, dim=-1)
        lc = labels[:, lo:lo + chunk].long()
        picked = torch.gather(logits, -1,
                              torch.clamp(lc, min=0)[..., None])[..., 0]
        valid = lc >= 0
        total = total + torch.where(valid, lse - picked, 0.0).sum()
        count = count + valid.sum()
    return total / torch.clamp(count, min=1).to(torch.float32)


def _logits(params: dict, cfg: TransformerConfig,
            x: torch.Tensor) -> torch.Tensor:
    """f32 logits of hidden states x [B, D]."""
    logits = x.float() @ params["unembed"]["w"].float()
    if cfg.final_softcap is not None:
        logits = softcap(logits, cfg.final_softcap)
    return logits


# the stacked caches quantize over their last axis as one layer's do
quantize_kv_tree = quantize_kv


def _package(ks: list, vs: list, kind: str) -> dict:
    """Per-layer K, V [B, T, Hk, Dh] -> stacked cache buffers [L, ...]."""
    if kind == "int8":
        kq, ksc = zip(*(quantize_kv_tree(k) for k in ks))
        vq, vsc = zip(*(quantize_kv_tree(v) for v in vs))
        return {"k": torch.stack(kq), "v": torch.stack(vq),
                "k_scale": torch.stack(ksc), "v_scale": torch.stack(vsc)}
    dt = CACHE_DTYPES[kind]
    return {"k": torch.stack([k.to(dt) for k in ks]),
            "v": torch.stack([v.to(dt) for v in vs])}


def prefill(params: dict, cfg: TransformerConfig, tokens: torch.Tensor,
            cache_kind: str = "bf16") -> tuple[torch.Tensor, dict]:
    """Process a prompt: returns (last-position logits f32 [B, V], cache)
    laid out as :func:`init_kv_cache` / :func:`decode_step` expect, of
    length T; gemma2 local layers keep only the last-window ring.
    ``cache_kind``: 'bf16', 'f32' or 'int8'."""
    _check(cfg)
    if cache_kind not in (*CACHE_DTYPES, "int8"):
        raise ValueError(f"cache_kind {cache_kind!r}")
    T = tokens.shape[1]
    x = _embed(params, cfg, tokens)
    positions = torch.arange(T, device=x.device)[None, :]
    ks, vs = [], []
    for lp, window in zip(params["layers"], cfg.window_array(T)):
        x, (k, v) = _layer_apply(cfg, lp, x, window, positions)
        ks.append(k)
        vs.append(v)
    x = rms_norm(x, params["final_ln"])
    logits = _logits(params, cfg, x[:, -1])
    if cfg.local_window is None:
        return logits, _package(ks, vs, cache_kind)
    W = min(cfg.local_window, T)
    # ring layout: decode writes token t at slot t % W, so slot s of the
    # surviving last-W window holds token (T - W) + ((s - (T - W)) % W)
    slots = torch.arange(W, device=x.device)
    t_of_slot = (T - W) + torch.remainder(slots - ((T - W) % W), W)
    return logits, {
        "local": _package([k[:, t_of_slot] for k in ks[0::2]],
                          [v[:, t_of_slot] for v in vs[0::2]], cache_kind),
        "global": _package(ks[1::2], vs[1::2], cache_kind)}


def _cache_buf(L: int, batch: int, S: int, Hk: int, Dh: int, kind: str,
               device) -> dict:
    shape = (L, batch, S, Hk, Dh)
    if kind == "int8":
        scale = (L, batch, S, Hk, 1)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(scale, device=device),
                "v_scale": torch.zeros(scale, device=device)}
    dt = CACHE_DTYPES[kind]
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def init_kv_cache(cfg: TransformerConfig, batch: int, max_len: int,
                  kind: str = "bf16", device=None) -> dict:
    """Stacked per-layer KV caches on ``device`` (the card unless given).

    Uniform archs: {'k', 'v', ...} of shape [L, B, S, Hk, Dh].
    Local/global alternation (gemma2): {'local': ..., 'global': ...},
    where the local (even) layers keep only a window-sized ring.
    """
    dev = resolve_device(device)
    L, Hk, Dh = cfg.n_layers, cfg.n_kv_heads, cfg.hd
    if cfg.local_window is None:
        return _cache_buf(L, batch, max_len, Hk, Dh, kind, dev)
    if L % 2:
        raise ValueError("local/global alternation expects an even layer "
                         f"count, not {L}")
    W = min(cfg.local_window, max_len)
    return {"local": _cache_buf(L // 2, batch, W, Hk, Dh, kind, dev),
            "global": _cache_buf(L // 2, batch, max_len, Hk, Dh, kind, dev)}


def pad_kv_cache(cache: dict, max_len: int) -> dict:
    """A prefill cache grown to ``max_len`` positions (zeros past its
    end), so that decode can append: a prefill of T tokens returns
    buffers of length T, and a plain cache's last slot is reused once
    full. A gemma2 local ring keeps its length. The buffers are new, so
    decoding into them leaves ``cache`` as it was."""
    if "global" in cache:
        return {"local": {k: v.clone() for k, v in cache["local"].items()},
                "global": pad_kv_cache(cache["global"], max_len)}
    out = {}
    for name, buf in cache.items():
        extra = max_len - buf.shape[2]
        if extra < 0:
            raise ValueError(f"cache holds {buf.shape[2]} positions, more "
                             f"than max_len={max_len}")
        pad = buf.new_zeros(buf.shape[:2] + (extra,) + buf.shape[3:])
        out[name] = torch.cat([buf, pad], dim=2)
    return out


def _decode_layer(cfg: TransformerConfig, lp: dict, x: torch.Tensor,
                  layer_cache: dict, cur_len, window: Optional[int]):
    out, _ = decode_attn_apply(lp["attn"], cfg.attn_cfg(window),
                               rms_norm(x, lp["ln1"]), layer_cache, cur_len)
    x = x + out
    return x + _ffn(cfg, lp, rms_norm(x, lp["ln2"]))


def decode_step(params: dict, cfg: TransformerConfig, tokens: torch.Tensor,
                cache: dict, cur_len: Union[int, torch.Tensor]
                ) -> tuple[torch.Tensor, dict]:
    """One decode step. tokens [B, 1] -> (f32 logits [B, V], cache); the
    token's K and V are written into ``cache`` in place, and the same
    dict is returned. ``cur_len``: the token's position, an int or int
    [B] per row."""
    _check(cfg)
    x = _embed(params, cfg, tokens)
    for i, lp in enumerate(params["layers"]):
        if cfg.local_window is None:
            bufs, window = cache, None
        elif i % 2 == 0:
            bufs, window = cache["local"], cfg.local_window
        else:
            bufs, window = cache["global"], None
        li = i if cfg.local_window is None else i // 2
        layer_cache = {name: buf[li] for name, buf in bufs.items()}
        x = _decode_layer(cfg, lp, x, layer_cache, cur_len, window)
    x = rms_norm(x, params["final_ln"])
    return _logits(params, cfg, x[:, 0]), cache
