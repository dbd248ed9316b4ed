"""Attention (port of ``repro.models.attention``): GQA + RoPE, sliding
window, logit soft-capping (gemma2), QKV bias (qwen), and one-token
decode over KV caches (plain, int8-quantized, sliding-window ring).

Shapes: activations [B, T, D]; heads split as [B, T, H, Dh].

:func:`blockwise_sdpa` is the prefill and training attention. On a card
tensor it is the flash-attention kernel (``kernels.ops.flash_attention``,
with a gradient under autograd); on a CPU tensor it is the plain
streaming version below, the reference's ``blockwise_sdpa``, or under
autograd the kernel's ``autograd.Function`` over the plain version.
:func:`_sdpa` is the plain materialized-scores core
(``attn_impl="naive"`` and decode). Decode attention has no kernel in
the JAX package and stays plain PyTorch here.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import torch

from ..kernels import ops
from .common import dense_apply, dense_init, softcap

__all__ = ["AttnConfig", "attn_init", "attn_apply", "rope",
           "blockwise_sdpa", "decode_attn_apply", "KVCacheSpec",
           "quantize_kv", "dequantize_kv"]

_NEG = -1e30


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 500000.0
    qkv_bias: bool = False            # qwen1.5
    window: Optional[int] = None      # sliding window (gemma2 local layers)
    logit_softcap: Optional[float] = None  # gemma2
    query_scale: Optional[float] = None

    @property
    def scale(self) -> float:
        return (self.query_scale if self.query_scale is not None
                else self.head_dim ** -0.5)


def attn_init(gen: torch.Generator, cfg: AttnConfig,
              dtype: torch.dtype = torch.float32) -> dict:
    return {
        "wq": dense_init(gen, cfg.d_model, cfg.n_heads * cfg.head_dim,
                         dtype, bias=cfg.qkv_bias),
        "wk": dense_init(gen, cfg.d_model, cfg.n_kv_heads * cfg.head_dim,
                         dtype, bias=cfg.qkv_bias),
        "wv": dense_init(gen, cfg.d_model, cfg.n_kv_heads * cfg.head_dim,
                         dtype, bias=cfg.qkv_bias),
        "wo": dense_init(gen, cfg.n_heads * cfg.head_dim, cfg.d_model,
                         dtype),
    }


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding; x: [..., T, H, Dh], positions: [..., T]."""
    half = x.shape[-1] // 2
    log_theta = torch.log(torch.tensor(theta, dtype=torch.float32,
                                       device=x.device))
    freqs = torch.exp(-log_theta * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freqs        # [..., T, half]
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1.to(x.dtype), y2.to(x.dtype)], dim=-1)


def _scores_mask(Tq: int, Tk: int, offset: int, window: Optional[int],
                 device=None) -> torch.Tensor:
    """Causal (+ optional sliding window) mask [Tq, Tk]; offset = absolute
    position of query 0 minus key 0."""
    q_pos = torch.arange(Tq, device=device)[:, None] + offset
    k_pos = torch.arange(Tk, device=device)[None, :]
    mask = k_pos <= q_pos
    if window is not None:
        mask &= k_pos > (q_pos - window)
    return mask


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: torch.Tensor, cfg: AttnConfig) -> torch.Tensor:
    """q: [B, Tq, H, Dh], k, v: [B, Tk, Hk, Dh]; grouped-query attention
    with materialized f32 scores. mask: [Tq, Tk] (shared) or anything
    broadcastable to [B, Hk, group, Tq, Tk] (per-row decode masks)."""
    B, Tq, H, Dh = q.shape
    Hk = k.shape[2]
    qg = q.reshape(B, Tq, Hk, H // Hk, Dh)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(),
                          k.float()) * cfg.scale
    if cfg.logit_softcap is not None:
        logits = softcap(logits, cfg.logit_softcap)
    if mask.ndim == 2:
        mask = mask[None, None, None]
    logits = torch.where(mask, logits, torch.tensor(_NEG,
                                                    device=logits.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(B, Tq, H, Dh).to(q.dtype)


def blockwise_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   cfg: AttnConfig, window: int, q_chunk: int = 512,
                   kv_chunk: int = 1024) -> torch.Tensor:
    """Streaming (flash-style) causal attention: online softmax over KV
    chunks, Q chunk by Q chunk; the [T, T] scores never exist. ``window``
    is a Python int (a large value is global). q: [B, T, H, Dh], k, v:
    [B, T, Hk, Dh].

    On the card (and on ``meta``, where the dry run runs the card's
    program) this is the flash-attention kernel (the chunk sizes then
    do not apply to the forward: the kernel's tiles are its own, and no
    tile changes the result). Under autograd (grad enabled, an input
    requiring it) it is the kernel's ``autograd.Function`` on either
    device: the forward kernel (on the CPU its plain version), and a
    backward that recomputes the plain attention ``q_chunk`` queries at
    a time. Otherwise, on the CPU: scores q.k in f32, scaled,
    soft-capped, masked; P enters P·V in v's dtype, as in the reference.
    """
    cap = cfg.logit_softcap
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad)
    if q.device.type in ("cuda", "meta") or grad:
        return ops.flash_attention(q, k, v, causal_window=int(window),
                                   softcap=0.0 if cap is None else cap,
                                   block_q=q_chunk, scale=cfg.scale)
    B, T, H, Dh = q.shape
    Hk = k.shape[2]
    group = H // Hk
    qc, kc = min(q_chunk, T), min(kv_chunk, T)
    nq, nk = -(-T // qc), -(-T // kc)
    qp = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, nq * qc - T))
    kp = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, nk * kc - T))
    vp = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, nk * kc - T))
    qg = qp.reshape(B, nq, qc, Hk, group, Dh)
    kg = kp.reshape(B, nk, kc, Hk, Dh)
    vg = vp.reshape(B, nk, kc, Hk, Dh)
    neg = torch.tensor(_NEG, device=q.device)
    outs = []
    for qi in range(nq):
        qb = qg[:, qi].float()                        # [B, qc, Hk, g, Dh]
        q_pos = qi * qc + torch.arange(qc, device=q.device)
        m = torch.full((B, Hk, group, qc), -math.inf, device=q.device)
        l = torch.zeros((B, Hk, group, qc), device=q.device)
        o = torch.zeros((B, Hk, group, qc, Dh), device=q.device)
        for ki in range(nk):
            vb = vg[:, ki]
            k_pos = ki * kc + torch.arange(kc, device=q.device)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qb,
                             kg[:, ki].float()) * cfg.scale
            if cap is not None:
                s = softcap(s, cap)
            mask = ((k_pos[None, :] <= q_pos[:, None])
                    & (k_pos[None, :] > q_pos[:, None] - window)
                    & (k_pos[None, :] < T))
            s = torch.where(mask, s, neg)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            o = o * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p.to(vb.dtype).float(), vb.float())
            m = m_new
        out = o / torch.clamp(l, min=1e-30)[..., None]   # [B,Hk,g,qc,Dh]
        outs.append(out.permute(0, 3, 1, 2, 4))           # [B,qc,Hk,g,Dh]
    out = torch.cat(outs, dim=1).reshape(B, nq * qc, H, Dh)
    return out[:, :T].to(q.dtype)


def attn_apply(p: dict, cfg: AttnConfig, x: torch.Tensor,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full (prefill) self-attention through :func:`_sdpa`. x: [B, T, D]."""
    B, T, _ = x.shape
    if positions is None:
        positions = torch.arange(T, device=x.device)[None, :]
    q = dense_apply(p["wq"], x).reshape(B, T, cfg.n_heads, cfg.head_dim)
    k = dense_apply(p["wk"], x).reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    v = dense_apply(p["wv"], x).reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    mask = _scores_mask(T, T, 0, cfg.window, x.device)
    out = _sdpa(q, k, v, mask, cfg)
    return dense_apply(p["wo"], out.reshape(B, T, -1))


@dataclasses.dataclass(frozen=True)
class KVCacheSpec:
    """Static description of a layer's KV cache.

    kind: 'bf16' (plain), 'int8' (per-(token,head) scaled), or the cache
    length may be the sliding window for local layers (ring indexing).
    """
    length: int
    kind: str = "bf16"


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 symmetric quantization over the last axis: (int8 values, f32
    scales with a trailing axis of 1)."""
    x32 = x.float()
    amax = x32.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-6) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def decode_attn_apply(p: dict, cfg: AttnConfig, x: torch.Tensor,
                      cache: dict, cur_len: Union[int, torch.Tensor]
                      ) -> tuple[torch.Tensor, dict]:
    """One-token decode step against a KV cache.

    x: [B, 1, D]; cache holds 'k', 'v' [B, S, Hk, Dh] (+ 'k_scale',
    'v_scale' [B, S, Hk, 1] for int8). ``cur_len``: an int, or int [B]
    per-row lengths (continuous batching). For windowed layers S is the
    window and writes wrap (ring buffer); RoPE positions stay absolute.
    The new token's K and V are written into the cache's tensors in
    place (the reference returns new arrays); the same dict is returned.
    """
    B = x.shape[0]
    S = cache["k"].shape[1]
    cur = torch.as_tensor(cur_len, device=x.device).to(
        torch.int64).expand(B)
    pos = cur[:, None]
    q = dense_apply(p["wq"], x).reshape(B, 1, cfg.n_heads, cfg.head_dim)
    k = dense_apply(p["wk"], x).reshape(B, 1, cfg.n_kv_heads, cfg.head_dim)
    v = dense_apply(p["wv"], x).reshape(B, 1, cfg.n_kv_heads, cfg.head_dim)
    q = rope(q, pos, cfg.rope_theta)
    k = rope(k, pos, cfg.rope_theta)

    slot = (torch.remainder(cur, S) if cfg.window is not None
            else torch.clamp(cur, max=S - 1))
    rows = torch.arange(B, device=x.device)
    if "k_scale" in cache:
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        cache["k"][rows, slot] = kq[:, 0]
        cache["v"][rows, slot] = vq[:, 0]
        cache["k_scale"][rows, slot] = ks[:, 0]
        cache["v_scale"][rows, slot] = vs[:, 0]
        k_all = dequantize_kv(cache["k"], cache["k_scale"], x.dtype)
        v_all = dequantize_kv(cache["v"], cache["v_scale"], x.dtype)
    else:
        cache["k"][rows, slot] = k[:, 0].to(cache["k"].dtype)
        cache["v"][rows, slot] = v[:, 0].to(cache["v"].dtype)
        k_all = cache["k"].to(x.dtype)
        v_all = cache["v"].to(x.dtype)

    # validity per (row, cache slot): ring wrap and the unfilled tail
    slots = torch.arange(S, device=x.device)[None, :]
    if cfg.window is not None:
        valid = (slots <= slot[:, None]) | (cur[:, None] >= S)
    else:
        valid = slots <= cur[:, None]
    out = _sdpa(q, k_all, v_all, valid[:, None, None, None, :], cfg)
    return dense_apply(p["wo"], out.reshape(B, 1, -1)), cache
