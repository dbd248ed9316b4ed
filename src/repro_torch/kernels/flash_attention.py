"""Causal online-softmax attention (FlashAttention) over GQA heads.

Port of ``repro.kernels.flash_attention.flash_attention_pallas``. On a
CUDA tensor :func:`flash_attention` launches the hand-written kernel in
``csrc/flash_attention.cu`` (bf16 on the tensor cores by wgmma, K and V
by TMA; f32 on CUDA cores); on a CPU tensor it runs
:func:`flash_attention_plain`, the port of the reference oracle
``repro.kernels.ref.flash_attention_ref``, which is also what the kernel
is checked against on the card.

Semantics (both versions): scores ``q.k * scale`` in f32 (scale
``d ** -0.5`` unless given), then ``softcap * tanh(s / softcap)`` when
``softcap > 0``, then the causal / sliding-window mask (key s is seen by
query t when ``t - window < s <= t``) with masked scores ``-1e30``, a
softmax over keys and the product with V; the output has q's dtype.
"""

from __future__ import annotations

from typing import Optional

import torch

from ._build import check_status, load

__all__ = ["flash_attention", "flash_attention_plain",
           "flash_attention_plain_gqa", "GLOBAL_WINDOW", "HEAD_DIMS",
           "DTYPE_CODES"]

# a window no sequence reaches: causal attention over every earlier key
GLOBAL_WINDOW = 1 << 30
# head dims the kernel is instantiated for
HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor,
                          causal_window: int = GLOBAL_WINDOW,
                          softcap: float = 0.0,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Plain materialized-scores attention. q, k, v: [B, H, T, d] (KV
    heads already broadcast to H). Returns [B, H, T, d] in q's dtype."""
    T, d = q.shape[2], q.shape[3]
    sc = d ** -0.5 if scale is None else scale
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sc
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    pos = torch.arange(T, device=q.device)
    q_pos, k_pos = pos[:, None], pos[None, :]
    mask = (k_pos <= q_pos) & (k_pos > q_pos - causal_window)
    s = torch.where(mask, s, torch.tensor(-1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def flash_attention_plain_gqa(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              causal_window: int = GLOBAL_WINDOW,
                              softcap: float = 0.0,
                              scale: Optional[float] = None) -> torch.Tensor:
    """:func:`flash_attention_plain` on the kernel's layout: q [B, T, H,
    d], k, v [B, T, Hk, d] (KV heads repeated to H here) -> [B, T, H, d]."""
    group = q.shape[2] // k.shape[2]
    return flash_attention_plain(
        q.transpose(1, 2), k.repeat_interleave(group, dim=2).transpose(1, 2),
        v.repeat_interleave(group, dim=2).transpose(1, 2), causal_window,
        softcap, scale).transpose(1, 2)


def _check(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError("q must be [B, T, H, d] and k, v [B, T, Hk, d] of "
                         f"one shape; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, T, H, d = q.shape
    Hk = k.shape[2]
    if k.shape[0] != B or k.shape[1] != T or k.shape[3] != d:
        raise ValueError(f"k, v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if Hk == 0 or H % Hk:
        raise ValueError(f"{H} query heads do not group over {Hk} KV heads")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    devs = {t.device for t in (q, k, v)}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {devs}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, with a 16-byte aligned base (the kernel's vector
    loads); a view at an odd offset is copied."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal_window: int = GLOBAL_WINDOW,
                    softcap: float = 0.0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Causal attention with grouped-query heads.

    q: [B, T, H, d]; k, v: [B, T, Hk, d] with H a multiple of Hk (query
    head h reads KV head ``h // (H // Hk)``). Returns [B, T, H, d] in q's
    dtype. ``causal_window`` (default: global) keeps keys
    ``t - window < s <= t``; ``softcap > 0`` caps the scores; ``scale``
    defaults to ``d ** -0.5``. On the card: bf16 or f32, d in
    :data:`HEAD_DIMS`.
    """
    _check(q, k, v)
    B, T, H, d = q.shape
    Hk = k.shape[2]
    window = int(causal_window)
    if q.device.type == "cpu":
        return flash_attention_plain_gqa(q, k, v, window, float(softcap),
                                         scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    if q.dtype not in DTYPE_CODES or d not in HEAD_DIMS:
        raise ValueError(f"the kernel takes bf16 or f32 with head dim in "
                         f"{HEAD_DIMS}; got {q.dtype}, d = {d}")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    sc = d ** -0.5 if scale is None else float(scale)
    rc = load("flash_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        DTYPE_CODES[q.dtype], B, T, H, Hk, d, window, float(softcap), sc,
        torch.cuda.current_stream().cuda_stream)
    check_status(rc, "flash_attention")
    return out
