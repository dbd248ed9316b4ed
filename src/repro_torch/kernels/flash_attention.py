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

Gradients: when grad is enabled and an input requires it,
:func:`flash_attention` runs through :class:`FlashAttention`, whose
forward is the same launch (the plain version on the CPU) and whose
backward, :func:`flash_attention_bwd`, is plain PyTorch: it recomputes
the plain attention one block of queries at a time (only the keys the
block's causal window reaches) and applies the softmax's gradient, so
the [T, T] scores never exist at once. The JAX package has no backward
kernel either: it differentiates its plain ``blockwise_sdpa``.

On a ``meta`` tensor (the dry run) the forward launches nothing and runs
no plain version: it returns an output of the right shape and adds the
kernel's work (``roofline.flash_work``) to ``_build.count_work``, as a
launch on the card does.
"""

from __future__ import annotations

from typing import Optional

import torch

from ._build import check_status, count_work, load
from .roofline import flash_work

__all__ = ["flash_attention", "flash_attention_plain",
           "flash_attention_plain_gqa", "flash_attention_bwd",
           "FlashAttention", "GLOBAL_WINDOW", "HEAD_DIMS", "DTYPE_CODES",
           "BWD_Q_CHUNK"]

# a window no sequence reaches: causal attention over every earlier key
GLOBAL_WINDOW = 1 << 30
# head dims the kernel is instantiated for
HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# queries per block of the backward's recompute
BWD_Q_CHUNK = 512


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


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        dout: torch.Tensor,
                        causal_window: int = GLOBAL_WINDOW,
                        softcap: float = 0.0,
                        scale: Optional[float] = None,
                        q_chunk: int = BWD_Q_CHUNK
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`flash_attention_plain_gqa` for the output
    gradient ``dout`` ([B, T, H, d]), in the inputs' dtypes, summed in
    f32. Blocks of ``q_chunk`` queries recompute their probabilities P
    against the keys their window reaches, then dV += Pᵀ·dO, dP = dO·Vᵀ,
    dS = P ∘ (dP − rowsum(P ∘ dP)) (times 1 − tanh² under a softcap),
    dQ = dS·K·scale and dK += dSᵀ·Q·scale, KV heads shared by their
    group of query heads."""
    B, T, H, d = q.shape
    Hk = k.shape[2]
    group = H // Hk
    sc = d ** -0.5 if scale is None else float(scale)
    window = int(causal_window)
    qc = max(1, min(int(q_chunk), T))
    kf, vf = k.float(), v.float()
    dq = torch.empty((B, T, H, d), dtype=torch.float32, device=q.device)
    dk = torch.zeros((B, T, Hk, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros((B, T, Hk, d), dtype=torch.float32, device=q.device)
    for lo in range(0, T, qc):
        hi = min(lo + qc, T)
        k_lo = max(0, lo - window + 1)         # first key the block sees
        qb = q[:, lo:hi].float().reshape(B, hi - lo, Hk, group, d)
        dob = dout[:, lo:hi].float().reshape(B, hi - lo, Hk, group, d)
        kb, vb = kf[:, k_lo:hi], vf[:, k_lo:hi]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qb, kb).mul_(sc)
        t = None
        if softcap > 0:
            t = s.div_(softcap).tanh_()
            s = t * softcap
        q_pos = torch.arange(lo, hi, device=q.device)[:, None]
        k_pos = torch.arange(k_lo, hi, device=q.device)[None, :]
        seen = (k_pos <= q_pos) & (k_pos > q_pos - window)
        p = torch.softmax(s.masked_fill_(~seen, -1e30), dim=-1)
        del s
        dv[:, k_lo:hi] += torch.einsum("bhgqk,bqhgd->bkhd", p, dob)
        dp = torch.einsum("bqhgd,bkhd->bhgqk", dob, vb)
        ds = dp.sub_((p * dp).sum(dim=-1, keepdim=True)).mul_(p)
        del p
        if t is not None:
            ds.mul_(t.mul_(t).neg_().add_(1.0))
        dq[:, lo:hi] = torch.einsum("bhgqk,bkhd->bqhgd", ds, kb).reshape(
            B, hi - lo, H, d).mul_(sc)
        dk[:, k_lo:hi] += torch.einsum("bhgqk,bqhgd->bkhd", ds, qb).mul_(sc)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttention(torch.autograd.Function):
    """:func:`flash_attention` with a gradient: the forward is the kernel
    launch (the plain version on the CPU), the backward
    :func:`flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal_window, softcap, scale, q_chunk):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal_window, softcap, scale, q_chunk)
        return _forward(q, k, v, causal_window, softcap, scale)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, dout, *ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal_window: int = GLOBAL_WINDOW,
                    softcap: float = 0.0,
                    scale: Optional[float] = None,
                    bwd_q_chunk: int = BWD_Q_CHUNK) -> torch.Tensor:
    """Causal attention with grouped-query heads.

    q: [B, T, H, d]; k, v: [B, T, Hk, d] with H a multiple of Hk (query
    head h reads KV head ``h // (H // Hk)``). Returns [B, T, H, d] in q's
    dtype. ``causal_window`` (default: global) keeps keys
    ``t - window < s <= t``; ``softcap > 0`` caps the scores; ``scale``
    defaults to ``d ** -0.5``. On the card: bf16 or f32, d in
    :data:`HEAD_DIMS`. When grad is enabled and an input requires it,
    the output carries :class:`FlashAttention`'s gradient, whose
    recompute takes ``bwd_q_chunk`` queries at a time.
    """
    _check(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, int(causal_window),
                                    float(softcap), scale, int(bwd_q_chunk))
    return _forward(q, k, v, int(causal_window), float(softcap), scale)


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             window: int, softcap: float,
             scale: Optional[float]) -> torch.Tensor:
    """The launch on a card tensor, the plain version on a CPU one, an
    output of the right shape on a meta one (no gradient:
    :class:`FlashAttention` wraps it)."""
    B, T, H, d = q.shape
    Hk = k.shape[2]
    if q.device.type == "cpu":
        return flash_attention_plain_gqa(q, k, v, window, softcap, scale)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention runs on cuda, cpu or meta, not "
                         f"{q.device}")
    if q.dtype not in DTYPE_CODES or d not in HEAD_DIMS:
        raise ValueError(f"the kernel takes bf16 or f32 with head dim in "
                         f"{HEAD_DIMS}; got {q.dtype}, d = {d}")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    nbytes, ops = flash_work(B, T, H, Hk, d, window, q.element_size())
    if q.device.type == "meta":
        count_work("flash_attention", ops, nbytes)
        return out
    sc = d ** -0.5 if scale is None else float(scale)
    rc = load("flash_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        DTYPE_CODES[q.dtype], B, T, H, Hk, d, window, float(softcap), sc,
        torch.cuda.current_stream().cuda_stream)
    check_status(rc, "flash_attention")
    count_work("flash_attention", ops, nbytes)
    return out
