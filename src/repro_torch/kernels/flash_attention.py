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
:func:`flash_attention` runs through :class:`FlashAttention`. Its
forward is the same launch (the plain version on the CPU) and also
writes each row's logsumexp. Its backward, :func:`flash_attention_bwd`,
launches the hand-written kernel in ``csrc/flash_attention_bwd.cu`` on a
CUDA tensor (from the saved output and logsumexp, each of the five
products formed once: dK and dV per KV head, each key tile's part of dQ
added into f32 tiles in key order, so two runs give the same bits) and
runs :func:`flash_attention_bwd_plain` on a CPU one: a recompute one
block of queries at a time (only the keys the block's causal window
reaches), so the [T, T] scores never exist at once. The JAX package has
no backward kernel: it differentiates its plain ``blockwise_sdpa``.

On a ``meta`` tensor (the dry run) both directions launch nothing and
run no plain version: they return outputs of the right shapes and add
the kernel's work (``roofline.flash_work``, ``roofline.flash_bwd_work``)
to ``_build.count_work``, as a launch on the card does.
"""

from __future__ import annotations

from typing import Optional

import torch

from ._build import check_status, count_work, load
from .roofline import flash_bwd_work, flash_work

__all__ = ["flash_attention", "flash_attention_fwd", "flash_attention_plain",
           "flash_attention_plain_gqa", "flash_attention_bwd",
           "flash_attention_bwd_plain", "FlashAttention", "GLOBAL_WINDOW",
           "HEAD_DIMS", "DTYPE_CODES", "BWD_Q_CHUNK"]

# a window no sequence reaches: causal attention over every earlier key
GLOBAL_WINDOW = 1 << 30
# head dims the kernel is instantiated for
HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# queries per block of the plain backward's recompute
BWD_Q_CHUNK = 512
# the backward kernel's lse and D scratch: positions padded to this
BWD_PAD = 64


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor,
                          causal_window: int = GLOBAL_WINDOW,
                          softcap: float = 0.0,
                          scale: Optional[float] = None,
                          return_lse: bool = False):
    """Plain materialized-scores attention. q, k, v: [B, H, T, d] (KV
    heads already broadcast to H). Returns [B, H, T, d] in q's dtype and,
    with ``return_lse``, each row's logsumexp of its masked, capped f32
    scores, [B, H, T] f32."""
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
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
    return (out, torch.logsumexp(s, dim=-1)) if return_lse else out


def flash_attention_plain_gqa(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              causal_window: int = GLOBAL_WINDOW,
                              softcap: float = 0.0,
                              scale: Optional[float] = None,
                              return_lse: bool = False):
    """:func:`flash_attention_plain` on the kernel's layout: q [B, T, H,
    d], k, v [B, T, Hk, d] (KV heads repeated to H here) -> [B, T, H, d]
    (and, with ``return_lse``, the logsumexp [B, H, T] f32)."""
    group = q.shape[2] // k.shape[2]
    res = flash_attention_plain(
        q.transpose(1, 2), k.repeat_interleave(group, dim=2).transpose(1, 2),
        v.repeat_interleave(group, dim=2).transpose(1, 2), causal_window,
        softcap, scale, return_lse)
    if return_lse:
        return res[0].transpose(1, 2), res[1]
    return res.transpose(1, 2)


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


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, dout: torch.Tensor,
                              causal_window: int = GLOBAL_WINDOW,
                              softcap: float = 0.0,
                              scale: Optional[float] = None,
                              q_chunk: int = BWD_Q_CHUNK,
                              out: Optional[torch.Tensor] = None,
                              lse: Optional[torch.Tensor] = None
                              ) -> tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """(dq, dk, dv) of :func:`flash_attention_plain_gqa` for the output
    gradient ``dout`` ([B, T, H, d]), in the inputs' dtypes, summed in
    f32. Blocks of ``q_chunk`` queries recompute their probabilities P
    against the keys their window reaches, then dV += Pᵀ·dO, dP = dO·Vᵀ,
    dS = P ∘ (dP − D) (times 1 − tanh² under a softcap), dQ = dS·K·scale
    and dK += dSᵀ·Q·scale, KV heads shared by their group of query heads.

    Without ``out`` and ``lse``, P is the softmax of the block's scores
    and D = rowsum(P ∘ dP). Given the forward's output ``out`` and its
    row logsumexp ``lse`` ([B, H, T] f32), they are used as the kernel
    uses them: P = exp(s − lse) and D = rowsum(dO ∘ out)."""
    if (out is None) != (lse is None):
        raise ValueError("give both out and lse, or neither")
    B, T, H, d = q.shape
    Hk = k.shape[2]
    group = H // Hk
    sc = d ** -0.5 if scale is None else float(scale)
    window = int(causal_window)
    qc = max(1, min(int(q_chunk), T))
    kf, vf = k.float(), v.float()
    if out is not None:
        # [B, T, H] -> [B, Hk, group, T, 1], as the blocks' scores
        delta = (dout.float() * out.float()).sum(-1).reshape(
            B, T, Hk, group).permute(0, 2, 3, 1)[..., None]
        lse_b = lse.reshape(B, Hk, group, T)[..., None]
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
        s = s.masked_fill_(~seen, -1e30)
        if out is None:
            p = torch.softmax(s, dim=-1)
        else:
            p = s.sub_(lse_b[:, :, :, lo:hi]).exp_()
        del s
        dv[:, k_lo:hi] += torch.einsum("bhgqk,bqhgd->bkhd", p, dob)
        dp = torch.einsum("bqhgd,bkhd->bhgqk", dob, vb)
        ds = dp.sub_(delta[:, :, :, lo:hi] if out is not None else
                     (p * dp).sum(dim=-1, keepdim=True)).mul_(p)
        del p
        if t is not None:
            ds.mul_(t.mul_(t).neg_().add_(1.0))
        dq[:, lo:hi] = torch.einsum("bhgqk,bkhd->bqhgd", ds, kb).reshape(
            B, hi - lo, H, d).mul_(sc)
        dk[:, k_lo:hi] += torch.einsum("bhgqk,bqhgd->bkhd", ds, qb).mul_(sc)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bwd_scratch(B: int, T: int, H: int, Hk: int, d: int, dtype,
                 device) -> tuple[int, Optional[torch.Tensor],
                                  Optional[torch.Tensor]]:
    """The backward kernel's scratch besides lse and D (padded to ``Tp``,
    a multiple of BWD_PAD positions): in bf16 the f32 dQ tiles, [B, H, Tp
    / 64] tiles of 64 queries × d that the key tiles add into in order,
    and zeroed uint32 flags (a tile counter, then a turn count for each
    of the up to two pieces a dQ tile is written in); in f32 with a
    group of heads each head's partial dK and dV."""
    Tp = -(-T // BWD_PAD) * BWD_PAD
    if dtype == torch.bfloat16:
        return (Tp, torch.empty(B * H * Tp * d, dtype=torch.float32,
                                device=device),
                torch.zeros(1 + 2 * B * H * (Tp // BWD_PAD),
                            dtype=torch.int32, device=device))
    if H != Hk:
        return Tp, torch.empty((2, B, T, H, d), dtype=torch.float32,
                               device=device), None
    return Tp, None, None


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor,
                        causal_window: int = GLOBAL_WINDOW,
                        softcap: float = 0.0,
                        scale: Optional[float] = None,
                        q_chunk: int = BWD_Q_CHUNK
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`flash_attention` for the output gradient
    ``dout``, from the forward's ``out`` and row logsumexp ``lse`` ([B,
    H, T] f32). The launch on a card tensor (bf16 or f32, d in
    :data:`HEAD_DIMS`; ``q_chunk`` is not read), the plain version
    (:func:`flash_attention_bwd_plain` with ``out`` and ``lse``, blocks of
    ``q_chunk`` queries) on a CPU one, outputs of the right shapes on a
    meta one."""
    _check(q, k, v)
    B, T, H, d = q.shape
    Hk = k.shape[2]
    window = int(causal_window)
    if dout.shape != q.shape or out.shape != q.shape or \
            lse.shape != (B, H, T):
        raise ValueError(f"dout and out must be {tuple(q.shape)} and lse "
                         f"{(B, H, T)}; got {tuple(dout.shape)}, "
                         f"{tuple(out.shape)}, {tuple(lse.shape)}")
    if dout.dtype != q.dtype or out.dtype != q.dtype or \
            lse.dtype != torch.float32:
        raise ValueError(f"dout and out must be {q.dtype} and lse float32; "
                         f"got {dout.dtype}, {out.dtype}, {lse.dtype}")
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, dout, window, softcap,
                                         scale, q_chunk, out=out, lse=lse)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention_bwd runs on cuda, cpu or meta, "
                         f"not {q.device}")
    if q.dtype not in DTYPE_CODES or d not in HEAD_DIMS:
        raise ValueError(f"the kernel takes bf16 or f32 with head dim in "
                         f"{HEAD_DIMS}; got {q.dtype}, d = {d}")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out, dout, lse = _aligned(out), _aligned(dout), _aligned(lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if dq.numel() == 0:
        return dq, dk, dv
    nbytes, ops = flash_bwd_work(B, T, H, Hk, d, window, q.element_size())
    if q.device.type == "meta":
        count_work("flash_attention_bwd", ops, nbytes)
        return dq, dk, dv
    Tp, scratch, sync = _bwd_scratch(B, T, H, Hk, d, q.dtype, q.device)
    rows = torch.empty((2, B, H, Tp), dtype=torch.float32, device=q.device)
    sc = d ** -0.5 if scale is None else float(scale)
    rc = load("flash_attention_bwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), rows[0].data_ptr(), rows[1].data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        None if sync is None else sync.data_ptr(), DTYPE_CODES[q.dtype], B,
        T, H, Hk, d, window, float(softcap), sc,
        torch.cuda.current_stream().cuda_stream)
    check_status(rc, "flash_attention_bwd")
    count_work("flash_attention_bwd", ops, nbytes)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """:func:`flash_attention` with a gradient: the forward is the kernel
    launch (the plain version on the CPU) with the row logsumexp kept,
    the backward :func:`flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal_window, softcap, scale, q_chunk):
        out, lse = flash_attention_fwd(q, k, v, causal_window, softcap,
                                       scale, want_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal_window, softcap, scale, q_chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, *ctx.args)
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
    the output carries :class:`FlashAttention`'s gradient (on the CPU,
    its plain recompute takes ``bwd_q_chunk`` queries at a time).
    """
    _check(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, int(causal_window),
                                    float(softcap), scale, int(bwd_q_chunk))
    return flash_attention_fwd(q, k, v, int(causal_window), float(softcap),
                               scale)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        window: int = GLOBAL_WINDOW, softcap: float = 0.0,
                        scale: Optional[float] = None,
                        want_lse: bool = False):
    """The forward alone, without a gradient (:class:`FlashAttention`
    wraps it): the launch on a card tensor, the plain version on a CPU
    one, an output of the right shape on a meta one. With ``want_lse``,
    also each row's logsumexp, [B, H, T] f32, as the backward takes it
    (serving asks for none, and the kernel then writes none)."""
    B, T, H, d = q.shape
    Hk = k.shape[2]
    if q.device.type == "cpu":
        return flash_attention_plain_gqa(q, k, v, window, softcap, scale,
                                         want_lse)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention runs on cuda, cpu or meta, not "
                         f"{q.device}")
    if q.dtype not in DTYPE_CODES or d not in HEAD_DIMS:
        raise ValueError(f"the kernel takes bf16 or f32 with head dim in "
                         f"{HEAD_DIMS}; got {q.dtype}, d = {d}")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32,
                      device=q.device) if want_lse else None
    done = (out, lse) if want_lse else out
    if out.numel() == 0:
        return done
    nbytes, ops = flash_work(B, T, H, Hk, d, window, q.element_size())
    if q.device.type == "meta":
        count_work("flash_attention", ops, nbytes)
        return done
    sc = d ** -0.5 if scale is None else float(scale)
    rc = load("flash_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), DTYPE_CODES[q.dtype], B, T,
        H, Hk, d, window, float(softcap), sc,
        torch.cuda.current_stream().cuda_stream)
    check_status(rc, "flash_attention")
    count_work("flash_attention", ops, nbytes)
    return done
