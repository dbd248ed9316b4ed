"""One xDeepFM CIN layer: the outer product fused with the compression.

    out[b, h, d] = sum_{i, j} w[h, i, j] * xk[b, i, d] * x0[b, j, d]

Port of ``repro.kernels.cin.cin_layer_pallas``. On a CUDA tensor
:func:`cin_layer` launches the hand-written kernel in ``csrc/cin.cu``
(one GEMM on TF32 tensor cores in three products, hi·hi + hi·lo + lo·hi,
summed in f32; the [B, Hp, F, D] outer product never reaches device
memory); on a CPU tensor it runs :func:`cin_layer_plain`, the port of
the reference oracle ``repro.kernels.ref.cin_layer_ref``, which is also
what the kernel is checked against on the card.

The kernel reads w as :func:`kernel_weights` packs it (split into TF32
hi and lo parts, laid out as its tensor cores read it), packed once per
weight tensor and version by :func:`packed_weights`: a weight updated in
place (``copy_``, ``add_``, ...) moves its version and is packed anew.

Gradients: when grad is enabled and an input requires it,
:func:`cin_layer` runs through :class:`CinLayer`. With g = dL/dout, two
of the three gradients are CIN layers themselves, launched on permuted
weights (each a view, packed anew per call):

    dxk = cin_layer(g, x0, w.permute(1, 0, 2))     # [B, Hp, D]
    dx0 = cin_layer(g, xk, w.permute(2, 0, 1))     # [B, F, D]

and dw[h, i, j] = Σ_{b,d} g[b,h,d]·xk[b,i,d]·x0[b,j,d] is a plain GEMM
over batch chunks (:func:`cin_weight_grad`), as the JAX package's is
plain XLA: no [B, Hp, F, D] tensor exists beyond one chunk.

On a ``meta`` tensor (the dry run) a layer, the backward's two included,
packs its weights and takes its split accumulators as on the card (at
the H100's ``roofline.SMS``), so that the dry run sees the memory a
launch holds, then launches nothing and runs no plain version: it
returns an output of the right shape and adds the layer's work
(``roofline.cin_work``) to ``_build.count_work``, as a launch does.
"""

from __future__ import annotations

import weakref

import torch

from ._build import check_status, count_work, load, zeroed_counters
from .roofline import SMS, cin_work

__all__ = ["cin_layer", "cin_layer_plain", "cin_weight_grad", "CinLayer",
           "kernel_weights", "packed_weights", "cin_tile", "cin_splits",
           "max_fields", "DTYPE_CODES"]

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the kernel's product widths N (csrc/cin.cu): a width of the configs is
# one tile that fits H (H = 200 -> N = 200, csrc/cin.cu instantiates it),
# any other H runs tiles of the general width
FITTED_WIDTHS = (200,)
GENERAL_WIDTH = 64
K_TILE = 32           # K (= i * Fp + j) per pipeline stage
TILE_COLS = 128       # columns c = b * D + d per CTA
# a K split leaves each CTA at least this many K tiles
MIN_SPLIT_TILES = 8
# and at most this many: the forward's longest K (Hp = 200 by Fp = 40,
# 250 tiles) in one CTA. The tensor cores' f32 accumulation loses more
# the longer it runs (about K · 3e-9 of the result), so the backward's
# dx0, whose K = H · Hp is 40,000, is cut into ranges no longer than
# that and their partials summed in f32 on the CUDA cores
MAX_SPLIT_TILES = 256
# the kernel's shared memory (csrc/cin.cu smem_bytes): at least two
# stages of packed weights and the CTA's x0 rows, within an H100 CTA's
# opt-in
SMEM_MAX = 232448
MIN_STAGES = 2

# bound on outer-product entries per chunk of the plain version (memory)
_PLAIN_CHUNK = 1 << 27


def cin_layer_plain(xk: torch.Tensor, x0: torch.Tensor,
                    w: torch.Tensor) -> torch.Tensor:
    """Plain version: the outer product z[b, i, j, d] in f32, then the
    contraction with w, in chunks of batch rows; out in xk's dtype."""
    B, Hp, D = xk.shape
    F = x0.shape[1]
    out = torch.empty((B, w.shape[0], D), dtype=xk.dtype, device=xk.device)
    step = max(1, _PLAIN_CHUNK // max(1, Hp * F * D))
    wf = w.float()
    for lo in range(0, B, step):
        z = torch.einsum("bid,bjd->bijd", xk[lo:lo + step].float(),
                         x0[lo:lo + step].float())
        out[lo:lo + step] = torch.einsum("hij,bijd->bhd", wf, z).to(xk.dtype)
    return out


def _round_up(x: int, q: int) -> int:
    return -(-x // q) * q


def cin_weight_grad(g: torch.Tensor, xk: torch.Tensor,
                    x0: torch.Tensor) -> torch.Tensor:
    """dw [H, Hp, F] in f32 of one layer from its output gradient g
    [B, H, D]: Σ_{b,d} g[b,h,d]·xk[b,i,d]·x0[b,j,d], one GEMM per chunk
    of batch rows, gᵀ [H, (b, d)] times z [(b, d), (i, j)] with z formed
    for the chunk only (at most ``_PLAIN_CHUNK`` entries)."""
    B, H, D = g.shape
    Hp, F = xk.shape[1], x0.shape[1]
    dw = torch.zeros((H, Hp * F), dtype=torch.float32, device=g.device)
    step = max(1, _PLAIN_CHUNK // max(1, Hp * F * D))
    for lo in range(0, B, step):
        xt = xk[lo:lo + step].float().transpose(1, 2).contiguous()
        x0t = x0[lo:lo + step].float().transpose(1, 2).contiguous()
        z = (xt[..., :, None] * x0t[..., None, :]).reshape(-1, Hp * F)
        gt = g[lo:lo + step].float().transpose(1, 2).reshape(-1, H)
        dw.addmm_(gt.t(), z)
    return dw.view(H, Hp, F)


def cin_tile(H: int) -> int:
    """The kernel's product width N for H output rows: round_up(H, 8)
    where the kernel has that width, else the general width (H in tiles
    of it)."""
    n = _round_up(H, 8)
    return n if n in FITTED_WIDTHS else GENERAL_WIDTH


def max_fields(H: int) -> int:
    """The most x0 rows F the kernel takes for H output rows: its CTA
    stages 128 columns of x0 rows (F padded to a multiple of 8, plus 4)
    in shared memory beside at least two stages of packed weights."""
    nb = cin_tile(H)
    weights = MIN_STAGES * 2 * nb * K_TILE * 4 + 2 * 4 * 8
    return ((SMEM_MAX - weights) // (TILE_COLS * 4) - 4) // 8 * 8


def cin_splits(cols: int, h_tiles: int, k_tiles: int, sms: int) -> int:
    """Ranges K is split into, so that a batch of few columns still
    gives the card's ``sms`` SMs a CTA each: as many as fit in one wave
    beside the column and h tiles, each of at least MIN_SPLIT_TILES K
    tiles; and so that no range is longer than MAX_SPLIT_TILES."""
    tiles = -(-cols // TILE_COLS) * h_tiles
    fill = min(sms // max(tiles, 1), k_tiles // MIN_SPLIT_TILES)
    return max(1, fill, -(-k_tiles // MAX_SPLIT_TILES))


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 ``x`` as hi + lo: hi rounded to TF32 (nearest, ties away from
    zero: the low 13 mantissa bits clear), lo = x - hi, exact."""
    bits = x.contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return hi, x - hi


def kernel_weights(w: torch.Tensor) -> torch.Tensor:
    """w [H, Hp, F] as the kernel's tensor cores read it: in f32, F
    padded with zero weights to Fp (a multiple of 8, so a k-step of 8
    holds one i), K = i * Fp + j padded to K_TILE, H padded to the
    product width N (:func:`cin_tile`), and each (h tile, K tile) block
    one contiguous stage of [hi, lo][N / 8][K_TILE / 4][8 h][4 k] (8 x 4
    core matrices, K-major). Shape [h tiles, K tiles, 2, N / 8,
    K_TILE / 4, 8, 4]."""
    H, Hp, F = w.shape
    nb, fp = cin_tile(H), _round_up(F, 8)
    ht, kt = -(-H // nb), -(-Hp * fp // K_TILE)
    wf = torch.zeros((H, Hp, fp), dtype=torch.float32, device=w.device)
    wf[..., :F] = w
    wp = torch.zeros((ht * nb, kt * K_TILE), dtype=torch.float32,
                     device=w.device)
    wp[:H, :Hp * fp] = wf.view(H, Hp * fp)
    blocks = wp.view(ht, nb // 8, 8, kt, K_TILE // 4, 4).permute(
        0, 3, 1, 4, 2, 5)
    return torch.stack(tf32_split(blocks.contiguous()), dim=2)


# id(w) -> (weakref to w, w's version, its packing)
_PACKED: dict = {}


def packed_weights(w: torch.Tensor) -> torch.Tensor:
    """:func:`kernel_weights` of ``w``, packed once per tensor and
    repacked after an in-place update (``w._version`` moves)."""
    hit = _PACKED.get(id(w))
    if hit is not None and hit[0]() is w and hit[1] == w._version:
        return hit[2]
    wp = kernel_weights(w)
    key = id(w)
    _PACKED[key] = (weakref.ref(w, lambda _, key=key: _PACKED.pop(key,
                                                                  None)),
                    w._version, wp)
    return wp


def _check(xk, x0, w):
    if xk.ndim != 3 or x0.ndim != 3 or w.ndim != 3:
        raise ValueError("xk must be [B, Hp, D], x0 [B, F, D] and w "
                         f"[H, Hp, F]; got {tuple(xk.shape)}, "
                         f"{tuple(x0.shape)}, {tuple(w.shape)}")
    B, Hp, D = xk.shape
    if x0.shape[0] != B or x0.shape[2] != D or w.shape[1:] != (
            Hp, x0.shape[1]):
        raise ValueError(f"shapes do not chain: xk {tuple(xk.shape)}, x0 "
                         f"{tuple(x0.shape)}, w {tuple(w.shape)}")
    if not (xk.dtype == x0.dtype == w.dtype):
        raise ValueError(f"dtypes differ: {xk.dtype}, {x0.dtype}, {w.dtype}")
    devs = {t.device for t in (xk, x0, w)}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {devs}")


class CinLayer(torch.autograd.Function):
    """:func:`cin_layer` with a gradient: the forward is the kernel
    launch (the plain version on the CPU); the backward launches the
    layer twice on permuted weights for dxk and dx0 and runs
    :func:`cin_weight_grad` for dw."""

    @staticmethod
    def forward(ctx, xk, x0, w):
        ctx.save_for_backward(xk, x0, w)
        return _forward(xk, x0, w)

    @staticmethod
    def backward(ctx, g):
        xk, x0, w = ctx.saved_tensors
        need_xk, need_x0, need_w = ctx.needs_input_grad
        g = g.contiguous()
        dxk = cin_layer(g, x0, w.permute(1, 0, 2)) if need_xk else None
        dx0 = cin_layer(g, xk, w.permute(2, 0, 1)) if need_x0 else None
        dw = cin_weight_grad(g, xk, x0).to(w.dtype) if need_w else None
        return dxk, dx0, dw


def cin_layer(xk: torch.Tensor, x0: torch.Tensor,
              w: torch.Tensor) -> torch.Tensor:
    """xk: [B, Hp, D]; x0: [B, F, D]; w: [H, Hp, F] -> [B, H, D] in xk's
    dtype, summed in f32. On the card: f32 or bf16, F at most
    :func:`max_fields` (H). When grad is enabled and an input requires
    it, the output carries :class:`CinLayer`'s gradient."""
    _check(xk, x0, w)
    if torch.is_grad_enabled() and (xk.requires_grad or x0.requires_grad
                                    or w.requires_grad):
        return CinLayer.apply(xk, x0, w)
    return _forward(xk, x0, w)


def _forward(xk: torch.Tensor, x0: torch.Tensor,
             w: torch.Tensor) -> torch.Tensor:
    """The launch on a card tensor, the plain version on a CPU one, an
    output of the right shape on a meta one (no gradient:
    :class:`CinLayer` wraps it)."""
    if xk.device.type == "cpu":
        return cin_layer_plain(xk, x0, w)
    meta = xk.device.type == "meta"
    if xk.device.type != "cuda" and not meta:
        raise ValueError(f"cin_layer runs on cuda, cpu or meta, not "
                         f"{xk.device}")
    if xk.dtype not in DTYPE_CODES:
        raise ValueError(f"the kernel takes f32 or bf16, not {xk.dtype}")
    B, Hp, D = xk.shape
    F, H = x0.shape[1], w.shape[0]
    if F > max_fields(H):
        raise ValueError(f"the kernel stages at most {max_fields(H)} x0 "
                         f"rows for H = {H} in shared memory; x0 has "
                         f"F = {F}")
    xk, x0 = xk.contiguous(), x0.contiguous()
    out = torch.empty((B, H, D), dtype=xk.dtype, device=xk.device)
    if out.numel() == 0:
        return out
    wp = packed_weights(w)
    ht, kt = wp.shape[0], wp.shape[1]
    nb = cin_tile(H)
    cols = B * D
    sms = (SMS if meta else torch.cuda.get_device_properties(
        xk.device).multi_processor_count)
    splits = cin_splits(cols, ht, kt, sms)
    tiles = -(-cols // TILE_COLS) * ht
    # the split CTAs' partial accumulators and their arrival counters
    partial = torch.empty((tiles * splits * TILE_COLS * nb if splits > 1
                           else 0,), dtype=torch.float32, device=xk.device)
    nbytes, ops = cin_work(B, H, Hp, F, D, xk.element_size())
    if meta:
        count_work("cin", ops, nbytes)
        return out
    rc = load("cin")(xk.data_ptr(), x0.data_ptr(), wp.data_ptr(),
                     out.data_ptr(), DTYPE_CODES[xk.dtype], B, Hp, F, H, nb,
                     D, kt, splits, partial.data_ptr(),
                     zeroed_counters("cin", xk.device, tiles).data_ptr(),
                     torch.cuda.current_stream().cuda_stream)
    check_status(rc, "cin")
    count_work("cin", ops, nbytes)
    return out
