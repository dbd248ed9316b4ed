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
:func:`cin_layer` runs through :class:`CinLayer`. With g = dL/dout:

    dxk = cin_layer(g, x0, w.permute(1, 0, 2))     # [B, Hp, D], a layer
    dx0 = cin_dx0(g, xk, w)                        # [B, F, D]
    dw  = cin_weight_grad(g, xk, x0)               # [H, Hp, F], f32

dxk is the layer itself on a permuted weight (a view, packed anew per
call). dx0[b,j,d] = Σ_i xk[b,i,d]·Σ_h g[b,h,d]·w[h,i,j] and dw[h,i,j] =
Σ_{b,d} g[b,h,d]·xk[b,i,d]·x0[b,j,d] launch their own kernels in
``csrc/cin_bwd.cu`` (three TF32 products, as the forward) on a CUDA
tensor, and run :func:`cin_dx0_plain` and :func:`cin_weight_grad_plain`
(f32 contractions over batch chunks: no [B, Hp, F, D] tensor beyond one
chunk) on a CPU one. The JAX package differentiates its einsums in XLA.
The dx0 kernel reads w as :func:`dx0_weights` packs it (cached per
tensor and version, as the forward's); a pre-pass inside each launch
packs g (and, for dw, xk and x0) as :func:`dx0_operands` and
:func:`dw_operands` lay them out, into scratch the wrapper allocates.

On a ``meta`` tensor (the dry run) each kernel packs its weights and
takes its scratch and split accumulators as on the card (at the H100's
``roofline.SMS``), so that the dry run sees the memory a launch holds,
then launches nothing and runs no plain version: it returns an output of
the right shape and adds its work (``roofline.cin_work``,
``roofline.cin_bwd_work``) to ``_build.count_work``, as a launch does.
"""

from __future__ import annotations

import weakref

import torch

from ._build import check_status, count_work, load, zeroed_counters
from .roofline import SMS, cin_bwd_work, cin_work

__all__ = ["cin_layer", "cin_layer_plain", "cin_weight_grad",
           "cin_weight_grad_plain", "cin_dx0", "cin_dx0_plain", "CinLayer",
           "kernel_weights", "packed_weights", "dx0_weights",
           "packed_dx0_weights", "dw_operands", "dx0_operands", "cin_tile",
           "cin_splits", "dw_splits", "dx0_splits", "dx0_fields",
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
# the longer it runs (about K · 3e-9 of the result), so the dw kernel,
# whose K is the B · D columns (655,360 at train_batch), is cut into
# ranges no longer than that and their partials summed in f32 on the
# CUDA cores
MAX_SPLIT_TILES = 256
# the dw kernel's CTA tile: 16 i by 8 j (a warpgroup's 64 rows 8 by 8)
DW_I_BLOCK = 16
DW_J_BLOCK = 8
# the dx0 kernel (csrc/cin_bwd.cu): 128 columns c a CTA, g's h in chunks
# of 40 held in shared memory, products of width 200 over a group of
# 200 / Fq values of i, F padded to Fq (F above 200 in blocks of 200)
DX0_TILE = 128
DX0_CHUNK = 40
DX0_WIDTH = 200
DX0_FIELD_WIDTHS = (40, 200)
# a dx0 split leaves each CTA at least this many (chunk, group) units
MIN_SPLIT_UNITS = 8
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


def cin_weight_grad_plain(g: torch.Tensor, xk: torch.Tensor,
                          x0: torch.Tensor) -> torch.Tensor:
    """Plain version of dw [H, Hp, F] in f32 of one layer from its output
    gradient g [B, H, D]: Σ_{b,d} g[b,h,d]·xk[b,i,d]·x0[b,j,d], one GEMM
    per chunk of batch rows, gᵀ [H, (b, d)] times z [(b, d), (i, j)] with
    z formed for the chunk only (at most ``_PLAIN_CHUNK`` entries)."""
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


def cin_dx0_plain(g: torch.Tensor, xk: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """Plain version of dx0 [B, F, D] of one layer from its output
    gradient g [B, H, D]: Σ_i xk[b,i,d]·u[b,i,j,d] with u = Σ_h
    g[b,h,d]·w[h,i,j], in f32 over chunks of batch rows (u of at most
    ``_PLAIN_CHUNK`` entries); in xk's dtype."""
    B, H, D = g.shape
    Hp, F = xk.shape[1], w.shape[2]
    out = torch.empty((B, F, D), dtype=xk.dtype, device=xk.device)
    step = max(1, _PLAIN_CHUNK // max(1, Hp * F * D))
    wf = w.float()
    for lo in range(0, B, step):
        u = torch.einsum("bhd,hij->bijd", g[lo:lo + step].float(), wf)
        out[lo:lo + step] = torch.einsum(
            "bijd,bid->bjd", u, xk[lo:lo + step].float()).to(xk.dtype)
    return out


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


def dw_splits(tiles: int, k_tiles: int, sms: int) -> int:
    """Ranges K is split into, so that few output tiles still give the
    card's ``sms`` SMs a CTA each: as many as fit in one wave beside the
    ``tiles``, each of at least MIN_SPLIT_TILES K tiles; and so that no
    range is longer than MAX_SPLIT_TILES."""
    fill = min(sms // max(tiles, 1), k_tiles // MIN_SPLIT_TILES)
    return max(1, fill, -(-k_tiles // MAX_SPLIT_TILES))


def cin_splits(cols: int, h_tiles: int, k_tiles: int, sms: int) -> int:
    """:func:`dw_splits` of the forward's output tiles: ``cols`` columns
    in tiles of TILE_COLS by ``h_tiles``."""
    return dw_splits(-(-cols // TILE_COLS) * h_tiles, k_tiles, sms)


def dx0_splits(tiles: int, units: int, sms: int) -> int:
    """CTAs the dx0 kernel's (chunk, group) units are split over, so that
    few column tiles still fill the card, each CTA keeping at least
    MIN_SPLIT_UNITS units (its sums are f32 on the CUDA cores: no bound on
    a range's length)."""
    return max(1, min(sms // max(tiles, 1), units // MIN_SPLIT_UNITS))


def dx0_fields(F: int) -> int:
    """The dx0 kernel's padded field count Fq: the least of
    DX0_FIELD_WIDTHS that holds F (200 / Fq values of i fill a product of
    width 200), else the widest, F then running in blocks of it."""
    return next((fq for fq in DX0_FIELD_WIDTHS if F <= fq),
                DX0_FIELD_WIDTHS[-1])


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 ``x`` as hi + lo: hi rounded to TF32 (nearest, ties away from
    zero: the low 13 mantissa bits clear), lo = x - hi, exact."""
    bits = x.contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return hi, x - hi


def _tile_kmajor(m: torch.Tensor, nb: int, kt: int) -> torch.Tensor:
    """m [R, K] as a tensor core's K-major operand: in f32, R padded to
    ``nb`` rows and K to ``kt`` with zeros, each (row tile, K tile) block
    one contiguous stage of [hi, lo][nb / 8][kt / 4][8 r][4 k] (8 x 4
    core matrices). Shape [R tiles, K tiles, 2, nb / 8, kt / 4, 8, 4]."""
    R, K = m.shape
    rt, ktn = -(-R // nb), -(-K // kt)
    full = torch.zeros((rt * nb, ktn * kt), dtype=torch.float32,
                       device=m.device)
    full[:R, :K] = m
    blocks = full.view(rt, nb // 8, 8, ktn, kt // 4, 4).permute(
        0, 3, 1, 4, 2, 5)
    return torch.stack(tf32_split(blocks.contiguous()), dim=2)


def kernel_weights(w: torch.Tensor) -> torch.Tensor:
    """w [H, Hp, F] as the kernel's tensor cores read it: in f32, F
    padded with zero weights to Fp (a multiple of 8, so a k-step of 8
    holds one i), K = i * Fp + j padded to K_TILE, H padded to the
    product width N (:func:`cin_tile`), and each (h tile, K tile) block
    one contiguous stage of [hi, lo][N / 8][K_TILE / 4][8 h][4 k] (8 x 4
    core matrices, K-major). Shape [h tiles, K tiles, 2, N / 8,
    K_TILE / 4, 8, 4]."""
    H, Hp, F = w.shape
    fp = _round_up(F, 8)
    wf = torch.zeros((H, Hp, fp), dtype=torch.float32, device=w.device)
    wf[..., :F] = w
    return _tile_kmajor(wf.view(H, Hp * fp), cin_tile(H), K_TILE)


def dx0_weights(w: torch.Tensor) -> torch.Tensor:
    """w [H, Hp, F] as the dx0 kernel's tensor cores read it: F in
    blocks of Fq fields (:func:`dx0_fields`; one block unless F > 200),
    K = h in chunks of DX0_CHUNK, N = (i, j) over groups of DX0_WIDTH /
    Fq values of i, n = (i - group start) · Fq + j - block start; zero
    past H, Hp and F. Each k-step of 8 h of a (block, chunk, group) is
    one contiguous stage of [hi, lo][N / 8][2][8 n][4 k]. Shape [blocks,
    chunks, groups, DX0_CHUNK / 8, 2, N / 8, 2, 8, 4]."""
    H, Hp, F = w.shape
    fq = dx0_fields(F)
    ig = DX0_WIDTH // fq
    blocks, chunks, groups = -(-F // fq), -(-H // DX0_CHUNK), -(-Hp // ig)
    wm = torch.zeros((groups * ig, blocks * fq, chunks * DX0_CHUNK),
                     dtype=torch.float32, device=w.device)
    wm[:Hp, :F, :H] = w.permute(1, 2, 0)
    wm = wm.view(groups * ig, blocks, fq, -1).transpose(0, 1)
    tiles = _tile_kmajor(wm.reshape(blocks * groups * DX0_WIDTH, -1),
                         DX0_WIDTH, 8)
    return tiles.view(blocks, groups, chunks, DX0_CHUNK // 8, 2,
                      DX0_WIDTH // 8, 2, 8, 4).transpose(1, 2).contiguous()


def _columns(x: torch.Tensor, rb: int) -> torch.Tensor:
    """x [B, R, D] in f32 over the columns c = b · D + d, as the dw
    kernel stages them: [K tiles][R / rb][K_TILE][rb], zeros past R and
    the columns."""
    B, R, D = x.shape
    cols = B * D
    kt, blocks = -(-cols // K_TILE), -(-R // rb)
    full = torch.zeros((kt * K_TILE, blocks * rb), dtype=torch.float32,
                       device=x.device)
    full[:cols, :R] = x.float().permute(0, 2, 1).reshape(cols, R)
    return full.view(kt, K_TILE, blocks, rb).transpose(1, 2).contiguous()


def dw_operands(g: torch.Tensor, xk: torch.Tensor,
                x0: torch.Tensor) -> dict:
    """What the dw kernel's pre-pass writes: ``"g"``, gᵀ [H, B · D] in
    the layout of :func:`kernel_weights` (N = H, K tiles of K_TILE
    columns); ``"xk"`` and ``"x0"``, :func:`_columns` of xk in blocks of
    DW_I_BLOCK rows and of x0 in blocks of DW_J_BLOCK."""
    B, H, D = g.shape
    gm = g.float().permute(1, 0, 2).reshape(H, B * D)
    return {"g": _tile_kmajor(gm, cin_tile(H), K_TILE),
            "xk": _columns(xk, DW_I_BLOCK), "x0": _columns(x0, DW_J_BLOCK)}


def dx0_operands(g: torch.Tensor) -> torch.Tensor:
    """What the dx0 kernel's pre-pass writes: g as [(b, d) columns, H]
    in K-major tiles of DX0_TILE columns by DX0_CHUNK h. Shape [column
    tiles, chunks, 2, DX0_TILE / 8, DX0_CHUNK / 4, 8, 4]."""
    B, H, D = g.shape
    gm = g.float().permute(0, 2, 1).reshape(B * D, H)
    return _tile_kmajor(gm, DX0_TILE, DX0_CHUNK)


# (kind, id(w)) -> (weakref to w, w's version, its packing)
_PACKED: dict = {}


def _cached(kind: str, w: torch.Tensor, pack) -> torch.Tensor:
    key = (kind, id(w))
    hit = _PACKED.get(key)
    if hit is not None and hit[0]() is w and hit[1] == w._version:
        return hit[2]
    wp = pack(w)
    _PACKED[key] = (weakref.ref(w, lambda _, key=key: _PACKED.pop(key,
                                                                  None)),
                    w._version, wp)
    return wp


def packed_weights(w: torch.Tensor) -> torch.Tensor:
    """:func:`kernel_weights` of ``w``, packed once per tensor and
    repacked after an in-place update (``w._version`` moves)."""
    return _cached("cin", w, kernel_weights)


def packed_dx0_weights(w: torch.Tensor) -> torch.Tensor:
    """:func:`dx0_weights` of ``w``, cached as :func:`packed_weights`."""
    return _cached("cin_dx0", w, dx0_weights)


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


def _check_grad(g, xk, t, what: str):
    """g [B, H, D] and xk [B, Hp, D] against x0 [B, F, D] (dw) or w [H,
    Hp, F] (dx0): shapes, one dtype, one device."""
    if g.ndim != 3 or xk.ndim != 3 or t.ndim != 3:
        raise ValueError(f"{what}: g, xk and the third input are 3-d; got "
                         f"{tuple(g.shape)}, {tuple(xk.shape)}, "
                         f"{tuple(t.shape)}")
    B, H, D = g.shape
    ok = xk.shape[0] == B and xk.shape[2] == D and (
        t.shape[0] == B and t.shape[2] == D if what == "cin_dw"
        else t.shape[:2] == (H, xk.shape[1]))
    if not ok:
        raise ValueError(f"{what}: shapes do not chain: g {tuple(g.shape)}, "
                         f"xk {tuple(xk.shape)}, {tuple(t.shape)}")
    if not (g.dtype == xk.dtype == t.dtype):
        raise ValueError(f"{what}: dtypes differ: {g.dtype}, {xk.dtype}, "
                         f"{t.dtype}")
    if len({g.device, xk.device, t.device}) != 1:
        raise ValueError(f"{what}: tensors on different devices")


def _launch_device(t: torch.Tensor, what: str) -> int:
    """SMs the launch plans for (the H100's on meta); raises off the card
    or for a dtype the kernels do not take."""
    if t.device.type not in ("cuda", "meta"):
        raise ValueError(f"{what} runs on cuda, cpu or meta, not {t.device}")
    if t.dtype not in DTYPE_CODES:
        raise ValueError(f"the kernel takes f32 or bf16, not {t.dtype}")
    return (SMS if t.device.type == "meta" else
            torch.cuda.get_device_properties(t.device).multi_processor_count)


def _dw_launch(g, xk, x0) -> tuple[torch.Tensor, dict]:
    """dw by the kernel (on meta, its stand-in), with the operands its
    pre-pass packed (:func:`dw_operands`' layout)."""
    sms = _launch_device(g, "cin_weight_grad")
    B, H, D = g.shape
    Hp, F = xk.shape[1], x0.shape[1]
    g, xk, x0 = g.contiguous(), xk.contiguous(), x0.contiguous()
    dw = torch.empty((H, Hp, F), dtype=torch.float32, device=g.device)
    if dw.numel() == 0 or B * D == 0:
        return dw.zero_(), {}
    nb = cin_tile(H)
    ht, kt = -(-H // nb), -(-B * D // K_TILE)
    ib, jb = -(-Hp // DW_I_BLOCK), -(-F // DW_J_BLOCK)
    tiles = ib * jb * ht
    splits = dw_splits(tiles, kt, sms)
    f32 = {"dtype": torch.float32, "device": g.device}
    ops = {"g": torch.empty((ht, kt, 2, nb // 8, K_TILE // 4, 8, 4), **f32),
           "xk": torch.empty((kt, ib, K_TILE, DW_I_BLOCK), **f32),
           "x0": torch.empty((kt, jb, K_TILE, DW_J_BLOCK), **f32)}
    # each CTA's carry, then its partial: nb / 2 floats of 256 consumer
    # threads
    partial = torch.empty((tiles * splits * 128 * nb,), **f32)
    nbytes, flops = cin_bwd_work("dw", B, H, Hp, F, D, g.element_size())
    if g.device.type == "meta":
        count_work("cin_dw", flops, nbytes)
        return dw, ops
    rc = load("cin_dw")(g.data_ptr(), xk.data_ptr(), x0.data_ptr(),
                        DTYPE_CODES[g.dtype], B, Hp, F, H, D, nb, kt, splits,
                        ops["g"].data_ptr(), ops["xk"].data_ptr(),
                        ops["x0"].data_ptr(), dw.data_ptr(),
                        partial.data_ptr(),
                        zeroed_counters("cin_dw", g.device, tiles).data_ptr(),
                        torch.cuda.current_stream().cuda_stream)
    check_status(rc, "cin_dw")
    count_work("cin_dw", flops, nbytes)
    return dw, ops


def cin_weight_grad(g: torch.Tensor, xk: torch.Tensor,
                    x0: torch.Tensor) -> torch.Tensor:
    """dw [H, Hp, F] in f32 of one layer from its output gradient g
    [B, H, D]: the kernel on a CUDA tensor (f32 or bf16), the plain
    version on a CPU one, the work counted and nothing launched on a
    meta one."""
    _check_grad(g, xk, x0, "cin_dw")
    if g.device.type == "cpu":
        return cin_weight_grad_plain(g, xk, x0)
    return _dw_launch(g, xk, x0)[0]


def _dx0_launch(g, xk, w) -> tuple[torch.Tensor, torch.Tensor | None]:
    """dx0 by the kernel (on meta, its stand-in), with g as its pre-pass
    packed it (:func:`dx0_operands`' layout)."""
    sms = _launch_device(g, "cin_dx0")
    B, H, D = g.shape
    Hp, F = xk.shape[1], w.shape[2]
    fq = dx0_fields(F)
    g, xk = g.contiguous(), xk.contiguous()
    out = torch.empty((B, F, D), dtype=xk.dtype, device=g.device)
    if out.numel() == 0:
        return out, None
    wb = packed_dx0_weights(w)
    # CTAs a split: (field block, column tile)
    tiles = -(-F // fq) * -(-B * D // DX0_TILE)
    chunks = -(-H // DX0_CHUNK)
    units = chunks * -(-Hp // (DX0_WIDTH // fq))
    splits = dx0_splits(tiles, units, sms)
    f32 = {"dtype": torch.float32, "device": g.device}
    ga = torch.empty((-(-B * D // DX0_TILE), chunks, 2, DX0_TILE // 8,
                      DX0_CHUNK // 4, 8, 4), **f32)
    # each split CTA's partial: fq / 2 floats of 256 consumer threads
    partial = torch.empty((tiles * splits * 128 * fq if splits > 1 else 0,),
                          **f32)
    nbytes, flops = cin_bwd_work("dx0", B, H, Hp, F, D, g.element_size())
    if g.device.type == "meta":
        count_work("cin_dx0", flops, nbytes)
        return out, ga
    rc = load("cin_dx0")(g.data_ptr(), xk.data_ptr(), wb.data_ptr(),
                         out.data_ptr(), DTYPE_CODES[g.dtype], B, Hp, F, H,
                         D, fq, splits, ga.data_ptr(), partial.data_ptr(),
                         zeroed_counters("cin_dx0", g.device,
                                         tiles).data_ptr(),
                         torch.cuda.current_stream().cuda_stream)
    check_status(rc, "cin_dx0")
    count_work("cin_dx0", flops, nbytes)
    return out, ga


def cin_dx0(g: torch.Tensor, xk: torch.Tensor,
            w: torch.Tensor) -> torch.Tensor:
    """dx0 [B, F, D] of one layer from its output gradient g [B, H, D],
    in xk's dtype, summed in f32: the kernel on a CUDA tensor (f32 or
    bf16), the plain version on a CPU one, the work
    counted and nothing launched on a meta one."""
    _check_grad(g, xk, w, "cin_dx0")
    if g.device.type == "cpu":
        return cin_dx0_plain(g, xk, w)
    return _dx0_launch(g, xk, w)[0]


class CinLayer(torch.autograd.Function):
    """:func:`cin_layer` with a gradient: the forward is the kernel
    launch (the plain version on the CPU); the backward launches the
    layer on a permuted weight for dxk, and :func:`cin_dx0` and
    :func:`cin_weight_grad` for dx0 and dw."""

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
        dx0 = cin_dx0(g, xk, w) if need_x0 else None
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
    sms = _launch_device(xk, "cin_layer")
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
    splits = cin_splits(cols, ht, kt, sms)
    tiles = -(-cols // TILE_COLS) * ht
    # the split CTAs' partial accumulators and their arrival counters
    partial = torch.empty((tiles * splits * TILE_COLS * nb if splits > 1
                           else 0,), dtype=torch.float32, device=xk.device)
    nbytes, ops = cin_work(B, H, Hp, F, D, xk.element_size())
    if xk.device.type == "meta":
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
