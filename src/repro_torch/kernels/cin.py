"""One xDeepFM CIN layer: the outer product fused with the compression.

    out[b, h, d] = sum_{i, j} w[h, i, j] * xk[b, i, d] * x0[b, j, d]

Port of ``repro.kernels.cin.cin_layer_pallas``. On a CUDA tensor
:func:`cin_layer` launches the hand-written kernel in ``csrc/cin.cu``
(f32 sums on CUDA cores; the [B, Hp, F, D] outer product never reaches
device memory); on a CPU tensor it runs :func:`cin_layer_plain`, the
port of the reference oracle ``repro.kernels.ref.cin_layer_ref``, which
is also what the kernel is checked against on the card.
"""

from __future__ import annotations

import torch

from ._build import check_status, load

__all__ = ["cin_layer", "cin_layer_plain", "DTYPE_CODES"]

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# rows h of the kernel's tile (csrc/cin.cu): its weight layout pads H to it
TILE_H = 64

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


def kernel_weights(w: torch.Tensor) -> torch.Tensor:
    """w [H, Hp, F] as the kernel reads it: [Hp, F, Hpad] in f32, h
    innermost and zero past H (Hpad = H rounded up to ``TILE_H``), so a
    CTA's slice of one i is F contiguous runs."""
    H, Hp, F = w.shape
    wt = torch.zeros((Hp, F, -(-H // TILE_H) * TILE_H), dtype=torch.float32,
                     device=w.device)
    wt[..., :H] = w.permute(1, 2, 0)
    return wt


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


def cin_layer(xk: torch.Tensor, x0: torch.Tensor,
              w: torch.Tensor) -> torch.Tensor:
    """xk: [B, Hp, D]; x0: [B, F, D]; w: [H, Hp, F] -> [B, H, D] in xk's
    dtype, summed in f32. On the card: f32 or bf16."""
    _check(xk, x0, w)
    if xk.device.type == "cpu":
        return cin_layer_plain(xk, x0, w)
    if xk.device.type != "cuda":
        raise ValueError(f"cin_layer runs on cuda or cpu, not {xk.device}")
    if xk.dtype not in DTYPE_CODES:
        raise ValueError(f"the kernel takes f32 or bf16, not {xk.dtype}")
    B, Hp, D = xk.shape
    F, H = x0.shape[1], w.shape[0]
    xk, x0 = xk.contiguous(), x0.contiguous()
    out = torch.empty((B, H, D), dtype=xk.dtype, device=xk.device)
    if out.numel() == 0:
        return out
    wt = kernel_weights(w)
    rc = load("cin")(xk.data_ptr(), x0.data_ptr(), wt.data_ptr(),
                     out.data_ptr(), DTYPE_CODES[xk.dtype], B, Hp, F, H,
                     wt.shape[2], D, torch.cuda.current_stream().cuda_stream)
    check_status(rc, "cin")
    return out
