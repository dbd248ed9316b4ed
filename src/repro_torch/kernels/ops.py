"""Public wrappers over the kernels (port of ``repro.kernels.ops``).

They adapt framework structures (a ``Graph``, GQA heads) to the kernel
wrappers, which launch the CUDA kernel on a card tensor and run its
plain version on a CPU tensor. The engine does not go through these:
it dispatches through ``core.backend.CudaBackend``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..graphs.structure import Graph, pad_values
from .cin import cin_layer as _cin_layer
from .coo_push import coo_push
from .ell_spmv import ell_spmv
from .flash_attention import GLOBAL_WINDOW
from .flash_attention import flash_attention as _flash_attention

__all__ = ["pull_spmv", "push_combine", "flash_attention", "cin_layer"]


def pull_spmv(g: Graph, x: torch.Tensor, combine: str = "sum"
              ) -> torch.Tensor:
    """Pull k-relaxation through the ELL kernel, over ``g``'s own pull
    layout. x: f32 [n] -> f32 [n]."""
    idx, w, row_ptr = g.pull_arrays
    return ell_spmv(pad_values(x.to(torch.float32)), idx, w,
                    combine=combine, row_len=g.in_deg, row_ptr=row_ptr,
                    d_ell=g.d_ell)


def push_combine(g: Graph, x: torch.Tensor, active: torch.Tensor,
                 combine: str = "sum") -> torch.Tensor:
    """Push k-relaxation through the binned COO kernel over the
    dst-sorted edges."""
    return coo_push(x.to(torch.float32), active, g.coo_src, g.coo_dst,
                    g.coo_w, g.n, combine=combine)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal_window: int = GLOBAL_WINDOW,
                    softcap: float = 0.0, block_q: int = 128,
                    block_k: int = 128,
                    scale: Optional[float] = None) -> torch.Tensor:
    """GQA-aware flash attention. q: [B, T, H, d]; k, v: [B, T, Hk, d]
    (query head h reads KV head h // (H // Hk), in place). Returns
    [B, T, H, d], with a gradient when grad is enabled and an input
    requires it. ``block_q`` and ``block_k`` are the TPU kernel's tile
    sizes, kept for the reference's signature: the CUDA kernel's tiles
    are fixed, and no tile size changes the result; ``block_q`` is also
    the query block of the backward's recompute. ``scale`` defaults to
    d ** -0.5."""
    if block_q <= 0 or block_k <= 0:
        raise ValueError(f"block sizes must be positive: {block_q}, "
                         f"{block_k}")
    return _flash_attention(q, k, v, causal_window, softcap, scale,
                            bwd_q_chunk=block_q)


def cin_layer(xk: torch.Tensor, x0: torch.Tensor,
              w: torch.Tensor) -> torch.Tensor:
    """One CIN layer: xk [B, Hp, D], x0 [B, F, D], w [H, Hp, F] ->
    [B, H, D], with a gradient when grad is enabled and an input
    requires it."""
    return _cin_layer(xk, x0, w)
