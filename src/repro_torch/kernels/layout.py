"""DualEllLayout — both edge directions in their rectangular form.
PyTorch port of ``repro.kernels.layout``.

  * **ELL-in** (``in_idx``/``in_w``) is the graph's own pull layout
    (shared, not copied); it feeds the pull kernels. On a row-layout
    graph that is the CSR (``coo_src``/``coo_w`` with offsets
    ``in_ptr``), and the dense ELL is not built.
  * **ELL-out** (``out_idx``/``out_w``) is the padded out-neighbor
    matrix packed from the push-major CSR; :func:`touched_out_mask`
    reads it to find N_out(frontier).

The out side is built on the host the first time it is read, not when
the layout is made: the pull path reads only the in side, and on a
power-law graph the out side is as large as the in side (5.15 GB on
Kronecker scale 16). The arrays are the JAX package's; only when they
are built differs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..graphs.structure import Graph, _ell_from_ptr
from ..core.primitives import take_fill

__all__ = ["DualEllLayout", "build_dual_ell", "touched_out_mask"]


@dataclasses.dataclass(frozen=True, eq=False)
class DualEllLayout:
    """ELL-in + ELL-out views of one graph; the out side is lazy."""
    in_idx: torch.Tensor
    in_w: torch.Tensor
    n: int
    d_in: int
    # the graph's push-major arrays, which the out side is packed from
    # (the arrays, not the graph: a backend caches the layout per graph
    # and drops it when the graph goes)
    out_ptr: torch.Tensor = dataclasses.field(repr=False)
    push_dst: torch.Tensor = dataclasses.field(repr=False)
    push_w: torch.Tensor = dataclasses.field(repr=False)
    pad_rows_to: int = 8
    # the in side's row offsets where it is the row layout, else None
    in_ptr: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                       repr=False)
    _out: dict = dataclasses.field(default_factory=dict, repr=False)

    def _out_side(self) -> dict:
        if not self._out:
            out_ptr = self.out_ptr.cpu().numpy()
            d_max = int(np.diff(out_ptr).max()) if self.n else 0
            p = self.pad_rows_to
            d_out = max(p, -(-d_max // p) * p)
            idx, w = _ell_from_ptr(out_ptr, self.push_dst.cpu().numpy(),
                                   self.push_w.cpu().numpy(), self.n, d_out)
            dev = self.in_idx.device
            self._out.update(out_idx=torch.from_numpy(idx).to(dev),
                             out_w=torch.from_numpy(w).to(dev),
                             d_out=int(d_out))
        return self._out

    @property
    def out_idx(self) -> torch.Tensor:
        return self._out_side()["out_idx"]

    @property
    def out_w(self) -> torch.Tensor:
        return self._out_side()["out_w"]

    @property
    def d_out(self) -> int:
        return self._out_side()["d_out"]


def build_dual_ell(g: Graph, pad_rows_to: int = 8) -> DualEllLayout:
    """The dual layout of ``g``: the in side is ``g``'s pull layout (its
    ELL view, or its CSR on a row-layout graph); the out side (max
    out-degree rounded up to ``pad_rows_to``) is packed from
    ``out_ptr``/``push_dst`` on first use."""
    rows = g.pull_layout == "rows"
    return DualEllLayout(in_idx=g.coo_src if rows else g.ell_idx,
                         in_w=g.coo_w if rows else g.ell_w, n=g.n,
                         d_in=g.d_ell, out_ptr=g.out_ptr,
                         push_dst=g.push_dst, push_w=g.push_w,
                         pad_rows_to=pad_rows_to,
                         in_ptr=g.in_ptr if rows else None)


def touched_out_mask(layout: DualEllLayout, frontier: torch.Tensor,
                     cap: int | None = None) -> torch.Tensor:
    """bool[n] mask of N_out(frontier): compact the frontier to row ids
    (at most ``cap``, default n), gather their ELL-out rows and mark each
    destination."""
    n = layout.n
    size = n if cap is None else cap
    rows = torch.nonzero(frontier).flatten()[:size]
    rows = torch.cat([rows, rows.new_full((size - rows.shape[0],), n)])
    nbrs = take_fill(layout.out_idx, rows, n).flatten().to(torch.int64)
    mask = torch.zeros((n + 1,), dtype=torch.bool, device=frontier.device)
    mask[torch.where((nbrs >= 0) & (nbrs < n), nbrs, n)] = True
    return mask[:n]
