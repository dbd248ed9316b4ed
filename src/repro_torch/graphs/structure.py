"""Graph data structures (PyTorch port of ``repro.graphs.structure``).

The push/pull dichotomy is a layout dichotomy (paper §7.1):

  * pull  <-> CSR (in-edges grouped by destination; gather-reduce)
  * push  <-> CSC (out-edges grouped by source; scatter-combine)

Besides those, the graph keeps an ELL (padded-row) view, which the pull
kernels read, and a raw COO view for edge-parallel segment ops.

All views are built once on the host with numpy, exactly as the JAX
package builds them, and moved to the device at the end. ``Graph`` is a
frozen dataclass of tensors on one explicit device.

Conventions
-----------
* Vertices are ``int32`` ids in ``[0, n)``.
* ``coo_src/coo_dst`` are sorted by ``dst`` (pull-major). ``push_*``
  holds the same edges sorted by ``src`` (push-major).
* Undirected graphs store every edge in both directions, so ``m`` counts
  directed edges.
* ELL rows are padded with the sentinel ``n``; gathers index into value
  vectors padded with a zero row at index ``n`` (:func:`pad_values`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

__all__ = ["Graph", "EdgeView", "build_graph", "graph_from_arrays",
           "pad_values", "resolve_device", "GRAPH_ARRAYS"]

# the 12 tensor views, in field order
GRAPH_ARRAYS = ("coo_src", "coo_dst", "coo_w", "in_ptr", "push_src",
                "push_dst", "push_w", "out_ptr", "ell_idx", "ell_w",
                "in_deg", "out_deg")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller
    names another. Asking for CUDA where there is none raises instead of
    carrying on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device=\"cpu\" to run on the "
            "CPU (the kernels then use their plain PyTorch versions)")
    return dev


def _to_i32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.int32)


@dataclasses.dataclass(frozen=True, eq=False)
class Graph:
    """Multi-layout immutable graph container.

    Attributes
    ----------
    n, m, d_ell: python ints.
    coo_src, coo_dst: ``int32[m]`` edges sorted by ``dst`` (pull-major).
    coo_w: ``float32[m]`` weights aligned with ``coo_src/dst``.
    in_ptr: ``int32[n+1]`` CSR row pointer over the pull-major edges.
    push_src, push_dst, push_w: the same edges sorted by ``src``.
    out_ptr: ``int32[n+1]`` pointer for the push-major order.
    ell_idx: ``int32[n, d_ell]`` padded in-neighbor lists (sentinel ``n``).
    ell_w: ``float32[n, d_ell]`` weights aligned with ``ell_idx`` (0 pad).
    in_deg, out_deg: ``int32[n]``.
    """

    coo_src: torch.Tensor
    coo_dst: torch.Tensor
    coo_w: torch.Tensor
    in_ptr: torch.Tensor
    push_src: torch.Tensor
    push_dst: torch.Tensor
    push_w: torch.Tensor
    out_ptr: torch.Tensor
    ell_idx: torch.Tensor
    ell_w: torch.Tensor
    in_deg: torch.Tensor
    out_deg: torch.Tensor
    n: int
    m: int
    d_ell: int

    @property
    def device(self) -> torch.device:
        return self.coo_src.device

    @property
    def num_vertices(self) -> int:
        return self.n

    @property
    def num_edges(self) -> int:
        return self.m


def _ell_from_ptr(ptr: np.ndarray, nbr: np.ndarray, w: np.ndarray, n: int,
                  d_ell: int) -> tuple[np.ndarray, np.ndarray]:
    """Pack CSR-ordered neighbor lists into a padded [n, d_ell] matrix."""
    deg = np.diff(ptr)
    d_max = int(deg.max()) if n else 0
    if d_ell < d_max:
        raise ValueError(f"d_ell={d_ell} < max degree {d_max}")
    idx = np.full((n, d_ell), n, dtype=np.int32)
    val = np.zeros((n, d_ell), dtype=w.dtype)
    within = np.arange(len(nbr), dtype=np.int64) - np.repeat(ptr[:-1], deg)
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    idx[rows, within] = nbr
    val[rows, within] = w
    return idx, val


def build_graph(src, dst, n: int, weights=None, d_ell: Optional[int] = None,
                pad_rows_to: int = 8, device=None) -> Graph:
    """Build all layouts from a COO edge list, on ``device`` (default:
    the card).

    ``d_ell`` may be given to force a padded width; otherwise the max
    in-degree rounded up to ``pad_rows_to``. Edge endpoints must lie in
    ``[0, n)`` and weights must be finite; violations raise
    ``ValueError`` naming the first offending edge.
    """
    dev = resolve_device(device)
    src = _to_i32(src)
    dst = _to_i32(dst)
    m = int(src.shape[0])
    if dst.shape != src.shape:
        raise ValueError(
            f"build_graph: src has {m} edges but dst has "
            f"{int(dst.shape[0])} — the COO views must be aligned")
    for name, arr in (("src", src), ("dst", dst)):
        if m and (arr.min() < 0 or arr.max() >= n):
            bad = int(np.flatnonzero((arr < 0) | (arr >= n))[0])
            raise ValueError(
                f"build_graph: {name}[{bad}] = {int(arr[bad])} is "
                f"outside the vertex range [0, {n}) — every edge "
                f"endpoint must name an existing vertex")
    if weights is None:
        weights = np.ones(m, dtype=np.float32)
    w = np.asarray(weights, dtype=np.float32)
    if w.shape != (m,):
        raise ValueError(
            f"build_graph: weights shape {w.shape} does not match the "
            f"{m} edges")
    if m and not np.isfinite(w).all():
        bad = int(np.flatnonzero(~np.isfinite(w))[0])
        raise ValueError(
            f"build_graph: weights[{bad}] = {w[bad]} is not finite — "
            f"NaN/Inf edge weights are rejected at construction")

    # pull-major: sort by dst (stable keeps generator order within a row)
    order = np.argsort(dst, kind="stable")
    p_src, p_dst, p_w = src[order], dst[order], w[order]
    in_ptr = np.zeros(n + 1, dtype=np.int32)
    np.add.at(in_ptr, p_dst + 1, 1)
    in_ptr = np.cumsum(in_ptr, dtype=np.int64).astype(np.int32)

    # push-major: sort by src
    order2 = np.argsort(src, kind="stable")
    q_src, q_dst, q_w = src[order2], dst[order2], w[order2]
    out_ptr = np.zeros(n + 1, dtype=np.int32)
    np.add.at(out_ptr, q_src + 1, 1)
    out_ptr = np.cumsum(out_ptr, dtype=np.int64).astype(np.int32)

    in_deg = np.diff(in_ptr).astype(np.int32)
    out_deg = np.diff(out_ptr).astype(np.int32)

    d_max = int(in_deg.max()) if n else 0
    if d_ell is None:
        d_ell = max(pad_rows_to, -(-d_max // pad_rows_to) * pad_rows_to)
    ell_idx, ell_w = _ell_from_ptr(in_ptr, p_src, p_w, n, d_ell)

    arrays = dict(coo_src=p_src, coo_dst=p_dst, coo_w=p_w, in_ptr=in_ptr,
                  push_src=q_src, push_dst=q_dst, push_w=q_w,
                  out_ptr=out_ptr, ell_idx=ell_idx, ell_w=ell_w,
                  in_deg=in_deg, out_deg=out_deg)
    return graph_from_arrays(arrays, n=n, m=m, d_ell=int(d_ell), device=dev)


def graph_from_arrays(arrays: dict, n: int, m: int, d_ell: int,
                      device=None) -> Graph:
    """A :class:`Graph` from its 12 host arrays (``GRAPH_ARRAYS``), e.g.
    ``{f: np.asarray(getattr(g_ref, f))}`` of a graph built elsewhere.
    The arrays are taken as they are: no sort, no validation."""
    dev = resolve_device(device)
    missing = [f for f in GRAPH_ARRAYS if f not in arrays]
    if missing:
        raise ValueError(f"graph_from_arrays: missing views {missing}")
    views = {}
    for f in GRAPH_ARRAYS:
        a = np.ascontiguousarray(arrays[f])
        if not a.flags.writeable:       # torch refuses read-only buffers
            a = a.copy()
        views[f] = torch.from_numpy(a).to(dev)
    return Graph(**views, n=int(n), m=int(m), d_ell=int(d_ell))


def pad_values(x: torch.Tensor) -> torch.Tensor:
    """Append a zero row/scalar at index ``n`` so ELL sentinel gathers
    read zeros. Works for [n] vectors and [n, d] matrices."""
    return torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))], dim=0)


@dataclasses.dataclass(frozen=True, eq=False)
class EdgeView:
    """Duck-typed Graph stand-in for GNN layers: one edge order, shared by
    both directions (the provider chooses pull- or push-major order).
    Used for sampled subgraphs and edge sets built for training, where
    the full multi-layout :class:`Graph` would waste memory."""
    src: torch.Tensor
    dst: torch.Tensor
    w: torch.Tensor
    n: int
    m: int

    @property
    def coo_src(self):
        return self.src

    @property
    def coo_dst(self):
        return self.dst

    @property
    def coo_w(self):
        return self.w

    @property
    def push_src(self):
        return self.src

    @property
    def push_dst(self):
        return self.dst

    @property
    def push_w(self):
        return self.w
