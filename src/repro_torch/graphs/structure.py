"""Graph data structures (PyTorch port of ``repro.graphs.structure``).

The push/pull dichotomy is a layout dichotomy (paper §7.1):

  * pull  <-> CSR (in-edges grouped by destination; gather-reduce)
  * push  <-> CSC (out-edges grouped by source; scatter-combine)

Besides those, the graph keeps an ELL (padded-row) view, which the pull
kernels read, and a raw COO view for edge-parallel segment ops.

The pull layout: a graph whose dense [n, d_ell] ELL would hold more than
``DENSE_ELL_MAX_PAD`` slots per real in-edge (a power-law graph, whose
d_ell is its largest hub's in-degree) is built without it. Its pull
kernels read the CSR instead: row v is ``coo_src``/``coo_w``
``[in_ptr[v], in_ptr[v+1])`` (``pull_layout == "rows"``). The dense view
of such a graph is built from the CSR on the graph's device the first
time ``ell_idx`` or ``ell_w`` is read (:func:`dense_ell`), for the
readers that need a matrix.

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
import os
from typing import Optional

import numpy as np
import torch

__all__ = ["Graph", "EdgeView", "build_graph", "graph_from_arrays",
           "pad_values", "resolve_device", "dense_ell", "GRAPH_ARRAYS",
           "DENSE_ELL_MAX_PAD"]

# the 12 tensor views, in field order
GRAPH_ARRAYS = ("coo_src", "coo_dst", "coo_w", "in_ptr", "push_src",
                "push_dst", "push_w", "out_ptr", "ell_idx", "ell_w",
                "in_deg", "out_deg")

# build_graph keeps the dense ELL while its n · d_ell slots are at most
# this many times the m real ones
DENSE_ELL_MAX_PAD = 4


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
    dense_idx, dense_w: ``ell_idx``/``ell_w`` as built, or None (the row
    layout).
    pull_layout: ``"dense"`` (the pull kernels read ``ell_idx``/``ell_w``)
    or ``"rows"`` (they read the CSR; ``ell_idx``/``ell_w`` are built on
    first read, :func:`dense_ell`).
    """

    coo_src: torch.Tensor
    coo_dst: torch.Tensor
    coo_w: torch.Tensor
    in_ptr: torch.Tensor
    push_src: torch.Tensor
    push_dst: torch.Tensor
    push_w: torch.Tensor
    out_ptr: torch.Tensor
    dense_idx: Optional[torch.Tensor]   # None: the row layout
    dense_w: Optional[torch.Tensor]
    in_deg: torch.Tensor
    out_deg: torch.Tensor
    n: int
    m: int
    d_ell: int
    # the dense view of a row-layout graph, once built
    _dense: dict = dataclasses.field(default_factory=dict, repr=False,
                                     init=False)

    @property
    def pull_layout(self) -> str:
        return "rows" if self.dense_idx is None else "dense"

    @property
    def pull_arrays(self) -> tuple:
        """``(idx, w, row_ptr)`` the pull kernels read: the dense ELL and
        None, or the CSR's ``coo_src``, ``coo_w`` and ``in_ptr``."""
        if self.dense_idx is None:
            return self.coo_src, self.coo_w, self.in_ptr
        return self.dense_idx, self.dense_w, None

    @property
    def ell_idx(self) -> torch.Tensor:
        return dense_ell(self)[0]

    @property
    def ell_w(self) -> torch.Tensor:
        return dense_ell(self)[1]

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


def _free_bytes(device: torch.device) -> int:
    """Bytes that can still be allocated on ``device``: the card's free
    memory, or the host's available memory."""
    if device.type == "cuda":
        return int(torch.cuda.mem_get_info(device)[0])
    return int(os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE"))


def dense_ell(g: Graph) -> tuple[torch.Tensor, torch.Tensor]:
    """``(ell_idx, ell_w)`` of ``g``: its own on a dense-layout graph; on
    a row-layout graph the ``[n, d_ell]`` view packed from the CSR on the
    graph's device, built once (range ``repro.graph.dense_ell``), the
    same arrays :func:`build_graph` would have made. Raises
    ``ValueError`` before allocating where the view and its scratch
    would not fit in the device's free memory."""
    if g.dense_idx is not None:
        return g.dense_idx, g.dense_w
    if not g._dense:
        from ..obs.trace import region
        n, m, d = g.n, g.m, g.d_ell
        view = n * d * 8                  # int32 indices, float32 weights
        need = view + m * 16              # and two int64 [m] scratch arrays
        free = _free_bytes(g.device)
        if need > free:
            raise ValueError(
                f"the dense ELL view of this graph, [{n}, {d}] int32 and "
                f"float32, takes {view} bytes ({need} with its scratch); "
                f"{g.device} has {free} free")
        with region("graph.dense_ell"):
            dev = g.device
            idx = torch.full((n, d), n, dtype=torch.int32, device=dev)
            w = torch.zeros((n, d), dtype=torch.float32, device=dev)
            rows = torch.repeat_interleave(
                torch.arange(n, device=dev), g.in_deg.to(torch.int64),
                output_size=m)
            within = torch.arange(m, device=dev) - g.in_ptr[:-1].to(
                torch.int64)[rows]
            idx[rows, within] = g.coo_src
            w[rows, within] = g.coo_w
        g._dense.update(idx=idx, w=w)
    return g._dense["idx"], g._dense["w"]


def build_graph(src, dst, n: int, weights=None, d_ell: Optional[int] = None,
                pad_rows_to: int = 8, device=None) -> Graph:
    """Build all layouts from a COO edge list, on ``device`` (default:
    the card).

    ``d_ell`` may be given to force a padded width, and the graph then
    keeps its dense ELL; otherwise it is the max in-degree rounded up to
    ``pad_rows_to``, and the dense ELL is left out where its ``n ·
    d_ell`` slots would pass ``DENSE_ELL_MAX_PAD · m`` (the row layout,
    ``Graph.pull_layout``). Edge endpoints must lie in ``[0, n)`` and
    weights must be finite; violations raise ``ValueError`` naming the
    first offending edge.
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
    dense = d_ell is not None
    if d_ell is None:
        d_ell = max(pad_rows_to, -(-d_max // pad_rows_to) * pad_rows_to)
        dense = n * d_ell <= DENSE_ELL_MAX_PAD * m
    ell_idx = ell_w = None
    if dense:
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
    The arrays are taken as they are: no sort, no validation. ``ell_idx``
    and ``ell_w`` None give the row layout."""
    dev = resolve_device(device)
    missing = [f for f in GRAPH_ARRAYS if f not in arrays]
    if missing:
        raise ValueError(f"graph_from_arrays: missing views {missing}")
    views = {}
    for f in GRAPH_ARRAYS:
        if arrays[f] is None and f in ("ell_idx", "ell_w"):
            views[f] = None
            continue
        a = np.ascontiguousarray(arrays[f])
        if not a.flags.writeable:       # torch refuses read-only buffers
            a = a.copy()
        views[f] = torch.from_numpy(a).to(dev)
    views["dense_idx"] = views.pop("ell_idx")
    views["dense_w"] = views.pop("ell_w")
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
