"""Synthetic graph generators (PyTorch port of ``repro.graphs.generators``).

The numpy code is the JAX package's, so the same seed gives the same
edges; only the final :func:`build_graph` differs (it returns tensors on
``device``, the card by default).

    orc  (Orkut social,   n=3.07M, d̄=39, D=9)    -> kronecker, dense
    pok  (Pokec social,   n=1.63M, d̄=18.75, D=11) -> kronecker
    ljn  (LiveJournal,    n=3.99M, d̄=8.67, D=17)  -> kronecker
    am   (Amazon purchase n=262k,  d̄=3.43, D=32)  -> kronecker, sparse
    rca  (CA road network n=1.96M, d̄=1.4,  D=849) -> road grid

``scale=1.0`` reproduces the paper's sizes.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .structure import Graph, build_graph, resolve_device

__all__ = [
    "kronecker", "erdos_renyi", "road_grid", "ring", "star",
    "standin", "STANDIN_SPECS",
]


def _dedup_simple(src: np.ndarray, dst: np.ndarray, n: int):
    """Drop self loops + duplicate directed edges."""
    keep = src != dst
    src, dst = src[keep], dst[keep]
    key = src.astype(np.int64) * n + dst
    _, idx = np.unique(key, return_index=True)
    return src[idx], dst[idx]


def _symmetrize(src: np.ndarray, dst: np.ndarray):
    return np.concatenate([src, dst]), np.concatenate([dst, src])


def _pair_weights(src: np.ndarray, dst: np.ndarray, n: int, rng,
                  low: float, high: float) -> np.ndarray:
    """Weights drawn per *undirected pair* so both orientations agree."""
    lo = np.minimum(src, dst).astype(np.int64)
    hi = np.maximum(src, dst).astype(np.int64)
    uniq, inv = np.unique(lo * (n + 1) + hi, return_inverse=True)
    wu = rng.uniform(low, high, size=len(uniq)).astype(np.float32)
    return wu[inv]


def kronecker(scale: int, edge_factor: int = 16, seed: int = 0,
              a: float = 0.57, b: float = 0.19, c: float = 0.19,
              undirected: bool = True, weighted: bool = False,
              d_ell: Optional[int] = None, device=None) -> Graph:
    """R-MAT / stochastic-Kronecker power-law generator (Graph500 params).

    n = 2**scale vertices, ~edge_factor * n undirected edges.
    """
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = edge_factor * n
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    ab = a + b
    for bit in range(scale):
        r = rng.random(m)
        src_bit = r >= ab  # falls in c or d quadrant -> src high bit set
        r2 = rng.random(m)
        thr = np.where(src_bit, c / (1.0 - ab), b / ab)
        dst_bit = np.where(src_bit, r2 >= thr, r2 >= (a / ab))
        src |= src_bit.astype(np.int64) << bit
        dst |= dst_bit.astype(np.int64) << bit
    # permute vertex ids to decorrelate degree from id
    perm = rng.permutation(n)
    src, dst = perm[src], perm[dst]
    src, dst = _dedup_simple(src.astype(np.int64), dst.astype(np.int64), n)
    if undirected:
        src, dst = _symmetrize(src, dst)
        src, dst = _dedup_simple(src, dst, n)
    w = _pair_weights(src, dst, n, rng, 1.0, 10.0) if weighted else None
    return build_graph(src, dst, n=n, weights=w, d_ell=d_ell, device=dev)


def erdos_renyi(n: int, avg_degree: float, seed: int = 0,
                undirected: bool = True, weighted: bool = False,
                d_ell: Optional[int] = None, device=None) -> Graph:
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    m = int(n * avg_degree)
    src = rng.integers(0, n, size=m, dtype=np.int64)
    dst = rng.integers(0, n, size=m, dtype=np.int64)
    src, dst = _dedup_simple(src, dst, n)
    if undirected:
        src, dst = _symmetrize(src, dst)
        src, dst = _dedup_simple(src, dst, n)
    w = _pair_weights(src, dst, n, rng, 1.0, 10.0) if weighted else None
    return build_graph(src, dst, n=n, weights=w, d_ell=d_ell, device=dev)


def road_grid(side: int, diag_prob: float = 0.05, seed: int = 0,
              weighted: bool = True, d_ell: Optional[int] = None,
              device=None) -> Graph:
    """Road-network stand-in: 2D grid (d̄≈2, huge diameter) with a few
    diagonal shortcuts. Matches the low-d̄/large-D regime of `rca`."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n = side * side
    ii, jj = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    vid = (ii * side + jj).astype(np.int64)
    right_s, right_d = vid[:, :-1].ravel(), vid[:, 1:].ravel()
    down_s, down_d = vid[:-1, :].ravel(), vid[1:, :].ravel()
    src = np.concatenate([right_s, down_s])
    dst = np.concatenate([right_d, down_d])
    if diag_prob > 0:
        diag_s, diag_d = vid[:-1, :-1].ravel(), vid[1:, 1:].ravel()
        keep = rng.random(len(diag_s)) < diag_prob
        src = np.concatenate([src, diag_s[keep]])
        dst = np.concatenate([dst, diag_d[keep]])
    src, dst = _symmetrize(src, dst)
    w = _pair_weights(src, dst, n, rng, 1.0, 5.0) if weighted else None
    return build_graph(src, dst, n=n, weights=w, d_ell=d_ell, device=dev)


def ring(n: int, weighted: bool = False, d_ell: Optional[int] = None,
         device=None) -> Graph:
    """Cycle graph — worst case diameter; handy for BFS/SSSP tests."""
    dev = resolve_device(device)
    v = np.arange(n, dtype=np.int64)
    src, dst = _symmetrize(v, (v + 1) % n)
    w = None
    if weighted:
        rng = np.random.default_rng(n)
        w = _pair_weights(src, dst, n, rng, 1.0, 7.0)
    return build_graph(src, dst, n=n, weights=w, d_ell=d_ell, device=dev)


def star(n: int, d_ell: Optional[int] = None, device=None) -> Graph:
    """Hub-and-spoke — max-degree stress test for push combining."""
    dev = resolve_device(device)
    leaves = np.arange(1, n, dtype=np.int64)
    hub = np.zeros(n - 1, dtype=np.int64)
    src, dst = _symmetrize(hub, leaves)
    return build_graph(src, dst, n=n, d_ell=d_ell, device=dev)


# name -> (kind, paper n, paper d̄, paper D) ; see module docstring
STANDIN_SPECS = {
    "orc": ("kron", 3_072_000, 39.0, 9),
    "pok": ("kron", 1_630_000, 18.75, 11),
    "ljn": ("kron", 3_990_000, 8.67, 17),
    "am": ("kron", 262_000, 3.43, 32),
    "rca": ("road", 1_960_000, 1.4, 849),
}


def standin(name: str, scale: float = 1.0 / 64, seed: int = 0,
            weighted: bool = False, device=None) -> Graph:
    """Structurally matched stand-in for a paper graph, optionally scaled
    down by ``scale`` in vertex count (degree structure preserved)."""
    dev = resolve_device(device)
    kind, n_full, dbar, _D = STANDIN_SPECS[name]
    n = max(256, int(n_full * scale))
    if kind == "road":
        side = max(16, int(np.sqrt(n)))
        return road_grid(side, seed=seed, weighted=True, device=dev)
    log2n = max(8, int(np.round(np.log2(n))))
    ef = max(1, int(round(dbar / 2.0)))
    return kronecker(log2n, edge_factor=ef, seed=seed, weighted=weighted,
                     device=dev)
