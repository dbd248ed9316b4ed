"""GAP's ``kron``: the Graph500 Kronecker (R-MAT) graph.

The GAP Benchmark Suite's generator (``converter -g<scale> -k<degree>``):
``degree * 2**scale`` edges, each endpoint built bit by bit from the
most significant: one uniform draw a bit picks the quadrant, A 0.57
(both bits 0), B 0.19 (the destination's bit set), C 0.19 (the
source's), D 0.05 (both); then the vertex ids are randomly permuted, so
that a vertex's id says nothing of its degree. Taken as undirected; self
loops and duplicate pairs are dropped when the graph is built. The
degrees follow a power law: a few hubs hold most of the in-edge slots.

Made on ``device`` from ``seed`` by a ``torch.Generator`` in a few large
calls; the same seed on the same kind of device gives the same edges.
A program that would pack the graph into a dense ELL larger than the
host's memory is refused with an error before it is handed the graph.
Returns host arrays of the directed edges (both orientations of every
edge, sorted by destination, then source), which the benchmark hands to
the program's ``build_graph`` and to the plain reference. Unweighted:
PageRank reads no weight.
"""

from __future__ import annotations

import os

import numpy as np
import torch

A, B, C = 0.57, 0.19, 0.19


def generate(scale: int, degree: int, seed: int, device=None) -> dict:
    """{"n", "src", "dst", "w"}; ``w`` is None (unit weights)."""
    dev = torch.device("cpu" if device is None else device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    n = 1 << scale
    count = degree * n
    a = torch.zeros(count, dtype=torch.int64, device=dev)
    b = torch.zeros(count, dtype=torch.int64, device=dev)
    for _ in range(scale):
        r = torch.rand(count, generator=gen, device=dev,
                       dtype=torch.float64)
        src_bit = r >= A + B
        dst_bit = torch.where(src_bit, r >= A + B + C, r >= A)
        a = a * 2 + src_bit
        b = b * 2 + dst_bit
        del r, src_bit, dst_bit
    perm = torch.randperm(n, generator=gen, device=dev)
    a, b = perm[a], perm[b]
    keep = a != b
    a, b = a[keep], b[keep]
    key = torch.unique(torch.cat([b * n + a, a * n + b]))
    del perm, a, b, keep
    dst, src = key // n, key % n
    out = {"n": n, "src": src.cpu().numpy(), "dst": dst.cpu().numpy(),
           "w": None}
    _check_the_program_can_hold(out)
    return out


def _check_the_program_can_hold(edges: dict) -> None:
    """Refuse, with an error, a program that would build this graph's
    dense ``[n, d_ell]`` ELL on the host where it is larger than the
    host's physical memory: a program without the row layout
    (``Graph.pull_layout``) packs it for every graph, ~1.7 TB at scale
    21, and on a host that grants memory on first touch it fills the
    host until it is killed, where it should end with an error in its
    set-up. Once every program the benchmark compares has the row
    layout, this check has nothing left to refuse and goes."""
    from repro_torch.graphs import structure
    if hasattr(structure.Graph, "pull_layout"):
        return
    n = int(edges["n"])
    longest = int(np.bincount(edges["dst"], minlength=n).max()) if n else 0
    nbytes = n * max(8, -(-longest // 8) * 8) * 8
    total = os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    if nbytes > total:
        raise MemoryError(
            f"this program packs every graph into a dense ELL: "
            f"{nbytes} bytes for this one, and the host has {total}")
