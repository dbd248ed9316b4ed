"""GAP's ``urand``: the uniform random (Erdos-Renyi) graph.

The GAP Benchmark Suite's generator (``converter -u<scale> -k<degree>``):
``degree * 2**scale`` edges whose two endpoints are drawn uniformly from
``2**scale`` vertices, taken as undirected; self loops and duplicate
pairs are dropped when the graph is built. Made on ``device`` from
``seed`` by a ``torch.Generator`` in a few large calls; the same seed on
the same kind of device gives the same edges. Returns host arrays of the
directed edges (both orientations of every edge, sorted by destination,
then source), which the benchmark hands to the program's
``build_graph`` and to the plain reference. Unweighted: PageRank reads
no weight.
"""

from __future__ import annotations

import torch


def generate(scale: int, degree: int, seed: int, device=None) -> dict:
    """{"n", "src", "dst", "w"}; ``w`` is None (unit weights)."""
    dev = torch.device("cpu" if device is None else device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    n = 1 << scale
    pairs = torch.randint(0, n, (2, degree * n), generator=gen, device=dev,
                          dtype=torch.int64)
    a, b = pairs[0], pairs[1]
    keep = a != b
    a, b = a[keep], b[keep]
    key = torch.unique(torch.cat([b * n + a, a * n + b]))
    del pairs, a, b, keep
    dst, src = key // n, key % n
    return {"n": n, "src": src.cpu().numpy(), "dst": dst.cpu().numpy(),
            "w": None}
