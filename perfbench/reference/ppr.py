"""Personalized PageRank, plain PyTorch: the benchmark's reference.

The semantics the program's batched ``"ppr"`` queries promise, worked
out again from the edge list alone (no layout, weight or table of the
program): for source s, ``rank_0 = (1 - damp) e_s``; each step
``rank' = (1 - damp) e_s + damp * A^T (rank / max(out_deg, 1))``, and a
query keeps stepping while its largest change in the previous step was
at least ``tol``, for at most ``iters`` steps. Computed in float64 in
blocks of columns. ``control`` is the same arithmetic in bfloat16, the
precision below the configuration's float32.
"""

from __future__ import annotations

import torch

CHECKS = ("rank_gap",)


# elements of one block's per-edge messages: 4 GiB in float64
BLOCK_ELEMENTS = 1 << 29


def solve(edges: dict, sources, params: dict, dtype=torch.float64,
          block: int = 16) -> torch.Tensor:
    """Ranks ``[n, len(sources)]`` in ``dtype``. ``edges``: ``src``,
    ``dst`` (int64 tensors of the directed edges, on one device) and
    ``n``. Columns go in blocks of at most ``block``, fewer on a graph
    whose per-edge messages would pass ``BLOCK_ELEMENTS``."""
    src, dst, n = edges["src"], edges["dst"], int(edges["n"])
    block = max(1, min(block, BLOCK_ELEMENTS // max(1, src.numel())))
    damp, tol = float(params["damp"]), float(params["tol"])
    iters = int(params["iters"])
    dev = src.device
    deg = torch.bincount(src, minlength=n).clamp(min=1).to(dtype)[:, None]
    sources = torch.as_tensor(sources, dtype=torch.int64, device=dev)
    out = []
    for lo in range(0, sources.numel(), block):
        s = sources[lo:lo + block]
        k = s.numel()
        cols = torch.arange(k, device=dev)
        base = torch.zeros((n, k), dtype=dtype, device=dev)
        base[s, cols] = 1.0 - damp
        rank = base.clone()
        resid = torch.full((k,), float("inf"), dtype=torch.float64,
                           device=dev)
        for _ in range(iters):
            active = resid >= tol
            if not bool(active.any()):
                break
            msgs = torch.zeros((n, k), dtype=dtype, device=dev)
            msgs.index_add_(0, dst, (rank / deg)[src])
            new = base + damp * msgs
            change = (new - rank).abs().amax(dim=0).to(torch.float64)
            rank = torch.where(active[None, :], new, rank)
            resid = torch.where(active, change, resid)
        out.append(rank)
    return torch.cat(out, dim=1)


def control(edges: dict, sources, params: dict) -> torch.Tensor:
    """The reference in bfloat16, put in the program's place."""
    return solve(edges, sources, params, dtype=torch.bfloat16)


def readings(results: list, reference: torch.Tensor) -> dict:
    """``rank_gap``: over the sampled queries, the largest
    ``max_v |rank_v - ref_v| / max_v |ref_v|``."""
    gap = 0.0
    for j, r in enumerate(results):
        ref = reference[:, j].to(torch.float64)
        got = r.to(device=ref.device, dtype=torch.float64)
        scale = float(ref.abs().max())
        gap = max(gap, float((got - ref).abs().max()) / scale)
    return {"rank_gap": gap}
