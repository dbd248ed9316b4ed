"""1D vertex decomposition + Partition-Awareness (paper §2.2, §5-PA).
PyTorch port of ``repro.graphs.partition``.

A partition assigns each vertex ``v`` an owner ``t[v] = v // shard_size``
(contiguous blocks). Partition-Awareness (PA) splits every adjacency into

  * **local** edges: ``t[src] == t[dst]`` — updated with plain writes, and
  * **remote** edges: ``t[src] != t[dst]`` — the only edges whose updates
    cross a partition boundary (combining writes).

The split is built on the host with numpy once per (graph, P) pair, as
the JAX package builds it; its tensors go to the graph's device. Edge
sets are padded to one row length per partition (``cap``, a multiple of
``align``); ``count`` carries the true sizes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .structure import Graph

__all__ = ["Partition", "partition_1d", "PartitionedEdges", "pa_split",
           "pa_regroup_by_dst"]


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


@dataclasses.dataclass(frozen=True)
class Partition:
    """Owner map for a 1D contiguous decomposition."""
    n: int
    num_parts: int
    shard_size: int
    n_padded: int

    def owner_np(self, v: np.ndarray) -> np.ndarray:
        return np.minimum(v // self.shard_size, self.num_parts - 1)

    def owner(self, v: torch.Tensor) -> torch.Tensor:
        return torch.clamp(v // self.shard_size, max=self.num_parts - 1)


def partition_1d(n: int, num_parts: int) -> Partition:
    """Contiguous 1D decomposition of ``n`` vertices into ``num_parts``
    owner blocks of ``shard_size = ceil(n / num_parts)``; ``n_padded =
    shard_size * num_parts >= n`` (vertices are never truncated).

    Raises ``ValueError`` unless ``1 <= num_parts <= n``: more parts than
    vertices would leave empty shards aliasing the last owner's slice.
    """
    if num_parts < 1:
        raise ValueError(
            f"num_parts={num_parts} is invalid: a partition needs at "
            "least one part")
    if num_parts > n:
        raise ValueError(
            f"num_parts={num_parts} exceeds the vertex count n={n}: "
            "every part must own at least one vertex (empty shards would "
            "alias the last owner's slice)")
    shard = _round_up(n, num_parts) // num_parts
    return Partition(n=n, num_parts=num_parts, shard_size=shard,
                     n_padded=shard * num_parts)


@dataclasses.dataclass(frozen=True)
class PartitionedEdges:
    """A PA edge set, partition-major and padded: row ``p`` of each
    ``[P, cap]`` tensor holds the edges whose owner is ``p`` (the source's
    owner for push, the destination's for pull). Padding slots point at
    the sentinel vertex ``n`` with weight 0 and ``valid=False``."""
    src: torch.Tensor    # int32[P, cap]
    dst: torch.Tensor    # int32[P, cap]
    w: torch.Tensor      # float32[P, cap]
    valid: torch.Tensor  # bool[P, cap]
    count: torch.Tensor  # int32[P] true number of edges per partition
    cap: int
    num_parts: int


def _pack(rows: list, cols: list, ws: list, P: int, n: int, align: int,
          device) -> PartitionedEdges:
    cap = max(1, _round_up(max((len(r) for r in rows), default=1), align))
    src = np.full((P, cap), n, dtype=np.int32)
    dst = np.full((P, cap), n, dtype=np.int32)
    w = np.zeros((P, cap), dtype=np.float32)
    valid = np.zeros((P, cap), dtype=bool)
    cnt = np.zeros((P,), dtype=np.int32)
    for p in range(P):
        k = len(rows[p])
        src[p, :k] = rows[p]
        dst[p, :k] = cols[p]
        w[p, :k] = ws[p]
        valid[p, :k] = True
        cnt[p] = k

    def dev(a):
        return torch.from_numpy(a).to(device)
    return PartitionedEdges(src=dev(src), dst=dev(dst), w=dev(w),
                            valid=dev(valid), count=dev(cnt), cap=int(cap),
                            num_parts=P)


def pa_regroup_by_dst(part: Partition, edges: PartitionedEdges, n: int,
                      align: int = 128) -> PartitionedEdges:
    """Regroup a packed edge set by the *destination* owner (the pull
    layout), sized by the edge set itself."""
    ok = edges.valid.reshape(-1).cpu().numpy()
    src = edges.src.reshape(-1).cpu().numpy()[ok]
    dst = edges.dst.reshape(-1).cpu().numpy()[ok]
    w = edges.w.reshape(-1).cpu().numpy()[ok]
    own_d = part.owner_np(dst)
    P = part.num_parts
    rows = [src[own_d == p] for p in range(P)]
    cols = [dst[own_d == p] for p in range(P)]
    ws = [w[own_d == p] for p in range(P)]
    return _pack(rows, cols, ws, P, n, align, edges.src.device)


def pa_split(g: Graph, part: Partition, align: int = 128
             ) -> tuple[PartitionedEdges, PartitionedEdges, dict]:
    """Partition-Awareness split of ``g`` under ``part``.

    Returns ``(local, remote, stats)``, both edge sets grouped by the
    **source** owner (push layout; pull consumers regroup the cut with
    :func:`pa_regroup_by_dst`). ``stats`` reports the cut: the paper's
    bound on remote combining writes is ``[0, 2m]``.
    """
    P = part.num_parts
    src = g.push_src.cpu().numpy()
    dst = g.push_dst.cpu().numpy()
    w = g.push_w.cpu().numpy()
    own_s = part.owner_np(src)
    own_d = part.owner_np(dst)
    is_local = own_s == own_d

    loc_rows, loc_cols, loc_ws = [], [], []
    rem_rows, rem_cols, rem_ws = [], [], []
    for p in range(P):
        sel_l = (own_s == p) & is_local
        sel_r = (own_s == p) & ~is_local
        loc_rows.append(src[sel_l])
        loc_cols.append(dst[sel_l])
        loc_ws.append(w[sel_l])
        rem_rows.append(src[sel_r])
        rem_cols.append(dst[sel_r])
        rem_ws.append(w[sel_r])

    local = _pack(loc_rows, loc_cols, loc_ws, P, g.n, align, g.device)
    remote = _pack(rem_rows, rem_cols, rem_ws, P, g.n, align, g.device)
    cut = int((~is_local).sum())
    stats = {
        "m": g.m,
        "cut_edges": cut,
        "cut_fraction": cut / max(1, g.m),
        "border_vertices": int(np.unique(np.concatenate(
            [src[~is_local], dst[~is_local]])).size) if cut else 0,
    }
    return local, remote, stats
