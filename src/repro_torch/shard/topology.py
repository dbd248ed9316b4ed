"""Sharded graph topology — the per-shard views every exchange consumes.
PyTorch port of ``repro.shard.topology``.

Built once per (graph, partition, devices), on the host with numpy as
the partition is, then placed shard by shard:

  * **push layout** — the Partition-Awareness split (paper §5-PA):
    ``local`` edges (both endpoints owned by one shard) grouped by that
    owner, and ``remote`` cut edges grouped by the *source* owner.
  * **pull layout** — ALL edges grouped by the *destination* owner,
    keeping the global dst-sorted COO order, so each destination's
    in-edges keep the single-device ``pull_relax`` combine order.
  * **ELL row blocks** — the ``[n, d_ell]`` in-neighbor matrix padded
    with sentinel rows to ``[n_padded, d_ell]`` and cut into
    ``[P, shard_size, d_ell]`` blocks, each shard's with its row lengths
    (the in-degrees, 0 on padded rows) and its ``ell_spmv`` row plan, on
    that shard's device, so the per-shard pull can run the ELL gather or
    the ``ell_spmv`` kernel against the gathered value vector.

The ``[P, cap]`` edge sets stay on the graph's device for accounting
(:func:`~repro_torch.shard.exchange.active_remote_edges`); their rows
are placed on the shards' devices (``*_rows``). Where a shard's device is
the graph's, its rows and ELL block are views, not copies.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from ..dist.collectives import pad_rows, place_edges
from ..graphs.partition import (Partition, PartitionedEdges, _pack,
                                pa_split)
from ..graphs.structure import Graph
from ..kernels.ell_spmv import EllRowPlan, col_lanes, ell_row_plan

__all__ = ["ShardTopology", "build_topology"]


@dataclasses.dataclass(frozen=True, eq=False)
class ShardTopology:
    """Per-shard edge and row views for one (graph, partition) pair."""
    part: Partition
    local: PartitionedEdges       # PA local edges, by owner (push layout)
    remote: PartitionedEdges      # PA cut edges, by src owner (push layout)
    pull_edges: PartitionedEdges  # ALL edges by dst owner, coo order kept
    devices: tuple                # shard p's device
    local_rows: tuple             # ShardRows of local, placed
    remote_rows: tuple            # ShardRows of remote, placed
    pull_rows: tuple              # ShardRows of pull_edges, placed
    ell_idx: tuple                # int32[shard_size, d_ell] per shard
    ell_w: tuple                  # float32[shard_size, d_ell] per shard
    row_len: tuple                # int32[shard_size] per shard
    cut_edges: int
    border_vertices: int
    _plans: dict = dataclasses.field(default_factory=dict, repr=False)

    def row_plan(self, p: int, width: int = 1) -> EllRowPlan:
        """Shard ``p``'s ``ell_spmv`` row plan for payloads of ``width``
        columns, built once per column-lane count on its device."""
        key = (p, col_lanes(width))
        plan = self._plans.get(key)
        if plan is None:
            plan = ell_row_plan(self.row_len[p], self.part.shard_size,
                                self.ell_idx[p].shape[1], width)
            self._plans[key] = plan
        return plan


def _blocks(x: torch.Tensor, part: Partition, fill,
            devices: Sequence) -> tuple:
    """``x`` ([n, ...]) padded to ``n_padded`` rows with ``fill`` (no copy
    when nothing pads), cut into row blocks, block p on ``devices[p]``."""
    x = pad_rows(x, part.n_padded, fill)
    return tuple(b.to(dev) for b, dev in
                 zip(x.chunk(part.num_parts), devices))


def build_topology(g: Graph, part: Partition, align: int = 128,
                   devices: Optional[Sequence] = None) -> ShardTopology:
    """Materialize every per-shard view of ``g`` under ``part``, shard p
    on ``devices[p]`` (default: all on the graph's device)."""
    P = part.num_parts
    devices = tuple(devices) if devices is not None else (g.device,) * P
    if len(devices) != P:
        raise ValueError(f"{len(devices)} devices for {P} shards")
    local, remote, stats = pa_split(g, part, align=align)

    # pull layout: all edges grouped by dst owner. Boolean-mask selection
    # keeps the global coo (dst-sorted) order inside each group
    src = g.coo_src.cpu().numpy()
    dst = g.coo_dst.cpu().numpy()
    w = g.coo_w.cpu().numpy()
    own_d = part.owner_np(dst)
    pull_edges = _pack([src[own_d == p] for p in range(P)],
                       [dst[own_d == p] for p in range(P)],
                       [w[own_d == p] for p in range(P)],
                       P, g.n, align, g.device)

    # ELL row blocks: sentinel rows past n are empty (index n is the ELL
    # invalid marker; their row length is 0)
    topo = ShardTopology(
        part=part, local=local, remote=remote, pull_edges=pull_edges,
        devices=devices, local_rows=place_edges(local, devices),
        remote_rows=place_edges(remote, devices),
        pull_rows=place_edges(pull_edges, devices),
        ell_idx=_blocks(g.ell_idx, part, g.n, devices),
        ell_w=_blocks(g.ell_w, part, 0.0, devices),
        row_len=_blocks(g.in_deg, part, 0, devices),
        cut_edges=int(stats["cut_edges"]),
        border_vertices=int(stats["border_vertices"]))
    for p in range(P):
        topo.row_plan(p, 1)
    return topo
