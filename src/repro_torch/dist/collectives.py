"""Distributed k-relaxation exchanges (paper §6, Fig 3). PyTorch port of
the graph side of ``repro.dist.collectives``.

One controller drives P shards over a :class:`~repro_torch.shard.mesh.
ShardMesh`: shard ``p`` is a set of tensors on ``mesh.devices[p]``, and a
collective is an explicit function over the P per-shard tensors. A
transfer to another device is ``.to(device, non_blocking=True)``, a peer
copy between cards and nothing at all between shards of one card.
Reductions run in shard order 0..P−1, so min and max are exact and a sum
adds its P terms in one fixed order.

Primitives: :func:`all_gather`, :func:`psum_scatter` and
:func:`pmin_scatter` / :func:`pmax_scatter` (``pmin``/``pmax`` followed
by the owner slice, computed slice by slice).

The paper's DM variants of push and pull map onto two schedules over a
Partition-Awareness edge split (``graphs.partition.pa_split``):

  * :func:`push_exchange` — the combined-alltoall "MP" push: every shard
    reduces its outgoing remote messages into a full-length private
    accumulator, then one ``psum_scatter`` (``pmin``/``pmax`` + slice)
    combines and delivers the owner slices. O(n) bytes per device.
  * :func:`pull_exchange` — the RMA-style pull: owners all_gather the
    source values (O(n·(P−1)/P) bytes) and privately combine their
    in-edges.

Both return ``(combined [n_padded], bytes_per_device)`` and are
numerically identical; they differ in the communication structure the
paper measures. Edge payloads follow ``PartitionedEdges``: ``[P, cap]``
rows grouped by the owner shard, sentinel-padded, with a ``valid`` mask.

The wire counter (:func:`count_wire`, :func:`wire_bytes`) adds up what
each collective carries between shards, per shard as a wire would carry
it: an ``all_gather`` brings every shard the blocks it does not own, a
``reduce_scatter`` every owner the slices of the others, even where two
shards share a device and nothing moves. The dry run reads it;
``models.moe``'s expert-parallel exchanges add theirs too.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from ..core.primitives import combine_identity
from ..graphs.partition import Partition, PartitionedEdges
from ..sparse.segment import segment_max, segment_min, segment_sum

__all__ = ["push_exchange", "pull_exchange", "pa_exchange",
           "merge_combine", "all_gather", "psum_scatter", "pmin_scatter",
           "pmax_scatter", "reduce_scatter", "shard_blocks", "unshard",
           "pad_rows", "ShardRows", "place_edges", "count_wire",
           "wire_bytes", "reset_wire", "WIRE_KINDS"]

_SEGMENT = {"sum": segment_sum, "min": segment_min, "max": segment_max}

# the reference's HLO collective kinds
WIRE_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
              "collective-permute")
_WIRE = {k: {"count": 0, "bytes": 0} for k in WIRE_KINDS}


def count_wire(kind: str, nbytes: int) -> None:
    """One collective of ``kind`` that carried ``nbytes`` between shards."""
    _WIRE[kind]["count"] += 1
    _WIRE[kind]["bytes"] += int(nbytes)


def wire_bytes() -> dict:
    """What the collectives carried since :func:`reset_wire`, by kind
    and in total."""
    by_kind = {k: dict(v) for k, v in _WIRE.items()}
    return {"by_kind": by_kind,
            "total_bytes": sum(v["bytes"] for v in by_kind.values()),
            "total_count": sum(v["count"] for v in by_kind.values())}


def reset_wire() -> None:
    for v in _WIRE.values():
        v["count"] = v["bytes"] = 0


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass(frozen=True, eq=False)
class ShardRows:
    """One shard's row of a ``PartitionedEdges`` set, on its device."""
    src: torch.Tensor
    dst: torch.Tensor
    w: torch.Tensor
    valid: torch.Tensor


def place_edges(edges: PartitionedEdges, devices: Sequence) -> tuple:
    """Row ``p`` of ``edges`` on ``devices[p]``, for every shard (views,
    with no copy, where a row already lies on its device)."""
    return tuple(ShardRows(*(t[p].to(dev) for t in (edges.src, edges.dst,
                                                    edges.w, edges.valid)))
                 for p, dev in enumerate(devices))


def pad_rows(x: torch.Tensor, rows: int, fill) -> torch.Tensor:
    """``x`` ([n, ...]) padded to ``rows`` rows with ``fill`` (``x``
    itself when nothing pads)."""
    extra = rows - x.shape[0]
    if extra <= 0:
        return x
    return torch.cat([x, x.new_full((extra,) + x.shape[1:], fill)])


def shard_blocks(x: torch.Tensor, devices: Sequence) -> list:
    """``x`` ([P·s, ...]) cut into P row blocks, block p on
    ``devices[p]``."""
    return [b.to(dev, non_blocking=True)
            for b, dev in zip(x.chunk(len(devices)), devices)]


def unshard(blocks: Sequence, device) -> torch.Tensor:
    """The per-shard row blocks concatenated in shard order on
    ``device``."""
    return torch.cat([b.to(device, non_blocking=True) for b in blocks])


def all_gather(blocks: Sequence, devices: Sequence) -> list:
    """Every shard's copy of the concatenated blocks. Shards that share a
    device share one copy: it is read only."""
    count_wire("all-gather", sum(_nbytes(b) for b in blocks)
               * (len(devices) - 1))
    by_dev: dict = {}
    out = []
    for dev in devices:
        key = torch.device(dev)
        if key not in by_dev:
            by_dev[key] = unshard(blocks, dev)
        out.append(by_dev[key])
    return out


def reduce_scatter(blocks: Sequence, devices: Sequence,
                   combine: str) -> list:
    """Owner slices of the elementwise ``combine`` of P full-length
    blocks: shard p gets ``combine_q blocks[q][p·s:(p+1)·s]`` on
    ``devices[p]``, reduced in shard order q = 0..P−1."""
    op = {"sum": torch.add, "min": torch.minimum,
          "max": torch.maximum}[combine]
    P = len(devices)
    count_wire("reduce-scatter",
               sum(_nbytes(b) for b in blocks) * (P - 1) // max(P, 1))
    out = []
    for p, dev in enumerate(devices):
        parts = [b.chunk(P)[p].to(dev, non_blocking=True) for b in blocks]
        acc = parts[0]
        for part in parts[1:]:
            acc = op(acc, part)
        out.append(acc)
    return out


def psum_scatter(blocks: Sequence, devices: Sequence) -> list:
    """``psum_scatter(..., tiled=True)``: owner slices of the sum."""
    return reduce_scatter(blocks, devices, "sum")


def pmin_scatter(blocks: Sequence, devices: Sequence) -> list:
    """``pmin`` followed by the owner slice."""
    return reduce_scatter(blocks, devices, "min")


def pmax_scatter(blocks: Sequence, devices: Sequence) -> list:
    """``pmax`` followed by the owner slice."""
    return reduce_scatter(blocks, devices, "max")


def merge_combine(combine: str, a: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """Elementwise ⊕ of two partial relaxation results."""
    if combine == "sum":
        return a + b
    if combine == "min":
        return torch.minimum(a, b)
    return torch.maximum(a, b)


def _messages(vals, w, msg_fn, combine, valid):
    """Per-edge payloads; default message is ``value * weight``."""
    msg = vals * w if msg_fn is None else msg_fn(vals, w)
    if msg.ndim == 2:
        valid = valid[:, None]
    return torch.where(valid, msg, combine_identity(combine, msg.dtype))


def _rows(edges, devices) -> tuple:
    return (edges if isinstance(edges, tuple)
            else place_edges(edges, devices))


def push_exchange(mesh, part: Partition, edges, vals: torch.Tensor,
                  msg_fn: Optional[Callable] = None, combine: str = "sum",
                  axis: str = "data") -> tuple[torch.Tensor, int]:
    """MP-style combining push over remote edges grouped by SRC owner.

    ``vals``: ``[n_padded]`` source values; shard p dereferences only the
    sources it owns. ``edges``: a ``PartitionedEdges`` or its rows
    already placed (:func:`place_edges`). Returns the per-destination
    combination of all remote messages, ``[n_padded]`` on ``vals``'
    device, and the analytic bytes each device moves.
    """
    devices = mesh.devices
    shard, npad = part.shard_size, part.n_padded
    partials = []
    for p, (vb, e) in enumerate(zip(shard_blocks(vals, devices),
                                    _rows(edges, devices))):
        lidx = torch.clamp(e.src.to(torch.int64) - p * shard, 0, shard - 1)
        msg = _messages(vb[lidx], e.w, msg_fn, combine, e.valid)
        partials.append(_SEGMENT[combine](
            msg, torch.clamp(e.dst, 0, npad - 1), npad))
    out = unshard(reduce_scatter(partials, devices, combine), vals.device)
    return out, npad * vals.element_size()          # combined all-to-all


def pull_exchange(mesh, part: Partition, edges, vals: torch.Tensor,
                  msg_fn: Optional[Callable] = None, combine: str = "sum",
                  axis: str = "data") -> tuple[torch.Tensor, int]:
    """RMA-style pull over remote edges grouped by DST owner: each owner
    all_gathers the source values and privately combines its incoming
    remote edges."""
    devices = mesh.devices
    P, shard, npad = part.num_parts, part.shard_size, part.n_padded
    fulls = all_gather(shard_blocks(vals, devices), devices)
    outs = []
    for p, (full, e) in enumerate(zip(fulls, _rows(edges, devices))):
        v = full[torch.clamp(e.src.to(torch.int64), 0, npad - 1)]
        msg = _messages(v, e.w, msg_fn, combine, e.valid)
        ldst = torch.clamp(e.dst.to(torch.int64) - p * shard, 0, shard - 1)
        outs.append(_SEGMENT[combine](msg, ldst, shard))
    nbytes = npad * vals.element_size() * (P - 1) // max(P, 1)
    return unshard(outs, vals.device), nbytes


def pa_exchange(mesh, part: Partition, local: PartitionedEdges, remote,
                vals: torch.Tensor, direction: str = "push",
                msg_fn: Optional[Callable] = None, combine: str = "sum",
                axis: str = "data") -> tuple[torch.Tensor, int]:
    """Full PA relaxation (paper Algorithm 8 structure): local edges are
    plain per-owner writes on ``vals``' device (no collective), remote
    edges go through the chosen exchange; results combine
    elementwise."""
    npad = part.n_padded
    src = local.src.reshape(-1).to(torch.int64)
    vp = pad_rows(vals, npad + 1, 0)
    msg = _messages(vp[torch.clamp(src, 0, npad)], local.w.reshape(-1),
                    msg_fn, combine, local.valid.reshape(-1))
    loc = _SEGMENT[combine](msg, torch.clamp(local.dst.reshape(-1), 0,
                                             npad - 1), npad)
    exch = push_exchange if direction == "push" else pull_exchange
    rem, nbytes = exch(mesh, part, remote, vals, msg_fn=msg_fn,
                       combine=combine, axis=axis)
    return merge_combine(combine, loc, rem), nbytes
