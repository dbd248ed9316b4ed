"""The sharded exchanges — the whole k-relaxation step over the mesh.
PyTorch port of ``repro.shard.exchange``.

Unlike ``dist.collectives.pa_exchange`` (which computes local edges
replicated, outside the shards), both schedules here run local AND
remote work shard by shard, each shard touching only its own slice —
the paper's §6 DM execution model, end to end:

  * :func:`sharded_push` — per shard: frontier-masked local scatter into
    the owned slice, frontier-masked remote scatter into a full-length
    private accumulator (optionally compressed with error feedback,
    ``dist.compression``), then one combining collective delivers the
    owner slices (``psum_scatter`` for sum; ``pmin``/``pmax`` + slice
    otherwise).
  * :func:`sharded_pull` — per shard: all_gather the value vector, then
    privately combine ALL in-edges of the owned destinations. Three
    inner executors: ``dense`` (segment ops over the dst-grouped COO
    rows, keeping the single-device combine order), ``ell`` (gather and
    reduce over the shard's ELL row block) and ``cuda`` (the
    ``ell_spmv`` kernel on the same block, its plain version on CPU
    tensors; the JAX package calls it ``pallas``).

Message convention matches ``core.primitives``: ``msg_fn=None`` means
copy; ``msg_fn(x, w)`` receives the raw per-edge weight vector. The
values arrive as one ``[n_padded(,B)]`` tensor and leave as one, on the
caller's device; in between each shard works on its own device.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..core.backend import KERNEL_DTYPES, classify_msg_fn
from ..core.cost_model import COUNTER
from ..core.primitives import combine_identity, take_fill
from ..dist.collectives import (all_gather, merge_combine, reduce_scatter,
                                shard_blocks, unshard)
from ..dist.compression import CompressionConfig, compress_tree
from ..kernels.ell_spmv import ell_spmv
from ..sparse.segment import segment_max, segment_min, segment_sum
from .topology import ShardTopology

__all__ = ["sharded_push", "sharded_pull", "active_remote_edges",
           "INNERS"]

INNERS = ("dense", "ell", "cuda")

_SEGMENT = {"sum": segment_sum, "min": segment_min, "max": segment_max}


def _edge_messages(vals, w, msg_fn, combine, active):
    """Per-edge payloads, inactive slots carrying the combine identity."""
    msg = vals if msg_fn is None else msg_fn(vals, w)
    if msg.ndim == 2:
        active = active[:, None]
    return torch.where(active, msg, combine_identity(combine, msg.dtype))


def active_remote_edges(topo: ShardTopology,
                        frontier: torch.Tensor) -> torch.Tensor:
    """Number of cut edges whose source is in the frontier — the sparse
    wire-message count a real DM push would send as (index, value)
    pairs. ``frontier`` is the unpadded ``[n]`` mask; sentinel slots
    fall outside it and count as inactive."""
    src = topo.remote.src.reshape(-1)
    ok = topo.remote.valid.reshape(-1)
    act = take_fill(frontier, src, False)
    return (act & ok).to(COUNTER).sum()


def _scatter(msg, dst, ok, base, num_local, npad, combine, local: bool):
    """Segment-combine ``msg`` by destination; padding slots go to a
    trailing scratch row that is dropped (never aliasing a real vertex,
    which would perturb a sum's combine order)."""
    dst = dst.to(torch.int64)
    if local:
        seg = torch.where(ok, dst - base, num_local)
        return _SEGMENT[combine](msg, torch.clamp(seg, 0, num_local),
                                 num_local + 1)[:num_local]
    seg = torch.where(ok, dst, npad)
    return _SEGMENT[combine](msg, torch.clamp(seg, 0, npad),
                             npad + 1)[:npad]


def sharded_push(mesh, topo: ShardTopology, values_pad: torch.Tensor,
                 frontier_pad: torch.Tensor, combine: str = "sum",
                 msg_fn: Optional[Callable] = None, axis: str = "data",
                 cfg: Optional[CompressionConfig] = None,
                 err: Optional[tuple] = None):
    """Fused PA push step. ``values_pad``: ``[n_padded(,B)]``;
    ``frontier_pad``: ``bool[n_padded]``. When ``cfg``/``err`` are given
    (sum combine, 1-D float payload) each shard's remote accumulator is
    compressed with error feedback before the collective; ``err`` holds
    one ``[n_padded]`` float32 carry per shard, on its device. Returns
    ``(out [n_padded(,B)], new_err)`` — ``new_err`` is ``err`` (possibly
    None) when compression is off."""
    devices = mesh.devices
    part = topo.part
    shard, npad = part.shard_size, part.n_padded
    compressing = (cfg is not None and cfg.kind != "none"
                   and err is not None)

    def gather_side(vb, fb, e, base, local):
        src = e.src.to(torch.int64)
        lidx = torch.clamp(src - base, 0, shard - 1)
        act = e.valid & fb[lidx]
        msg = _edge_messages(vb[lidx], e.w, msg_fn, combine, act)
        return _scatter(msg, e.dst, e.valid, base, shard, npad, combine,
                        local)

    locs, accs, new_err = [], [], []
    for p, (vb, fb) in enumerate(zip(shard_blocks(values_pad, devices),
                                     shard_blocks(frontier_pad, devices))):
        base = p * shard
        locs.append(gather_side(vb, fb, topo.local_rows[p], base, True))
        acc = gather_side(vb, fb, topo.remote_rows[p], base, False)
        if compressing:
            # error feedback: send compress(acc + err), carry the rest
            acc, res = compress_tree(acc + err[p], torch.zeros_like(acc),
                                     cfg)
            new_err.append(res)
        accs.append(acc)
    rems = reduce_scatter(accs, devices, combine)
    out = unshard([merge_combine(combine, loc, rem)
                   for loc, rem in zip(locs, rems)], values_pad.device)
    return out, (tuple(new_err) if compressing else err)


def _pull_executor(inner: str, values_pad: torch.Tensor, combine: str,
                   msg_fn) -> tuple[str, Optional[str]]:
    """(executor, kernel message mode): ``cuda`` gives way to ``ell``,
    before any launch, for a cell the kernel does not cover (a msg_fn
    other than copy, mul or add, a dtype or rank it does not take)."""
    if inner != "cuda":
        return inner, None
    mode = classify_msg_fn(msg_fn)
    if (mode is None or values_pad.ndim not in (1, 2)
            or values_pad.dtype not in KERNEL_DTYPES):
        return "ell", None
    return "cuda", mode


def sharded_pull(mesh, topo: ShardTopology, values_pad: torch.Tensor,
                 combine: str = "sum", msg_fn: Optional[Callable] = None,
                 axis: str = "data", inner: str = "dense", n: int = 0,
                 stats: Optional[dict] = None) -> torch.Tensor:
    """Fused pull step: all_gather + private per-shard combine of ALL
    in-edges. ``inner`` picks the per-shard executor (``dense`` | ``ell``
    | ``cuda``); ``n`` is the true vertex count (the ELL sentinel and
    index validity bound). ``stats``, when given, counts the kernel
    launches (``kernel_pull``) and the ``cuda`` pulls that gave way to
    ``ell`` (``fallback_pull``). Returns ``[n_padded(,B)]``."""
    devices = mesh.devices
    part = topo.part
    shard, npad = part.shard_size, part.n_padded
    executor, mode = _pull_executor(inner, values_pad, combine, msg_fn)
    if stats is not None and executor != inner:
        stats["fallback_pull"] += 1
    fulls = all_gather(shard_blocks(values_pad, devices), devices)
    width = 1 if values_pad.ndim == 1 else values_pad.shape[1]
    outs = []
    for p, full in enumerate(fulls):
        if executor == "dense":
            e = topo.pull_rows[p]
            src = torch.clamp(e.src.to(torch.int64), 0, npad - 1)
            msg = _edge_messages(full[src], e.w, msg_fn, combine, e.valid)
            outs.append(_scatter(msg, e.dst, e.valid, p * shard, shard,
                                 npad, combine, local=True))
            continue
        fullp = torch.cat([full, full.new_zeros((1,) + full.shape[1:])])
        idx, w = topo.ell_idx[p], topo.ell_w[p]
        if executor == "cuda":
            outs.append(ell_spmv(
                fullp, idx, w, combine=combine, msg=mode, num_sources=n,
                block_n=min(256, shard),
                plan=topo.row_plan(p, width)).to(values_pad.dtype))
            if stats is not None:
                stats["kernel_pull"] += 1
            continue
        gathered = fullp[torch.clamp(idx.to(torch.int64), 0, npad)]
        if msg_fn is not None:
            gathered = msg_fn(gathered, w[..., None] if gathered.ndim == 3
                              else w)
        valid = idx < n
        if gathered.ndim == 3:
            valid = valid[..., None]
        gathered = torch.where(valid, gathered,
                               combine_identity(combine, gathered.dtype))
        if combine == "sum":
            outs.append(gathered.sum(dim=1).to(values_pad.dtype))
        elif combine == "max":
            outs.append(gathered.amax(dim=1))
        else:
            outs.append(gathered.amin(dim=1))
    return unshard(outs, values_pad.device)
