"""Device mesh of the sharded engine (paper §6 DM setting). PyTorch port
of ``repro.shard.mesh``.

One controller drives P shards: a :class:`ShardMesh` is the list of
devices, shard p on ``devices[p]``, with the reference's ``(P, 1)``
shape over axes ``(axis, "model")`` (``axis="model"`` gives the
expert-parallel mesh of ``models.moe``: ``{"model": P}``). The list may
repeat a device: four shards on one card run the same program as four
shards on four cards, their transfers being nothing instead of peer
copies, and the tests run P shards on ``[torch.device("cpu")] * P``. The mesh is not built on
``torch.distributed``: NCCL puts no two ranks on one GPU, and a gloo
group on the CPU would run another program than the card's.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["ShardMesh", "make_shard_mesh"]


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """P shards over ``devices`` (one per shard, repeats allowed); all
    exchanges run along ``axis``."""
    devices: tuple
    axis: str = "data"

    @property
    def shape(self) -> dict:
        """Axis sizes: the named axis holds the P shards, and a trivial
        "model" axis is added unless the named axis is "model"."""
        shape = {self.axis: len(self.devices)}
        shape.setdefault("model", 1)
        return shape

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    @property
    def size(self) -> int:
        return len(self.devices)


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_shard_mesh(num_shards: int | None = None, axis: str = "data",
                    devices=None) -> ShardMesh:
    """Build the mesh the sharded backend runs under.

    ``devices=None`` takes every visible CUDA device, and raises without
    CUDA (there is no quiet CPU mesh); a caller may pass any list,
    repeats included (``[torch.device("cuda")] * 4`` puts four shards on
    one card). ``num_shards=None`` takes one shard per listed device.
    Rejects fewer than one shard and more shards than listed devices.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: pass devices=[torch.device(\"cpu\")]"
                " * P to run P shards on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
    P = len(devices) if num_shards is None else num_shards
    if P < 1:
        raise ValueError(
            f"num_shards={P} is invalid: a mesh needs at least one shard")
    if P > len(devices):
        raise ValueError(
            f"num_shards={P} exceeds the {len(devices)} devices in "
            f"`devices`; list a device once per shard (e.g. devices="
            f"[torch.device(\"cuda\")] * {P} for {P} shards on one card)")
    return ShardMesh(devices=tuple(devices[:P]), axis=axis)
