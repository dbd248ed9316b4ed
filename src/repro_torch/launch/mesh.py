"""Production meshes (port of ``repro.launch.mesh``). Functions only:
importing this module touches no device.

The reference's production mesh is 16×16 TPU chips a pod (512 with
``multi_pod``). One controller does not run 512 shards, so the port's
:func:`make_production_mesh` is the layout alone, :class:`MeshLayout`:
axis names and sizes, which are all the parameter specs
(``dist.sharding``) and the cells (``configs.steps``) read.
:func:`make_local_mesh` is a :class:`~repro_torch.shard.mesh.ShardMesh`
over this host's cards, as the reference's is over its devices.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..shard.mesh import ShardMesh, make_shard_mesh

__all__ = ["MeshLayout", "make_production_mesh", "make_local_mesh"]


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """A device-free mesh: axis names in order and their sizes."""
    axes: tuple

    @property
    def shape(self) -> dict:
        return dict(self.axes)

    @property
    def axis_names(self) -> tuple:
        return tuple(name for name, _ in self.axes)

    @property
    def size(self) -> int:
        return math.prod(n for _, n in self.axes)


def make_production_mesh(*, multi_pod: bool = False) -> MeshLayout:
    """The pod layout: ("data", "model") = (16, 16), 256 devices; with
    ``multi_pod`` a leading ("pod", 2), 512 devices."""
    axes = (("data", 16), ("model", 16))
    return MeshLayout((("pod", 2),) + axes if multi_pod else axes)


def make_local_mesh() -> ShardMesh:
    """Every local card as one shard of the "data" axis, ("data",
    "model") = (n, 1). Raises without CUDA."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: make_local_mesh takes "
                           "the local cards; build a ShardMesh over "
                           "[torch.device(\"cpu\")] * P to run P shards "
                           "on the CPU")
    return make_shard_mesh()
