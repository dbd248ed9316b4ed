"""Cell registry: enumerate and build every assigned (arch × shape) cell.
PyTorch port of ``repro.configs.registry``.

``build_cell`` installs the activation mesh the models run over, as the
reference's does before it traces: for a
:class:`~repro_torch.launch.mesh.MeshLayout` (the production layout), a
:class:`~repro_torch.shard.mesh.ShardMesh` with one shard per device of
its "model" axis, every shard on the cell's ``device`` (``meta`` in the
dry run), so that ``moe_apply_ep`` runs its expert-parallel schedule; a
``ShardMesh`` is installed as it is.
"""

from __future__ import annotations

from typing import Optional

from ..dist.sharding import set_activation_mesh
from ..graphs.structure import resolve_device
from ..launch.mesh import MeshLayout
from ..shard.mesh import ShardMesh
from .archs import ALL_ARCHS, ARCH_FAMILY, full_config, smoke_config
from .shapes import shape_table
from .steps import BuiltCell, build_gnn_cell, build_lm_cell, build_recsys_cell

__all__ = ["all_cells", "build_cell", "ALL_ARCHS", "ARCH_FAMILY",
           "full_config", "smoke_config"]


def all_cells() -> list[tuple[str, str]]:
    """The 40 assigned (arch, shape) pairs."""
    cells = []
    for arch in ALL_ARCHS:
        for shape_name in shape_table(ARCH_FAMILY[arch]):
            cells.append((arch, shape_name))
    return cells


def activation_mesh(mesh, device="meta"):
    """The mesh the models run over for a cell built on ``mesh``."""
    if isinstance(mesh, MeshLayout):
        return ShardMesh(devices=(resolve_device(device),)
                         * mesh.shape.get("model", 1), axis="model")
    return mesh


def build_cell(arch: str, shape_name: str, mesh,
               overrides: Optional[dict] = None,
               direction: str = "pull", zero: str = "pull",
               device="meta", seed: int = 0) -> BuiltCell:
    family = ARCH_FAMILY[arch]
    shape = shape_table(family)[shape_name]
    set_activation_mesh(activation_mesh(mesh, device))
    if family == "lm":
        return build_lm_cell(arch, shape, mesh, zero=zero,
                             overrides=overrides, device=device, seed=seed)
    if family == "gnn":
        return build_gnn_cell(arch, shape, mesh, direction=direction,
                              overrides=overrides, device=device, seed=seed)
    return build_recsys_cell(arch, shape, mesh, device=device, seed=seed)
