"""Activation-sharding hints (DM layer, paper §2.2). PyTorch port of the
activation side of ``repro.dist.sharding``.

The reference annotates activations against an installed mesh, and XLA's
partitioner lays tensors out to match. One controller drives the port's
mesh (:class:`~repro_torch.shard.mesh.ShardMesh`): a tensor lies on one
device, and whatever runs per shard does so explicitly (``models.moe``'s
``moe_apply_ep`` reads the installed mesh to split experts over its
"model" axis). So :func:`hint` returns its input unchanged, mesh or no
mesh; it is kept so the models read as the reference's do.

The reference's ``make_sharding``, ``transformer_param_specs`` and
``recsys_param_specs`` build ``NamedSharding`` trees for the compiled
cells; they wait for the cell registry and dry run.
"""

from __future__ import annotations

from typing import Optional

__all__ = ["BATCH", "hint", "set_activation_mesh", "get_activation_mesh",
           "batch_axes"]

# Sentinel axis name: "the flattened batch axes of the active mesh".
BATCH = "__batch__"

# Installed by callers that run a model over a mesh; models read it.
_ACT_MESH = None


def set_activation_mesh(mesh) -> None:
    """Install (or clear, with None) the mesh models run over."""
    global _ACT_MESH
    _ACT_MESH = mesh


def get_activation_mesh() -> Optional[object]:
    return _ACT_MESH


def batch_axes(mesh) -> tuple:
    """The data-parallel axes present in ``mesh``."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def hint(x, *axes):
    """The reference's sharding annotation: on one controller, ``x``."""
    return x
