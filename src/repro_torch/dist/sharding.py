"""Sharding rules and activation-sharding hints (DM layer, paper §2.2).
PyTorch port of ``repro.dist.sharding``.

The paper's distributed-memory setting assigns each process a contiguous
block of vertices (1D decomposition); the same convention governs how
tensors spread over a device mesh:

  * batch-like leading dims shard over the flattened ('pod', 'data') axes
    (whichever exist in the mesh) — ``batch_axes``/``BATCH``;
  * model-parallel dims shard over 'model' (Megatron split for
    transformer blocks, expert-parallel for MoE, table rows for recsys).

**Parameter specs.** :func:`make_sharding` returns a plain :class:`Spec`,
a tuple of one entry per dim (None, an axis name or a tuple of names),
with the axes that do not exist or do not divide the dim dropped, as the
reference's ``NamedSharding`` keeps them. :func:`shard_shape` and
:func:`tree_bytes_per_device` read what one device holds.
:func:`transformer_param_specs` and :func:`recsys_param_specs` apply the
reference's rules to the port's trees. The reference stacks transformer
layers on a leading [L] axis and spreads it over the data axes under
``zero="pull"``; the port keeps a list of per-layer leaves, so a layer
leaf's spec is a :class:`LayerSpec`: the entry the layer index takes
(the stacked axis's, dropped when the layer count does not divide) and
the spec of the leaf's own dims. A device then holds its share of the
layers: the same bytes per device as the reference's stacked leaf.

**Activations.** The reference annotates activations against an
installed mesh, and XLA's partitioner lays tensors out to match. One
controller drives the port's mesh
(:class:`~repro_torch.shard.mesh.ShardMesh`): a tensor lies on one
device, and whatever runs per shard does so explicitly (``models.moe``'s
``moe_apply_ep`` reads the installed mesh to split experts over its
"model" axis). So :func:`hint` returns its input unchanged, mesh or no
mesh; it is kept so the models read as the reference's do.
"""

from __future__ import annotations

import math
from fractions import Fraction
from typing import Any, NamedTuple, Optional

import torch

__all__ = ["BATCH", "hint", "set_activation_mesh", "get_activation_mesh",
           "batch_axes", "Spec", "LayerSpec", "REPLICATED", "make_sharding",
           "shard_shape", "tree_bytes_per_device", "transformer_param_specs",
           "recsys_param_specs"]

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


class Spec(tuple):
    """A partition spec: one entry per dim, each None (replicated), an
    axis name or a tuple of axis names (flattened, in order)."""

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


# every dim replicated, whatever the leaf's rank
REPLICATED = Spec()


class LayerSpec(NamedTuple):
    """A per-layer leaf: ``layer`` is the entry of the layer index (the
    reference's stacked [L] axis), ``spec`` the leaf's own dims'."""
    layer: Any
    spec: Spec


def _names(entry) -> tuple:
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _axis_size(mesh, entry) -> int:
    if entry is None:
        return 1
    return math.prod(mesh.shape[a] for a in _names(entry))


def _sanitize_entry(mesh, entry, dim_size: int):
    """Keep only mesh axes that exist and evenly divide ``dim_size``."""
    if entry is None:
        return None
    names = tuple(a for a in _names(entry) if a in mesh.axis_names)
    if not names:
        return None
    if dim_size % _axis_size(mesh, names) != 0:
        return None
    return names[0] if len(names) == 1 else names


def make_sharding(mesh, spec, shape: tuple) -> Spec:
    """The spec for ``shape`` with non-dividing and absent axes dropped
    (the reference returns a ``NamedSharding`` of these entries)."""
    return Spec(_sanitize_entry(mesh, spec[dim] if dim < len(spec) else None,
                                size) for dim, size in enumerate(shape))


def shard_shape(mesh, spec: Spec, shape: tuple) -> tuple:
    """The block of ``shape`` one device holds under ``spec``."""
    return tuple(size // _axis_size(mesh, spec[d] if d < len(spec) else None)
                 for d, size in enumerate(shape))


def _leaf_bytes(mesh, spec, t: torch.Tensor) -> Fraction:
    item = t.element_size()
    if isinstance(spec, LayerSpec):
        return Fraction(math.prod(shard_shape(mesh, spec.spec, t.shape))
                        * item, _axis_size(mesh, spec.layer))
    return Fraction(math.prod(shard_shape(mesh, spec, t.shape)) * item)


def _pairs(spec, tree):
    """(spec, tensor) for every tensor of ``tree``; a :class:`Spec` or
    :class:`LayerSpec` applies to the whole subtree it stands for."""
    if isinstance(tree, torch.Tensor) or isinstance(spec, (Spec, LayerSpec)):
        if isinstance(tree, torch.Tensor):
            yield spec, tree
            return
        if isinstance(tree, dict):
            for k in tree:
                yield from _pairs(spec, tree[k])
        elif isinstance(tree, (list, tuple)):
            for t in tree:
                yield from _pairs(spec, t)
        return
    if isinstance(tree, dict):
        for k in tree:
            yield from _pairs(spec[k], tree[k])
    elif isinstance(tree, (list, tuple)):
        if len(spec) != len(tree):
            raise ValueError(f"spec has {len(spec)} entries for a tree of "
                             f"{len(tree)}")
        for s, t in zip(spec, tree):
            yield from _pairs(s, t)


def tree_bytes_per_device(mesh, specs, tree) -> int:
    """Bytes one device holds of the tensors of ``tree`` under ``specs``
    (a tree of the same structure, or one spec for a subtree)."""
    total = sum((_leaf_bytes(mesh, s, t) for s, t in _pairs(specs, tree)),
                Fraction(0))
    if total.denominator != 1:
        raise ValueError(f"layers do not split evenly: {total} bytes")
    return int(total)


# ------------------------------------------------------- param specs --
def _zero_axes(mesh, zero: str) -> tuple:
    """ZeRO-style parameter sharding axes.

    'pull' — optimizer/parameter state shards over the data axes and is
    all-gathered (pulled) at use; 'push' — parameters stay replicated and
    gradients are pushed (reduce-scattered) only. Mirrors the paper's
    read-redundancy vs write-combining trade."""
    return batch_axes(mesh) if zero == "pull" else ()


def _transformer_entries(keys: list, nd: int, zero_ax: tuple) -> list:
    """The reference's rule for a leaf of rank ``nd`` at dict path
    ``keys`` (stacked layer leaves counted with their [L] axis)."""
    entries = [None] * nd
    name = keys[-1] if keys else ""
    if name == "w":
        name = keys[-2] if len(keys) >= 2 else ""
    if name == "embed":
        entries[0] = "model"                     # [V, D] vocab-parallel
    elif name in ("wq", "wk", "wv", "wi", "wg", "unembed"):
        entries[nd - 1] = "model"                # output-dim split
    elif name == "wo" and nd >= 2:
        entries[nd - 2] = "model"                # input-dim split
    elif zero_ax and nd >= 1:
        entries[0] = zero_ax
    if zero_ax and nd >= 2 and entries[0] is None and name in (
            "wq", "wk", "wv", "wi", "wg", "wo"):
        entries[0] = zero_ax                     # leading L axis over data
    return entries


def _map_with_keys(fn, tree, keys=()):
    """``fn(dict keys on the path, leaf)`` over a nested dict / list."""
    if isinstance(tree, dict):
        return {k: _map_with_keys(fn, v, keys + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_with_keys(fn, v, keys) for v in tree]
    return fn(list(keys), tree)


def transformer_param_specs(mesh, params: Any, zero: str = "pull") -> Any:
    """Megatron-style spec tree for the port's transformer params.

    Column-parallel wq/wk/wv/wi/wg + embeddings, row-parallel wo,
    replicated norms; ``zero='pull'`` additionally spreads the layers
    over the data axes when their count divides (a :class:`LayerSpec`
    per layer leaf)."""
    zero_ax = _zero_axes(mesh, zero)
    n_layers = len(params["layers"])

    def layer_leaf(keys, leaf):
        shape = (n_layers, *leaf.shape)
        spec = make_sharding(mesh, _transformer_entries(
            ["layers", *keys], len(shape), zero_ax), shape)
        return LayerSpec(layer=spec[0], spec=Spec(spec[1:]))

    out = {k: _map_with_keys(lambda keys, leaf, k=k: make_sharding(
        mesh, _transformer_entries([k, *keys], leaf.ndim, zero_ax),
        leaf.shape), v) for k, v in params.items() if k != "layers"}
    out["layers"] = [_map_with_keys(layer_leaf, lp)
                     for lp in params["layers"]]
    return {k: out[k] for k in params}


def recsys_param_specs(mesh, params: Any) -> Any:
    """xDeepFM: embedding tables row-shard over 'model' (the dominant
    memory), dense towers replicate."""

    def one(keys, leaf):
        entries = [None] * leaf.ndim
        if any(k in ("tables", "table", "embed") for k in keys) and entries:
            entries[0] = "model"
        return make_sharding(mesh, entries, leaf.shape)

    return _map_with_keys(one, params)
