"""repro_torch.shard — the engine's k-relaxation sharded over a device
list. PyTorch port of ``repro.shard``.

The paper's §6 DM setting: a 1D vertex partition, the Partition-Aware
local/remote edge split, fused push and pull exchanges (the push
optionally compressed with error feedback), and adaptive wire-byte
accounting that lets ``AutoSwitch`` flip direction for communication
reasons alone. One controller drives P shards, each on a device of its
own or several on one card.

Entry points: ``ShardedBackend.prepare(g, ...)`` or
``api.solve(g, algo, backend="shard")``.
"""

from .backend import ShardedBackend
from .exchange import active_remote_edges, sharded_pull, sharded_push
from .mesh import ShardMesh, make_shard_mesh
from .topology import ShardTopology, build_topology

__all__ = ["ShardedBackend", "ShardMesh", "make_shard_mesh",
           "ShardTopology", "build_topology", "sharded_push",
           "sharded_pull", "active_remote_edges"]
