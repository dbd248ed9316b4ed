"""Distributed-memory layer (paper §6): the PA exchanges and their
collectives, compression with error feedback, and the overlap
primitives, and the sharding rules. PyTorch port of ``repro.dist``.

The graph side consumes ``collectives`` through
``repro_torch.core.backend.DistributedBackend`` and the sharded engine
(``repro_torch.shard``), which also compresses its push with
``compression``; the training side consumes ``compression`` and
``overlap`` through ``repro_torch.train.loop``; the models read the
activation mesh of ``sharding`` (``models.moe``'s expert parallelism);
the cell registry (``configs.steps``) and the dry run read its parameter
specs and the collectives' wire counter.
"""

from .compression import (CompressionConfig, compress_tree,
                          compressed_bytes, init_error_state)
from .overlap import microbatch_grads, ring_allreduce_psum
from . import collectives, compression, overlap, sharding

__all__ = ["CompressionConfig", "compress_tree", "compressed_bytes",
           "init_error_state", "microbatch_grads", "ring_allreduce_psum",
           "collectives", "compression", "overlap", "sharding"]
