"""Distributed-memory layer (paper §6), graph side: the PA exchanges and
their collectives, and compression with error feedback. PyTorch port of
the graph side of ``repro.dist``.

The graph side consumes ``collectives`` through
``repro_torch.core.backend.DistributedBackend`` and the sharded engine
(``repro_torch.shard``), which also compresses its push with
``compression``. The JAX package's training-side ``sharding`` and
``overlap`` belong with the training loop and are not ported yet.
"""

from .compression import (CompressionConfig, compress_tree,
                          compressed_bytes, init_error_state)
from . import collectives, compression

__all__ = ["CompressionConfig", "compress_tree", "compressed_bytes",
           "init_error_state", "collectives", "compression"]
