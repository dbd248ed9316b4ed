"""Result caching for the serving layer. PyTorch port of
``repro.service.cache``.

``graph_fingerprint`` gives a stable identity for a graph (shape plus
position-sensitive edge and weight checksums, computed once per live
graph object: the COO arrays are copied to the host once), so cache keys
survive across ``QueryService`` instances and tell apart graphs of one
shape. ``ResultCache`` is a plain LRU with hit/miss counters.
"""

from __future__ import annotations

import weakref
import zlib
from collections import OrderedDict
from typing import Any, Hashable, Optional

import numpy as np

__all__ = ["graph_fingerprint", "ResultCache"]

# id -> fingerprint; entries evicted by weakref.finalize when the graph
# object dies, so a recycled id can never alias a stale fingerprint
_FP_BY_ID: dict[int, tuple] = {}


def graph_fingerprint(g) -> tuple:
    """A hashable identity for ``g``: (n, m, d_ell, edge checksum,
    weight checksum). Computed once per live graph object."""
    key = id(g)
    fp = _FP_BY_ID.get(key)
    if fp is None:
        src = np.ascontiguousarray(g.coo_src.cpu().numpy(), np.int32)
        dst = np.ascontiguousarray(g.coo_dst.cpu().numpy(), np.int32)
        w = np.ascontiguousarray(g.coo_w.cpu().numpy(), np.float32)
        edges = zlib.crc32(dst.tobytes(), zlib.crc32(src.tobytes()))
        weights = zlib.crc32(w.tobytes())
        fp = (int(g.n), int(g.m), int(g.d_ell), edges, weights)
        _FP_BY_ID[key] = fp
        weakref.finalize(g, _FP_BY_ID.pop, key, None)
    return fp


class ResultCache:
    """Bounded LRU of finished query results: ``get`` refreshes recency,
    ``put`` evicts the least recently used entry past ``capacity``."""

    def __init__(self, capacity: int = 256):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._data: OrderedDict[Hashable, Any] = OrderedDict()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key) -> bool:
        return key in self._data

    def get(self, key) -> Optional[Any]:
        if key in self._data:
            self._data.move_to_end(key)
            self.hits += 1
            return self._data[key]
        self.misses += 1
        return None

    def put(self, key, value) -> None:
        self._data[key] = value
        self._data.move_to_end(key)
        while len(self._data) > self.capacity:
            self._data.popitem(last=False)

    def stats(self) -> dict:
        return {"size": len(self._data), "capacity": self.capacity,
                "hits": self.hits, "misses": self.misses}
