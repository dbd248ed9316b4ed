"""Synthetic training data (port of ``repro.data``): host tensors from
the reference's numpy streams, prefetched by a background thread."""

from .pipeline import (token_batches, recsys_batches, molecule_batches,
                       Prefetcher, prefetch)

__all__ = ["token_batches", "recsys_batches", "molecule_batches",
           "Prefetcher", "prefetch"]
