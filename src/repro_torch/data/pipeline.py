"""Synthetic data pipelines with background prefetch (port of
``repro.data.pipeline``).

The generators draw the reference's numpy streams (the same seed gives
the same numbers) and yield host tensors; the background thread of
:class:`Prefetcher` keeps a bounded queue of them, and the training loop
moves each batch to the device.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

__all__ = ["token_batches", "recsys_batches", "molecule_batches",
           "Prefetcher", "prefetch"]


def _host(a: np.ndarray, dtype=None) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype))


def token_batches(batch: int, seq: int, vocab: int, seed: int = 0
                  ) -> Iterator[dict]:
    """Zipf-ish synthetic LM stream: markov-free but skewed unigram."""
    rng = np.random.default_rng(seed)
    probs = 1.0 / np.arange(1, vocab + 1) ** 1.1
    probs /= probs.sum()
    while True:
        toks = rng.choice(vocab, size=(batch, seq + 1), p=probs)
        yield {"tokens": _host(toks[:, :-1], np.int32),
               "labels": _host(toks[:, 1:], np.int32)}


def recsys_batches(batch: int, n_fields: int, vocab: int, seed: int = 0
                   ) -> Iterator[dict]:
    rng = np.random.default_rng(seed)
    while True:
        ids = rng.integers(0, vocab, size=(batch, n_fields), dtype=np.int32)
        # synthetic CTR: a planted linear rule over a few fields
        sig = (ids[:, 0] % 7 == 0) | (ids[:, 1] % 11 == 0)
        noise = rng.random(batch) < 0.1
        y = (sig ^ noise).astype(np.float32)
        yield {"ids": _host(ids), "labels": _host(y)}


def molecule_batches(batch: int, n_nodes: int, n_edges: int, d_feat: int,
                     seed: int = 0) -> Iterator[dict]:
    """Batched small graphs (the `molecule` shape): one disjoint union per
    batch with graph_ids for pooling."""
    rng = np.random.default_rng(seed)
    while True:
        srcs, dsts, gids = [], [], []
        for b in range(batch):
            s = rng.integers(0, n_nodes, n_edges // 2)
            d = rng.integers(0, n_nodes, n_edges // 2)
            off = b * n_nodes
            srcs += [s + off, d + off]
            dsts += [d + off, s + off]
            gids.append(np.full(n_nodes, b))
        feats = rng.normal(size=(batch * n_nodes, d_feat)).astype(np.float32)
        coords = rng.normal(size=(batch * n_nodes, 3)).astype(np.float32)
        y = rng.normal(size=(batch,)).astype(np.float32)
        yield {"src": _host(np.concatenate(srcs), np.int32),
               "dst": _host(np.concatenate(dsts), np.int32),
               "graph_ids": _host(np.concatenate(gids), np.int32),
               "feats": _host(feats), "coords": _host(coords),
               "labels": _host(y)}


class Prefetcher:
    """Background-thread prefetch with bounded queue (straggler shield:
    data hiccups don't stall the step as long as the buffer holds)."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._done = False
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        try:
            for item in self._it:
                if self._done:
                    return
                self._q.put(item)
        finally:
            self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self):
        self._done = True


def prefetch(it: Iterator, depth: int = 2) -> Prefetcher:
    return Prefetcher(it, depth)
