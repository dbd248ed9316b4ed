"""Communication/computation overlap primitives (paper §2.3, §6). PyTorch
port of ``repro.dist.overlap``.

:func:`ring_allreduce_psum` is an explicit ring all-reduce
(reduce-scatter + all-gather over hops along the ring) on the port's
one-controller mesh: the P per-shard tensors are a list, shard p's on
its own device, and a hop is ``.to(device)`` (a peer copy between
cards, nothing at all between shards of one card), as
``dist/collectives.py`` does for the graph side. :func:`microbatch_grads`
is the training-side overlap: gradients of microbatch i are ready to
exchange while microbatch i+1 is still in backward.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence

import torch

from ..models.common import tree_leaves

__all__ = ["ring_allreduce_psum", "microbatch_grads", "value_and_grad"]


def _hop(vals: list, devices: Sequence) -> list:
    """One step along the ring p -> p + 1: shard p receives shard p - 1's
    value."""
    P = len(vals)
    return [vals[(p - 1) % P].to(devices[p], non_blocking=True)
            for p in range(P)]


def ring_allreduce_psum(xs: Sequence[torch.Tensor],
                        devices: Optional[Sequence] = None
                        ) -> list[torch.Tensor]:
    """All-reduce the per-shard flat tensors ``xs`` (shard p's on
    ``devices[p]``, by default its own device) with an explicit ring;
    returns every shard's copy of the sum. When the length divides the
    shard count this is the bandwidth-optimal two-phase ring
    (reduce-scatter then all-gather); otherwise a rotate-accumulate
    ring."""
    P = len(xs)
    devices = list(devices) if devices is not None else [x.device
                                                         for x in xs]
    if P == 1:
        return list(xs)
    n = xs[0].shape[0]
    if n % P != 0:
        acc, cur = list(xs), list(xs)
        for _ in range(P - 1):
            cur = _hop(cur, devices)
            acc = [a + c for a, c in zip(acc, cur)]
        return acc

    chunks = [x.reshape(P, -1) for x in xs]
    # reduce-scatter: after P-1 hops shard p holds chunk (p+1) % P fully
    # reduced (each hop: forward the partial, add the local copy)
    acc = [chunks[p][p] for p in range(P)]
    for s in range(P - 1):
        acc = _hop(acc, devices)
        acc = [acc[p] + chunks[p][(p - 1 - s) % P] for p in range(P)]
    # all-gather: circulate the reduced chunks around the same ring
    out = [torch.zeros_like(c) for c in chunks]
    for p in range(P):
        out[p][(p + 1) % P] = acc[p]
    cur = acc
    for s in range(P - 1):
        cur = _hop(cur, devices)
        for p in range(P):
            out[p][(p - s) % P] = cur[p]
    return [o.reshape(x.shape) for o, x in zip(out, xs)]


def _tree_map(fn: Callable, *trees):
    """``fn`` over the leaves of trees of one structure (dicts, lists,
    tuples), keeping each container's type."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _unflatten(tree: Any, leaves: list) -> Any:
    """A tree of ``tree``'s structure with ``leaves`` in the order of
    ``models.common.tree_leaves`` (dict keys sorted)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it) if isinstance(t, torch.Tensor) else t

    return build(tree)


def value_and_grad(loss_fn: Callable, params: Any, batch: Any
                   ) -> tuple[torch.Tensor, Any]:
    """``(loss, grads)`` of ``loss_fn(params, batch)``, grads shaped like
    ``params`` (zeros where the loss does not reach a leaf). Leaves that
    do not require grad are differentiated through detached copies; a
    leaf that requires it (a training loop's own parameters) is used as
    it is, so kernel caches keyed on the tensor stay warm."""
    leaves = tree_leaves(params)
    live = [p if p.requires_grad else p.detach().requires_grad_()
            for p in leaves]
    tree = _unflatten(params, live)
    with torch.enable_grad():
        loss = loss_fn(tree, batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(live, grads)]
    return loss.detach(), _unflatten(params, grads)


def microbatch_grads(loss_fn: Callable, params: Any, batch: Any,
                     num_micro: int) -> tuple[Any, torch.Tensor]:
    """Gradient accumulation over ``num_micro`` equal slices of ``batch``
    (each leaf split on its leading axis, which must divide).

    Returns ``(grads, loss)``, both means over microbatches, equal to
    the full-batch quantities when the loss is a batch mean. The
    microbatches run one after another, accumulating in the gradients'
    dtype, as the reference's ``lax.scan`` does."""

    def split(leaf):
        b = leaf.shape[0]
        if b % num_micro != 0:
            raise ValueError(
                f"batch dim {b} not divisible by num_micro={num_micro}")
        return leaf.reshape(num_micro, b // num_micro, *leaf.shape[1:])

    micro = _tree_map(split, batch)
    g_acc, l_acc = None, None
    for i in range(num_micro):
        mb = _tree_map(lambda leaf, i=i: leaf[i], micro)
        loss, g = value_and_grad(loss_fn, params, mb)
        if g_acc is None:
            g_acc, l_acc = g, loss.float()
        else:
            _tree_map(lambda a, b: a.add_(b), g_acc, g)
            l_acc = l_acc + loss
    inv = 1.0 / num_micro
    return _tree_map(lambda g: g * inv, g_acc), l_acc * inv
