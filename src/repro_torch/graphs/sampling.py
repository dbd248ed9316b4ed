"""Neighbor sampling (GraphSAGE-style fanout) — paper §5 Frontier-Exploit
made into a data-pipeline primitive. PyTorch port of
``repro.graphs.sampling``.

Sampling *is* Frontier-Exploit: instead of touching all m edges per layer
(pull over the full graph), we push outward from a seed frontier and touch
only ``batch * prod(fanouts)`` edges. The sampler runs on the graph's
device with static output shapes.

Output layout per hop k (seeds = hop 0):
  nodes[k]: int32[batch * prod(fanout[:k])] node ids (sentinel n = pad)
  For each hop k>=1, edge (nodes[k][i], nodes[k-1][i // fanout[k-1]])
  is a sampled in-edge of its parent — exactly the bipartite block a
  GraphSAGE layer consumes.

The reference draws its uniforms with ``jax.random.uniform``, which
PyTorch cannot replay; here they are an argument (``u`` per hop, any
float dtype, used as given), or drawn in float64 from an explicit
``torch.Generator`` on the graph's device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

__all__ = ["SampledBlocks", "sample_neighbors", "sample_blocks"]


@dataclasses.dataclass(frozen=True, eq=False)
class SampledBlocks:
    """Layered bipartite blocks for an L-hop sampled minibatch."""
    node_ids: tuple          # per hop, int32[n_k]
    valid: tuple             # per hop, bool[n_k]
    fanouts: tuple
    sentinel: int

    @property
    def num_hops(self) -> int:
        return len(self.fanouts)


def _draw(gen: Optional[torch.Generator], shape, device) -> torch.Tensor:
    if gen is None:
        raise ValueError("pass the uniforms (u) or a torch.Generator (gen) "
                         "to draw them from")
    return torch.rand(shape, generator=gen, dtype=torch.float64,
                      device=device)


def sample_neighbors(g, nodes: torch.Tensor, valid: torch.Tensor,
                     fanout: int, u: Optional[torch.Tensor] = None,
                     gen: Optional[torch.Generator] = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Uniformly sample ``fanout`` in-neighbors of each node (with
    replacement, the standard GraphSAGE estimator). Invalid/isolated nodes
    yield sentinel children. ``u``: uniforms in [0, 1) of shape
    ``[len(nodes), fanout]``; drawn from ``gen`` when not given."""
    dev = g.coo_src.device
    nodes = nodes.to(dev)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    at = torch.clamp(nodes.to(torch.int64), max=g.n)
    deg = torch.cat([g.in_deg, zero])[at]
    start = torch.cat([g.in_ptr[:-1], zero])[at]
    if u is None:
        u = _draw(gen, (nodes.shape[0], fanout), dev)
    u = torch.as_tensor(u, device=dev)
    offs = torch.floor(u * torch.clamp(deg, min=1)[:, None]).to(torch.int32)
    slots = start[:, None] + offs
    child = g.coo_src[torch.clamp(slots, 0, g.m - 1).to(torch.int64)]
    ok = ((valid.to(dev) & (deg > 0))[:, None]).expand(nodes.shape[0],
                                                       fanout)
    child = torch.where(ok, child, torch.full_like(child, g.n))
    return child.reshape(-1), ok.reshape(-1)


def sample_blocks(g, seeds: torch.Tensor, fanouts: Sequence[int],
                  gen: Optional[torch.Generator] = None,
                  uniforms: Optional[Sequence] = None) -> SampledBlocks:
    """L-hop fanout sampling from ``seeds`` (int[batch]). ``uniforms``:
    one ``u`` per hop (see :func:`sample_neighbors`); drawn from ``gen``
    when not given."""
    fanouts = tuple(int(f) for f in fanouts)
    if uniforms is not None and len(uniforms) != len(fanouts):
        raise ValueError(f"{len(uniforms)} uniform arrays for "
                         f"{len(fanouts)} hops")
    seeds = torch.as_tensor(seeds, device=g.coo_src.device)
    nodes = [seeds.to(torch.int32)]
    valid = [seeds < g.n]
    for k, f in enumerate(fanouts):
        child, ok = sample_neighbors(
            g, nodes[-1], valid[-1], f,
            u=None if uniforms is None else uniforms[k], gen=gen)
        nodes.append(child)
        valid.append(ok)
    return SampledBlocks(node_ids=tuple(nodes), valid=tuple(valid),
                         fanouts=fanouts, sentinel=g.n)
