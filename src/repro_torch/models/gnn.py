"""GNN architectures: EGNN, GIN, GraphSAGE (full + sampled), GraphCast-EPD.
PyTorch port of ``repro.models.gnn``.

Message passing is built on the paper's machinery: with every vertex
active, a layer is one k-relaxation — **pull** reduces the pull-major
(CSR) edge order per destination, **push** scatter-combines the push-major
(CSC) order. Identical math, different access structure; `direction`
selects it per layer.

Edge messages that need BOTH endpoints (EGNN, GraphCast) are computed
edge-parallel (gather src + gather dst -> edge MLP -> segment reduce);
`direction` then picks which sorted edge order the reduction runs over —
exactly the CSR/CSC dichotomy of §7.1 applied to an edge-featured MPNN.

The reductions are ``sparse.segment``'s ``segment_sum`` and
``segment_mean`` over the chosen order, as in the reference (on the card
a float32 sum accumulates in float64, a chunk of edges at a time).
Parameters are the reference's trees (lists of layers; GraphCast's layer
norms are ``[scale, bias]`` pairs); :func:`params_from_arrays` carries
the reference's across as numpy arrays. :func:`gin_apply_mp` runs over
the port's one-controller :class:`~repro_torch.shard.mesh.ShardMesh`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..dist.collectives import all_gather, shard_blocks, unshard
from ..graphs.sampling import SampledBlocks
from ..graphs.structure import resolve_device
from ..sparse.segment import segment_mean, segment_sum
from .common import (generator, layer_norm, mlp_apply, mlp_init, silu,
                     tree_from_arrays, tree_map)

__all__ = ["GNNConfig", "params_from_arrays",
           "egnn_init", "egnn_apply", "gin_init", "gin_apply",
           "gin_apply_mp",
           "sage_init", "sage_apply", "sage_apply_blocks",
           "graphcast_init", "graphcast_apply"]


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    arch: str
    n_layers: int
    d_hidden: int
    d_in: int
    d_out: int
    direction: str = "pull"          # 'pull' | 'push' edge-reduce order
    aggregator: str = "sum"          # gin: sum; sage: mean
    gin_eps_learnable: bool = True
    n_vars: int = 227                # graphcast
    fanouts: tuple[int, ...] = (25, 10)   # sage sampling
    dtype: str = "float32"

    @property
    def torch_dtype(self) -> torch.dtype:
        """``torch.<dtype>``: "float32" or "bfloat16" as in the reference;
        "float64" runs a high-precision forward to compare against."""
        return getattr(torch, self.dtype)


def params_from_arrays(tree, device=None):
    """A reference GNN parameter tree (any of the four inits, as numpy
    arrays) as tensors on ``device`` (the card unless given)."""
    return tree_from_arrays(tree, resolve_device(device))


def _edge_order(g, direction: str):
    """(src, dst) edge ids in the direction's memory order."""
    if direction == "push":
        return g.push_src, g.push_dst
    return g.coo_src, g.coo_dst


def _reduce(vals, dst, n, how="sum"):
    return (segment_sum(vals, dst, n) if how == "sum"
            else segment_mean(vals, dst, n))


def _one_plus_eps(lp: dict, cfg: GNNConfig, h: torch.Tensor):
    """GIN's ``1 + eps`` in h's dtype (bf16 payloads stay bf16)."""
    eps = lp["eps"] if cfg.gin_eps_learnable else 0.0
    return torch.as_tensor(1.0 + eps, device=h.device).to(h.dtype)


# ---------------------------------------------------------------- EGNN --
def egnn_init(cfg: GNNConfig, seed: int = 0, device=None) -> dict:
    gen = generator(seed, device)
    dt, d = cfg.torch_dtype, cfg.d_hidden
    layers = [{
        # phi_e(h_i, h_j, ||xi-xj||^2) -> message
        "phi_e": mlp_init(gen, [2 * d + 1, d, d], dt),
        # phi_x: message -> scalar coordinate gate
        "phi_x": mlp_init(gen, [d, d, 1], dt),
        # phi_h(h_i, agg) -> h update
        "phi_h": mlp_init(gen, [2 * d, d, d], dt),
    } for _ in range(cfg.n_layers)]
    return {"encode": mlp_init(gen, [cfg.d_in, d], dt),
            "decode": mlp_init(gen, [d, cfg.d_out], dt),
            "layers": layers}


def egnn_apply(params, cfg: GNNConfig, g, h: torch.Tensor,
               x: torch.Tensor):
    """h: [n, d_in] node features; x: [n, 3] coordinates (E(n) equivariant
    coordinate updates). Returns (node_out [n, d_out], x')."""
    n = g.n
    src, dst = _edge_order(g, cfg.direction)
    src, dst = src.long(), dst.long()
    h = mlp_apply(params["encode"], h, act=silu, final_act=True)
    for lp in params["layers"]:
        hs, hd = h[src], h[dst]
        diff = x[dst] - x[src]
        r2 = (diff * diff).sum(-1, keepdim=True).to(h.dtype)
        m = mlp_apply(lp["phi_e"], torch.cat([hd, hs, r2], -1), act=silu,
                      final_act=True)
        gate = mlp_apply(lp["phi_x"], m, act=silu)              # [m, 1]
        # coordinate update: mean over neighbors keeps scale stable
        x = x + _reduce(diff.to(h.dtype) * gate, dst, n, "mean").to(x.dtype)
        agg = _reduce(m, dst, n, "sum")
        h = h + mlp_apply(lp["phi_h"], torch.cat([h, agg], -1), act=silu)
    return mlp_apply(params["decode"], h), x


# ----------------------------------------------------------------- GIN --
def gin_init(cfg: GNNConfig, seed: int = 0, device=None) -> dict:
    gen = generator(seed, device)
    dt, d = cfg.torch_dtype, cfg.d_hidden
    layers = [{"mlp": mlp_init(gen, [cfg.d_in if i == 0 else d, d, d], dt),
               "eps": torch.zeros((), device=gen.device)}
              for i in range(cfg.n_layers)]
    return {"layers": layers, "readout": mlp_init(gen, [d, cfg.d_out], dt)}


def gin_apply(params, cfg: GNNConfig, g, h: torch.Tensor,
              graph_ids: Optional[torch.Tensor] = None,
              num_graphs: int = 1) -> torch.Tensor:
    """Sum-aggregating GIN; graph_ids enables batched-small-graph readout
    (the `molecule` shape)."""
    src, dst = _edge_order(g, cfg.direction)
    src = src.long()
    h = h.to(cfg.torch_dtype)     # bf16 config halves exchange payloads
    for lp in params["layers"]:
        agg = segment_sum(h[src], dst, g.n)
        h = mlp_apply(lp["mlp"], _one_plus_eps(lp, cfg, h) * h + agg,
                      act=torch.relu, final_act=True)
    pooled = h if graph_ids is None else segment_sum(h, graph_ids,
                                                     num_graphs)
    return mlp_apply(params["readout"], pooled)


def gin_apply_mp(params, cfg: GNNConfig, h: torch.Tensor,
                 e_src: torch.Tensor, e_dst: torch.Tensor,
                 mesh) -> torch.Tensor:
    """GIN with the paper's explicit pull exchange over ``mesh``'s P
    shards: edges arrive grouped by destination OWNER (``[P, cap]`` rows,
    sentinel-padded with any id >= n — the PA layout of
    ``graphs.partition``), so each layer is exactly

        all_gather(h)  +  owner-local gather/segment-combine

    shard p owning rows ``[p·n/P, (p+1)·n/P)`` of h ([n, d], n a multiple
    of P). Shards run in order 0..P−1 on their devices; the output
    ``[n, d_out]`` is concatenated on h's device."""
    devices = mesh.devices
    P, n = len(devices), h.shape[0]
    if n % P:
        raise ValueError(f"{n} rows do not split over {P} shards")
    shard = n // P
    rows = [(e_src[p].to(dev).long(), e_dst[p].to(dev).long())
            for p, dev in enumerate(devices)]
    local = [tree_map(lambda t, dev=dev: t.to(dev), params)
             for dev in devices]
    blocks = shard_blocks(h.to(cfg.torch_dtype), devices)
    for li in range(len(params["layers"])):
        fulls = all_gather(blocks, devices)                 # [n, d] each
        new = []
        for p, (hb, full, (src, dst)) in enumerate(zip(blocks, fulls, rows)):
            ok = (src < n) & (dst < n)
            msg = torch.where(ok[:, None], full[torch.clamp(src, 0, n - 1)],
                              torch.zeros((), dtype=hb.dtype,
                                          device=hb.device))
            ldst = torch.where(ok, torch.clamp(dst - p * shard, 0, shard - 1),
                               shard - 1)
            agg = segment_sum(msg, ldst, shard)
            lp = local[p]["layers"][li]
            new.append(mlp_apply(lp["mlp"], _one_plus_eps(lp, cfg, hb) * hb
                                 + agg, act=torch.relu, final_act=True))
        blocks = new
    return unshard([mlp_apply(local[p]["readout"], hb)
                    for p, hb in enumerate(blocks)], h.device)


# ----------------------------------------------------------- GraphSAGE --
def sage_init(cfg: GNNConfig, seed: int = 0, device=None) -> dict:
    gen = generator(seed, device)
    dt = cfg.torch_dtype
    layers = []
    for i in range(cfg.n_layers):
        d_in = cfg.d_in if i == 0 else cfg.d_hidden
        d_out = cfg.d_out if i == cfg.n_layers - 1 else cfg.d_hidden
        layers.append({"w_self": mlp_init(gen, [d_in, d_out], dt),
                       "w_neigh": mlp_init(gen, [d_in, d_out], dt)})
    return {"layers": layers}


def sage_apply(params, cfg: GNNConfig, g, h: torch.Tensor) -> torch.Tensor:
    """Full-graph GraphSAGE-mean."""
    src, dst = _edge_order(g, cfg.direction)
    src = src.long()
    h = h.to(cfg.torch_dtype)
    last = len(params["layers"]) - 1
    for i, lp in enumerate(params["layers"]):
        agg = segment_mean(h[src], dst, g.n)
        h_new = mlp_apply(lp["w_self"], h) + mlp_apply(lp["w_neigh"], agg)
        h = torch.relu(h_new) if i < last else h_new
    return h


def sage_apply_blocks(params, cfg: GNNConfig, blocks: SampledBlocks,
                      feats) -> torch.Tensor:
    """Sampled minibatch GraphSAGE (the paper's Frontier-Exploit applied to
    training): ``feats`` holds per-hop node features, index 0 = seeds ..
    L = deepest hop (aligned with ``blocks.node_ids``); layer i refreshes
    hops 0 .. L-i-1 from their children, mean over valid children."""
    L = len(params["layers"])
    if blocks.num_hops != L:
        raise ValueError(f"{blocks.num_hops} sampled hops for {L} layers")
    h_per_hop = list(feats)
    for i, lp in enumerate(params["layers"]):
        new_h = []
        for k in range(L - i):
            parent_h = h_per_hop[k]
            n_parent, fanout = parent_h.shape[0], blocks.fanouts[k]
            child_ok = blocks.valid[k + 1].reshape(n_parent, fanout)
            ch = h_per_hop[k + 1].reshape(n_parent, fanout, -1)
            denom = torch.clamp(child_ok.sum(-1, keepdim=True), min=1)
            agg = (ch * child_ok[..., None]).sum(1) / denom
            h_new = (mlp_apply(lp["w_self"], parent_h)
                     + mlp_apply(lp["w_neigh"], agg))
            new_h.append(torch.relu(h_new) if i < L - 1 else h_new)
        h_per_hop = new_h
    return h_per_hop[0]


# ------------------------------------------------------------ GraphCast --
def graphcast_init(cfg: GNNConfig, seed: int = 0, device=None) -> dict:
    """Encoder-processor-decoder deep MPNN (GraphCast-style, adapted: the
    provided graph plays the multi-mesh role)."""
    gen = generator(seed, device)
    dt, d, dev = cfg.torch_dtype, cfg.d_hidden, gen.device

    def norm():
        return [torch.ones(d, device=dev), torch.zeros(d, device=dev)]

    proc = [{"edge_mlp": mlp_init(gen, [3 * d, d, d], dt),
             "node_mlp": mlp_init(gen, [2 * d, d, d], dt),
             "ln_e": norm(), "ln_n": norm()} for _ in range(cfg.n_layers)]
    return {"node_enc": mlp_init(gen, [cfg.n_vars, d, d], dt),
            "edge_enc": mlp_init(gen, [1, d, d], dt),
            "proc": proc,
            "node_dec": mlp_init(gen, [d, d, cfg.n_vars], dt)}


def graphcast_apply(params, cfg: GNNConfig, g,
                    node_vars: torch.Tensor) -> torch.Tensor:
    """node_vars: [n, n_vars] -> next-step prediction [n, n_vars]."""
    src, dst = _edge_order(g, cfg.direction)
    src, dst = src.long(), dst.long()
    dt = cfg.torch_dtype
    h = mlp_apply(params["node_enc"], node_vars.to(dt), act=silu,
                  final_act=True)
    w = g.push_w if cfg.direction == "push" else g.coo_w
    e = mlp_apply(params["edge_enc"], w[:, None].to(dt), act=silu,
                  final_act=True)
    for lp in params["proc"]:
        e_in = torch.cat([e, h[src], h[dst]], dim=-1)
        e_upd = mlp_apply(lp["edge_mlp"], e_in, act=silu)
        e = layer_norm(e + e_upd, *lp["ln_e"])
        agg = segment_sum(e, dst, g.n)
        n_upd = mlp_apply(lp["node_mlp"], torch.cat([h, agg], -1), act=silu)
        h = layer_norm(h + n_upd, *lp["ln_n"])
    return node_vars + mlp_apply(params["node_dec"], h,
                                 act=silu).to(node_vars.dtype)
