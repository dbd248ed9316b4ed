"""Mixture-of-Experts FFN with push/pull dispatch (paper technique applied
to MoE). PyTorch port of ``repro.models.moe``.

Token→expert routing is a bipartite graph per microbatch. The paper's
dichotomy maps onto the two standard dispatch schedules:

  * **push dispatch**: tokens are scattered into per-expert capacity
    buffers (a one-hot ``[S, K, E, cap]`` dispatch tensor and two
    ``einsum``s); combine back is the transpose.
  * **pull dispatch**: each expert *gathers* its assigned token ids
    (a stable argsort by expert) and writes back only its owned slice —
    reads instead of scatters.

Both produce identical outputs. Shared experts (deepseek) run densely for
every token — they are the "local partition" that never pays dispatch.

Experts are stacked on a leading ``[E]`` axis and run as batched GEMMs
(``torch.bmm``; the reference ``vmap``s one expert's GEMMs). The router
runs in float32, top-k gates renormalise with a 1e-9 floor, and the
capacity is ``max(1, int(capacity_factor · S · K / E))`` in Python floats,
as in the reference. ``torch.topk`` and ``jax.lax.top_k`` agree on
distinct values; they may order tied ones differently.

:func:`moe_apply_ep` splits the experts over the "model" axis of the
installed activation mesh (``dist.sharding.set_activation_mesh``, a
:class:`~repro_torch.shard.mesh.ShardMesh`); one controller runs the
shards in order 0..P−1 on their devices, and tokens are replicated over
them, since the port's mesh has no data axis. What its exchanges carry
between shards goes to ``dist.collectives.count_wire``: the psum
combine's P − 1 partials, the a2a's blocks for other ranks both ways
and its gather of the sequence slices.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..dist.collectives import count_wire
from ..dist.sharding import get_activation_mesh
from .common import dense_apply, dense_init, randn, silu, tree_map

__all__ = ["MoEConfig", "moe_init", "moe_apply", "moe_apply_ep"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff_expert: int
    n_experts: int
    top_k: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    dispatch: str = "push"            # 'push' | 'pull'
    router_dtype: str = "float32"
    # EP combine payload: 'f32' (exact) or 'bf16' (halves the combine
    # bytes; each token sums <= top_k expert contributions)
    combine_dtype: str = "f32"
    # EP schedule: 'psum' — every model rank dispatches every (replicated)
    # token to its local experts and a sum over ranks combines; 'a2a' —
    # ranks split the token sequence, route via all_to_all, return via
    # all_to_all (+ all_gather) — the paper's MP combined-alltoall push
    ep_mode: str = "psum"


def _experts_init(gen: torch.Generator, count: int, cfg: MoEConfig,
                  dtype: torch.dtype) -> dict:
    """``count`` SwiGLU experts stacked on a leading axis: He-normal
    weights, each expert's as ``dense_init`` draws one."""
    def stacked(d_in, d_out):
        w = randn(gen, (count, d_in, d_out))
        return {"w": w.mul_(math.sqrt(2.0 / max(1, d_in))).to(dtype)}

    D, F = cfg.d_model, cfg.d_ff_expert
    return {"wi": stacked(D, F), "wg": stacked(D, F), "wo": stacked(F, D)}


def moe_init(gen: torch.Generator, cfg: MoEConfig,
             dtype: torch.dtype = torch.float32) -> dict:
    """Router (float32) and stacked experts, drawn from ``gen`` on its
    device."""
    params = {"router": dense_init(gen, cfg.d_model, cfg.n_experts,
                                   torch.float32),
              "experts": _experts_init(gen, cfg.n_experts, cfg, dtype)}
    if cfg.n_shared:
        params["shared"] = _experts_init(gen, cfg.n_shared, cfg, dtype)
    return params


def _expert_ffn(p: dict, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU experts: x [E, c, D] -> [E, c, D], three batched GEMMs."""
    return torch.bmm(silu(torch.bmm(x, p["wg"]["w"]))
                     * torch.bmm(x, p["wi"]["w"]), p["wo"]["w"])


def _shared_ffn(p: dict, xf: torch.Tensor) -> torch.Tensor:
    """Every shared expert on every token, summed: [S, D]."""
    n = p["wi"]["w"].shape[0]
    return _expert_ffn(p, xf.expand(n, *xf.shape)).sum(0)


def _route(router: dict, cfg: MoEConfig, xf: torch.Tensor):
    """(probs [S, E], gates [S, K], expert ids [S, K]) in float32."""
    probs = torch.softmax(dense_apply(router, xf.float()), dim=-1)
    gate_vals, gate_idx = torch.topk(probs, cfg.top_k, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    return probs, gate_vals, gate_idx


def _one_hot(idx: torch.Tensor, n: int, dtype: torch.dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside [0, n) gives a zero row."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _capacity(cfg: MoEConfig, S: int) -> int:
    return max(1, int(cfg.capacity_factor * S * cfg.top_k / cfg.n_experts))


def _scatter_rows(n: int, order: torch.Tensor,
                  values: torch.Tensor) -> torch.Tensor:
    """``zeros(n).at[order].set(values)`` for a permutation ``order``."""
    return values.new_zeros(n).index_put((order,), values)


def _zero(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=x.dtype, device=x.device)


def _slot_buffer(rows: int, cap: int, rows_idx: torch.Tensor,
                 slots: torch.Tensor, ok: torch.Tensor,
                 tokens: torch.Tensor) -> torch.Tensor:
    """``[rows, cap + 1, D]`` expert buffers with ``tokens`` written at
    (rows_idx, slots) where ``ok``; entries not ``ok`` write zeros into
    the sacrificial last slot (or row), never over a kept entry."""
    buf = tokens.new_zeros((rows, cap + 1, tokens.shape[-1]))
    return buf.index_put((rows_idx, slots),
                         torch.where(ok[:, None], tokens, _zero(tokens)))


def moe_apply(params: dict, cfg: MoEConfig, x: torch.Tensor,
              return_aux: bool = False):
    """x: [B, T, D] -> [B, T, D] (+ aux dict with load-balance loss)."""
    B, T, D = x.shape
    S = B * T
    xf = x.reshape(S, D)
    E, K = cfg.n_experts, cfg.top_k
    dt = xf.dtype
    probs, gate_vals, gate_idx = _route(params["router"], cfg, xf)
    cap = _capacity(cfg, S)
    # position of each (token, k) within its expert queue
    onehot = _one_hot(gate_idx, E, torch.int32)               # [S, K, E]
    pos_in_e = torch.cumsum(onehot.reshape(S * K, E), dim=0) - 1
    pos_in_e = (pos_in_e.reshape(S, K, E) * onehot).sum(-1)    # [S, K]
    keep = pos_in_e < cap

    if cfg.dispatch == "push":
        # scatter tokens into [E, cap, D] buffers via a combine matmul
        disp = (_one_hot(gate_idx, E, dt)[..., :, None]
                * _one_hot(pos_in_e, cap, dt)[..., None, :])  # [S,K,E,cap]
        disp = disp * keep[..., None, None].to(dt)
        buf = torch.einsum("skec,sd->ecd", disp, xf)           # [E, cap, D]
        out_e = _expert_ffn(params["experts"], buf)
        comb = disp * gate_vals[..., None, None].to(dt)
        yf = torch.einsum("skec,ecd->sd", comb, out_e)
    else:
        # pull: experts gather their token ids (argsort by expert id)
        flat_e = gate_idx.reshape(-1)                          # [S*K]
        order = torch.argsort(flat_e, stable=True)
        e_sorted = flat_e[order]
        first = torch.searchsorted(e_sorted, torch.arange(E, device=x.device))
        slot_rank = torch.arange(S * K, device=x.device) - first[e_sorted]
        in_cap = slot_rank < cap
        # cap+1 slots: overflow writes land in the sacrificial last slot so
        # they can never clobber a legitimate (e, cap-1) entry
        buf = _slot_buffer(E, cap, e_sorted, torch.clamp(slot_rank, max=cap),
                           in_cap, xf[order // K])
        out_e = _expert_ffn(params["experts"], buf[:, :cap])
        # write back: each (token, k) pulls its expert output slot
        slot_of_sk = _scatter_rows(S * K, order,
                                   torch.clamp(slot_rank, max=cap - 1))
        ok_of_sk = _scatter_rows(S * K, order, in_cap)
        picked = out_e[flat_e, slot_of_sk]                     # [S*K, D]
        picked = torch.where(ok_of_sk[:, None], picked, _zero(picked))
        yf = (picked.reshape(S, K, D) * gate_vals[..., None].to(dt)
              * keep[..., None].to(dt)).sum(1)

    if cfg.n_shared:
        yf = yf + _shared_ffn(params["shared"], xf)
    y = yf.reshape(B, T, D).to(x.dtype)
    if not return_aux:
        return y
    # Switch-style load-balance loss
    density = _one_hot(gate_idx[:, 0], E, torch.float32).mean(0)
    aux = {"lb_loss": E * (density * probs.mean(0)).sum(),
           "dropped_frac": 1.0 - keep.float().mean()}
    return y, aux


def _local_pull_dispatch(router: dict, experts_block: dict, cfg: MoEConfig,
                         xf: torch.Tensor, e_base: int,
                         E_local: int) -> torch.Tensor:
    """Shard-local pull dispatch: route xf [S, D] to the E_local experts
    owned by this shard, run them, return this shard's partial output.
    Everything here is device-local — the paper's PA 'local arrays'."""
    S, D = xf.shape
    K = cfg.top_k
    _, gate_vals, gate_idx = _route(router, cfg, xf)
    cap = _capacity(cfg, S)
    dev = xf.device
    local = (gate_idx >= e_base) & (gate_idx < e_base + E_local)
    flat_e = torch.where(local, gate_idx - e_base, E_local).reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    first = torch.searchsorted(e_sorted,
                               torch.arange(E_local + 1, device=dev))
    slot_rank = (torch.arange(S * K, device=dev)
                 - first[torch.clamp(e_sorted, max=E_local)])
    in_cap = (slot_rank < cap) & (e_sorted < E_local)
    buf = _slot_buffer(E_local + 1, cap, torch.clamp(e_sorted, max=E_local),
                       torch.clamp(slot_rank, 0, cap), in_cap,
                       xf[order // K])
    out_e = _expert_ffn(experts_block, buf[:E_local, :cap])
    slot_of_sk = _scatter_rows(S * K, order,
                               torch.clamp(slot_rank, 0, cap - 1))
    ok_of_sk = _scatter_rows(S * K, order, in_cap)
    e_of_sk = torch.where(local, gate_idx - e_base, 0).reshape(-1)
    picked = out_e[torch.clamp(e_of_sk, 0, E_local - 1), slot_of_sk]
    picked = torch.where(ok_of_sk[:, None], picked, _zero(picked))
    return (picked.reshape(S, K, D)
            * gate_vals[..., None].to(xf.dtype)).sum(1)


def _a2a_dispatch(routers: list, blocks: list, shared: list, xs: list,
                  cfg: MoEConfig, E_local: int, out_device) -> torch.Tensor:
    """Sequence-split all_to_all EP over the ranks of ``xs`` (rank m's
    replica of the tokens [S, D] on its device). Rank m routes ONLY its
    S/tp slice; tokens travel to expert owners by an all_to_all of
    ``[tp, E_local, cap, D]`` blocks and return the same way; an
    all_gather reassembles the activations on ``out_device``."""
    tp = len(xs)
    S, D = xs[0].shape
    K, E = cfg.top_k, cfg.n_experts
    S_m = S // tp
    cap = _capacity(cfg, S_m)                       # per (rank, expert)
    routed, send = [], []
    for m, xf in enumerate(xs):
        xm = xf[m * S_m:(m + 1) * S_m]
        _, gate_vals, gate_idx = _route(routers[m], cfg, xm)
        seg = gate_idx.reshape(-1)                  # [S_m*K] in [0, E)
        order = torch.argsort(seg, stable=True)
        seg_s = seg[order]
        first = torch.searchsorted(seg_s, torch.arange(E + 1,
                                                       device=xm.device))
        slot = torch.arange(S_m * K, device=xm.device) - first[seg_s]
        in_cap = slot < cap
        buf = _slot_buffer(E, cap, seg_s, torch.clamp(slot, max=cap), in_cap,
                           xm[order // K])
        send.append(buf[:, :cap].reshape(tp, E_local, cap, D))
        routed.append((xm, gate_vals, gate_idx, order, slot, in_cap))
    # tokens -> expert owners (the combined 'MP' push of the paper)
    block = send[0][0].numel() * send[0][0].element_size()
    count_wire("all-to-all", block * tp * (tp - 1))
    back = []
    for r, xf in enumerate(xs):
        recv = torch.stack([s[r].to(xf.device) for s in send])  # [tp,El,c,D]
        bufs = recv.transpose(0, 1).reshape(E_local, tp * cap, D)
        out_e = _expert_ffn(blocks[r], bufs)
        back.append(out_e.reshape(E_local, tp, cap, D).transpose(0, 1))
    count_wire("all-to-all", block * tp * (tp - 1))
    ys = []
    for m, (xm, gate_vals, gate_idx, order, slot, in_cap) in enumerate(
            routed):
        # got[r, e, s] = output for the token this rank queued at
        # (r*E_l+e, s)
        got = torch.stack([b[m].to(xm.device) for b in back])
        slot_of = _scatter_rows(S_m * K, order, torch.clamp(slot, 0, cap - 1))
        ok_of = _scatter_rows(S_m * K, order, in_cap)
        r_of = (gate_idx // E_local).reshape(-1)
        e_of = (gate_idx % E_local).reshape(-1)
        picked = got[r_of, e_of, slot_of]
        picked = torch.where(ok_of[:, None], picked, _zero(picked))
        ym = (picked.reshape(S_m, K, D)
              * gate_vals[..., None].to(xm.dtype)).sum(1)
        if shared is not None:
            # shared experts on the sequence slice too: 1/tp of the
            # redundant work; the all_gather reassembles everything
            ym = ym + _shared_ffn(shared[m], xm)
        if cfg.combine_dtype == "bf16":
            ym = ym.to(torch.bfloat16)
        ys.append(ym.to(out_device))
    count_wire("all-gather",
               sum(y.numel() * y.element_size() for y in ys) * (tp - 1))
    return torch.cat(ys).to(xs[0].dtype)


def moe_apply_ep(params: dict, cfg: MoEConfig,
                 x: torch.Tensor) -> torch.Tensor:
    """Expert-parallel MoE: experts split over the "model" axis of the
    installed activation mesh, tp shards, each on its device; tokens are
    replicated over them. ``ep_mode="psum"``: every shard pull-dispatches
    every token to its local experts and the partial outputs sum in shard
    order (in bf16 with ``combine_dtype="bf16"``); ``"a2a"``: see
    :func:`_a2a_dispatch` (when tp divides the tokens).

    Falls back to :func:`moe_apply` when no activation mesh is installed
    (or it has no "model" axis), and when tp does not divide the experts.
    """
    mesh = get_activation_mesh()
    if mesh is None or "model" not in mesh.axis_names:
        return moe_apply(params, cfg, x)
    tp = mesh.shape["model"]
    if cfg.n_experts % tp != 0:
        return moe_apply(params, cfg, x)
    E_local = cfg.n_experts // tp
    devices = mesh.devices[:tp]
    B, T, D = x.shape
    S = B * T
    xs = [x.reshape(S, D).to(dev) for dev in devices]
    routers = [tree_map(lambda t, dev=dev: t.to(dev), params["router"])
               for dev in devices]
    blocks = [tree_map(lambda t, r=r, dev=dev:
                       t[r * E_local:(r + 1) * E_local].to(dev),
                       params["experts"]) for r, dev in enumerate(devices)]
    use_a2a = cfg.ep_mode == "a2a" and S % tp == 0 and S >= tp
    shared_in_block = use_a2a and cfg.n_shared > 0
    if use_a2a:
        shared = ([tree_map(lambda t, dev=dev: t.to(dev), params["shared"])
                   for dev in devices] if shared_in_block else None)
        yf = _a2a_dispatch(routers, blocks, shared, xs, cfg, E_local,
                           x.device)
    else:
        parts = [_local_pull_dispatch(routers[r], blocks[r], cfg, xf,
                                      r * E_local, E_local)
                 for r, xf in enumerate(xs)]
        if cfg.combine_dtype == "bf16":
            parts = [p.to(torch.bfloat16) for p in parts]
        count_wire("all-reduce", sum(p.numel() * p.element_size()
                                     for p in parts[1:]))
        yf = parts[0].to(x.device)
        for p in parts[1:]:
            yf = yf + p.to(x.device)
    y = yf.reshape(B, T, D).to(x.dtype)
    if cfg.n_shared and not shared_in_block:
        # shared experts = the PA 'local partition': dense, never dispatched
        y = y + _shared_ffn(params["shared"], x.reshape(S, D)).reshape(
            B, T, D).to(x.dtype)
    return y
