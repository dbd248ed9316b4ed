"""The port's GNN family against the JAX package, on the same inputs.

Segment ops (``sparse/segment.py``), ``EdgeView``, the sampler
(``graphs/sampling.py``) and the four archs of ``models/gnn.py`` in
both directions: the reference's parameters (its inits, seeded with
``jax.random.PRNGKey``) are carried across with
``gnn.params_from_arrays``, the graph with ``graph_from_arrays``, and the
features are numpy draws. ``gin_apply_mp`` runs the reference once per
module in a fresh interpreter with XLA faking 8 host devices (as
``tests/test_torch_shard.py`` runs the sharded engine) and holds the
port on meshes of ``[torch.device("cpu")] * P`` to it.

Tolerances: float32 rtol = atol = 1e-5 on values (both packages sum in
float32, in other orders); gradients within 1e-5 of each leaf's largest
|entry| (the reference's gradients are XLA's, summed in other orders
through up to 16 layers); integers and the sampler bit for bit; the
bf16 config within 2^-6 of the largest |output| (two bf16 roundings of
every activation may fall to either side).
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graphs import structure as ref_structure
from repro.graphs.sampling import sample_blocks as ref_sample_blocks
from repro.models import gnn as ref_gnn
from repro.sparse import segment as ref_seg
from repro_torch.graphs import (GRAPH_ARRAYS, EdgeView, graph_from_arrays,
                                sample_blocks)
from repro_torch.models import gnn
from repro_torch.models.common import tree_leaves
from repro_torch.shard import make_shard_mesh
from repro_torch.sparse import segment as seg

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
ARCHS = ("egnn", "gin-tu", "graphsage-reddit", "graphcast")
DIRECTIONS = ("pull", "push")
KEY = jax.random.PRNGKey(0)
N = 50


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def close(got: torch.Tensor, want, tol: float = 1e-5) -> None:
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def leaf_close(got: torch.Tensor, want, tol: float, what: str) -> None:
    """Every entry within ``tol`` times the leaf's largest |entry|."""
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy()
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    gap = float(np.abs(got - want).max(initial=0.0))
    assert gap <= tol * scale, f"{what}: {gap} > {tol} * {scale}"


@pytest.fixture(scope="module")
def graphs():
    """A weighted graph whose last 5 vertices have no edges (empty
    segments for the means), in both packages."""
    rng = np.random.default_rng(3)
    src = rng.integers(0, N - 5, 200)
    dst = rng.integers(0, N - 5, 200)
    w = rng.uniform(1.0, 4.0, 200).astype(np.float32)
    g = ref_structure.build_graph(src, dst, N, weights=w)
    tg = graph_from_arrays({f: np.asarray(getattr(g, f))
                            for f in GRAPH_ARRAYS},
                           n=g.n, m=g.m, d_ell=g.d_ell, device=CPU)
    return g, tg


# -- segment ops -----------------------------------------------------------
SEG_OPS = ("segment_sum", "segment_mean", "segment_max", "segment_min",
           "segment_logsumexp", "segment_softmax")


@pytest.mark.parametrize("width", (None, 3))
@pytest.mark.parametrize("op", SEG_OPS)
def test_segment_ops_match_reference(op, width):
    """Empty segments (ids 9..13 never drawn) and out-of-range ids, some
    negative: dropped by the reductions, read back with jnp's gather
    rules by the softmax."""
    rng = np.random.default_rng(5)
    shape = (60,) if width is None else (60, width)
    data = rng.normal(size=shape).astype(np.float32) * 4
    ids = rng.integers(-3, 9, size=60).astype(np.int32)
    ids[:4] = [14, 20, -1, -17]
    got = getattr(seg, op)(t(data), t(ids), 14)
    want = getattr(ref_seg, op)(jnp.asarray(data), jnp.asarray(ids), 14)
    close(got, want)


def test_count_segments_matches_reference():
    ids = np.array([0, 3, 3, -1, 7, 9, 3, 0], np.int32)
    got = seg.count_segments(t(ids), 8)
    want = ref_seg.count_segments(jnp.asarray(ids), 8)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_float64_sum_in_chunks_equals_one_sum(monkeypatch):
    """The card's float32 sum (float64 accumulation, SUM_CHUNK_BYTES of
    rows at a time) run here through its Function: any chunking gives
    the one float64 sum rounded once, keeps two 2^-130 terms, and its
    gradient is the output's gathered at each id (0 where dropped)."""
    rng = np.random.default_rng(6)
    data = t(rng.normal(size=(1000, 5)).astype(np.float32)
             ).requires_grad_()
    ids = t(rng.integers(-2, 40, 1000))
    spill = seg._spill_ids(ids, 37)
    want = torch.zeros(38, 5, dtype=torch.float64).index_add_(
        0, spill, data.detach().double())[:37].float()
    for chunk_bytes in (8 * 5 * 7, 8 * 5 * 1000, 1 << 30):
        monkeypatch.setattr(seg, "SUM_CHUNK_BYTES", chunk_bytes)
        got = seg._Float64Sum.apply(data, spill, 37)
        assert torch.equal(got, want)
    g = t(rng.normal(size=(37, 5)).astype(np.float32))
    (grad,) = torch.autograd.grad(got, data, g)
    ok = (ids >= 0) & (ids < 37)
    assert torch.equal(grad[ok], g[ids[ok]])
    assert not grad[~ok].any()
    tiny = torch.full((2,), 2.0 ** -130)
    assert float(seg._Float64Sum.apply(tiny, torch.zeros(2, dtype=torch.long),
                                       1)[0]) == 2.0 ** -129


# -- EdgeView and the sampler ----------------------------------------------
def test_edge_view_matches_reference(graphs):
    g, tg = graphs
    ev = EdgeView(src=tg.push_src, dst=tg.push_dst, w=tg.push_w, n=tg.n,
                  m=tg.m)
    ref_ev = ref_structure.EdgeView(src=g.push_src, dst=g.push_dst,
                                    w=g.push_w, n=g.n, m=g.m)
    for name in ("coo_src", "coo_dst", "coo_w", "push_src", "push_dst",
                 "push_w"):
        np.testing.assert_array_equal(getattr(ev, name).numpy(),
                                      np.asarray(getattr(ref_ev, name)))
    assert (ev.n, ev.m) == (N, g.m)
    cfg = ref_gnn.GNNConfig(arch="gin-tu", n_layers=2, d_hidden=16,
                            d_in=8, d_out=4)
    ref_p = ref_gnn.gin_init(KEY, cfg)
    h = np.random.default_rng(7).normal(size=(N, 8)).astype(np.float32)
    close(gnn.gin_apply(gnn.params_from_arrays(to_numpy(ref_p), CPU),
                        gnn.GNNConfig(**dataclasses.asdict(cfg)), ev, t(h)),
          ref_gnn.gin_apply(ref_p, cfg, ref_ev, jnp.asarray(h)))


def ref_uniforms(key, nodes: int, fanouts) -> list:
    """The reference sampler's draws: its key splits, replayed."""
    out = []
    for f in fanouts:
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.uniform(sub, (nodes, f))))
        nodes *= f
    return out


@pytest.mark.parametrize("fanouts", [(4, 3), (5,), (2, 2, 3)])
def test_sample_blocks_matches_reference_bit_for_bit(graphs, fanouts):
    """Seeds include isolated vertices and the sentinel (invalid)."""
    g, tg = graphs
    seeds = np.array([0, 3, 46, 17, N, 48, 9, 22], np.int32)
    key = jax.random.PRNGKey(11)
    want = ref_sample_blocks(g, jnp.asarray(seeds), fanouts, key)
    got = sample_blocks(tg, t(seeds), fanouts,
                        uniforms=[t(u) for u in ref_uniforms(
                            key, len(seeds), fanouts)])
    assert got.fanouts == want.fanouts and got.sentinel == want.sentinel
    assert got.num_hops == len(fanouts)
    for a, b in zip(got.node_ids, want.node_ids):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(got.valid, want.valid):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_sample_blocks_draws_from_a_generator(graphs):
    _, tg = graphs
    seeds = torch.arange(6, dtype=torch.int32)
    a = sample_blocks(tg, seeds, (3, 2), gen=torch.Generator().manual_seed(1))
    b = sample_blocks(tg, seeds, (3, 2), gen=torch.Generator().manual_seed(1))
    for x, y in zip(a.node_ids, b.node_ids):
        assert torch.equal(x, y)
    ok = a.valid[1]
    assert ok.any()
    # every valid child is an in-neighbour of its parent
    parents = seeds.repeat_interleave(3)[ok].long()
    children = a.node_ids[1][ok].long()
    edges = set(zip(tg.coo_src.tolist(), tg.coo_dst.tolist()))
    assert all((c, p) in edges for c, p in zip(children.tolist(),
                                                parents.tolist()))
    with pytest.raises(ValueError, match="Generator"):
        sample_blocks(tg, seeds, (3,))


# -- the four archs ----------------------------------------------------------
def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


REF_INIT = {"egnn": ref_gnn.egnn_init, "gin-tu": ref_gnn.gin_init,
            "graphsage-reddit": ref_gnn.sage_init,
            "graphcast": ref_gnn.graphcast_init}
INIT = {"egnn": gnn.egnn_init, "gin-tu": gnn.gin_init,
        "graphsage-reddit": gnn.sage_init, "graphcast": gnn.graphcast_init}


def arch_case(arch: str, direction: str, dtype: str = "float32"):
    """(ref cfg, cfg, ref params, port params, inputs as numpy)."""
    from repro.configs.archs import smoke_config as ref_smoke
    from repro_torch.configs.archs import smoke_config
    ref_cfg = dataclasses.replace(ref_smoke(arch), direction=direction,
                                  dtype=dtype)
    cfg = dataclasses.replace(smoke_config(arch), direction=direction,
                              dtype=dtype)
    ref_p = REF_INIT[arch](KEY, ref_cfg)
    rng = np.random.default_rng(8)
    d = cfg.n_vars if arch == "graphcast" else cfg.d_in
    inputs = {"h": rng.normal(size=(N, d)).astype(np.float32),
              "x": rng.normal(size=(N, 3)).astype(np.float32)}
    return (ref_cfg, cfg, ref_p, gnn.params_from_arrays(to_numpy(ref_p), CPU),
            inputs)


def ref_apply(arch, p, cfg, g, inputs):
    h = jnp.asarray(inputs["h"])
    if arch == "egnn":
        return ref_gnn.egnn_apply(p, cfg, g, h, jnp.asarray(inputs["x"]))
    fn = {"gin-tu": ref_gnn.gin_apply, "graphsage-reddit": ref_gnn.sage_apply,
          "graphcast": ref_gnn.graphcast_apply}[arch]
    return fn(p, cfg, g, h)


def port_apply(arch, p, cfg, g, inputs):
    h = t(inputs["h"])
    if arch == "egnn":
        return gnn.egnn_apply(p, cfg, g, h, t(inputs["x"]))
    fn = {"gin-tu": gnn.gin_apply, "graphsage-reddit": gnn.sage_apply,
          "graphcast": gnn.graphcast_apply}[arch]
    return fn(p, cfg, g, h)


def outputs(res) -> list:
    return list(res) if isinstance(res, tuple) else [res]


@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(graphs, arch, direction):
    g, tg = graphs
    ref_cfg, cfg, ref_p, p, inputs = arch_case(arch, direction)
    got = outputs(port_apply(arch, p, cfg, tg, inputs))
    want = outputs(ref_apply(arch, ref_p, ref_cfg, g, inputs))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        close(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_push_equals_pull(graphs, arch):
    _, tg = graphs
    _, cfg, _, p, inputs = arch_case(arch, "pull")
    pull = outputs(port_apply(arch, p, cfg, tg, inputs))
    push = outputs(port_apply(arch, p, dataclasses.replace(
        cfg, direction="push"), tg, inputs))
    for a, b in zip(pull, push):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_config_matches_reference(graphs, arch):
    """dtype "bfloat16": bf16 weights and payloads (GIN's 1 + eps cast to
    h's dtype), float32 layer norms and coordinates."""
    g, tg = graphs
    ref_cfg, cfg, ref_p, p, inputs = arch_case(arch, "pull", "bfloat16")
    assert cfg.torch_dtype == torch.bfloat16
    got = outputs(port_apply(arch, p, cfg, tg, inputs))
    want = outputs(ref_apply(arch, ref_p, ref_cfg, g, inputs))
    for a, b in zip(got, want):
        assert str(a.dtype).split(".")[-1] == str(b.dtype)
        leaf_close(a, np.asarray(b, np.float32), 2 ** -6, arch)


def test_gin_graph_ids_readout_matches_reference(graphs):
    g, tg = graphs
    ref_cfg, cfg, ref_p, p, inputs = arch_case("gin-tu", "push")
    gids = np.repeat(np.arange(5, dtype=np.int32), N // 5)
    got = gnn.gin_apply(p, cfg, tg, t(inputs["h"]), graph_ids=t(gids),
                        num_graphs=5)
    want = ref_gnn.gin_apply(ref_p, ref_cfg, g, jnp.asarray(inputs["h"]),
                             graph_ids=jnp.asarray(gids), num_graphs=5)
    assert got.shape == (5, cfg.d_out)
    close(got, want)


def test_sage_apply_blocks_matches_reference(graphs):
    g, tg = graphs
    ref_cfg, cfg, ref_p, p, _ = arch_case("graphsage-reddit", "pull")
    seeds = np.array([0, 3, 46, 17, N, 9, 22, 30], np.int32)
    key = jax.random.PRNGKey(12)
    blocks = ref_sample_blocks(g, jnp.asarray(seeds), cfg.fanouts, key)
    tblocks = sample_blocks(tg, t(seeds), cfg.fanouts, uniforms=[
        t(u) for u in ref_uniforms(key, len(seeds), cfg.fanouts)])
    h = np.random.default_rng(9).normal(size=(N + 1, cfg.d_in)).astype(
        np.float32)
    h[N] = 0.0
    feats = [h[np.minimum(np.asarray(ids), N)] for ids in blocks.node_ids]
    got = gnn.sage_apply_blocks(p, cfg, tblocks, [t(f) for f in feats])
    want = ref_gnn.sage_apply_blocks(ref_p, ref_cfg, blocks,
                                     tuple(jnp.asarray(f) for f in feats))
    assert got.shape == (len(seeds), cfg.d_out)
    close(got, want)
    with pytest.raises(ValueError, match="hops"):
        gnn.sage_apply_blocks(p, cfg, dataclasses.replace(
            tblocks, fanouts=cfg.fanouts[:1]), feats)


def test_egnn_equivariance(graphs):
    _, tg = graphs
    _, cfg, _, p, inputs = arch_case("egnn", "push")
    h, x = t(inputs["h"]), t(inputs["x"])
    out1, x1 = gnn.egnn_apply(p, cfg, tg, h, x)
    th = 1.1
    R = torch.tensor([[np.cos(th), -np.sin(th), 0.0],
                      [np.sin(th), np.cos(th), 0.0], [0.0, 0.0, 1.0]],
                     dtype=torch.float32)
    shift = torch.tensor([2.0, -1.0, 0.5])
    out2, x2 = gnn.egnn_apply(p, cfg, tg, h, x @ R.T + shift)
    torch.testing.assert_close(out1, out2, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(x1 @ R.T + shift, x2, rtol=1e-4, atol=1e-4)


def ref_loss(arch, cfg, g, inputs):
    def loss(p):
        out = outputs(ref_apply(arch, p, cfg, g, inputs))
        return sum(jnp.mean(o.astype(jnp.float32) ** 2) for o in out)
    return jax.jit(jax.value_and_grad(loss))


@pytest.mark.parametrize("direction", DIRECTIONS)
@pytest.mark.parametrize("arch", ARCHS)
def test_grads_match_reference(graphs, arch, direction):
    g, tg = graphs
    ref_cfg, cfg, ref_p, p, inputs = arch_case(arch, direction)
    want_loss, want_g = ref_loss(arch, ref_cfg, g, inputs)(ref_p)
    leaves = tree_leaves(p)
    for leaf in leaves:
        leaf.requires_grad_()
    loss = sum((o.float() ** 2).mean()
               for o in outputs(port_apply(arch, p, cfg, tg, inputs)))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    want_leaves = tree_leaves(gnn.params_from_arrays(to_numpy(want_g), CPU))
    assert len(grads) == len(want_leaves)
    for i, (a, b) in enumerate(zip(grads, want_leaves)):
        a = torch.zeros_like(b) if a is None else a
        leaf_close(a, b.numpy(), 1e-5, f"{arch} leaf {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_inits_draw_the_reference_tree(arch):
    """Same leaves, shapes and dtypes, in the same order; every weight
    drawn (not zero), on the device asked for."""
    from repro_torch.configs.archs import smoke_config
    ref_cfg, cfg, ref_p, _, _ = arch_case(arch, "pull")
    got = INIT[arch](cfg, seed=3, device=CPU)
    want = gnn.params_from_arrays(to_numpy(ref_p), CPU)
    gl, wl = tree_leaves(got), tree_leaves(want)
    assert [(tuple(a.shape), a.dtype) for a in gl] == [
        (tuple(b.shape), b.dtype) for b in wl]
    assert all(a.device == CPU for a in gl)
    again = INIT[arch](smoke_config(arch), seed=3, device=CPU)
    assert all(torch.equal(a, b) for a, b in zip(gl, tree_leaves(again)))


# -- gin_apply_mp ------------------------------------------------------------
MP_SHARDS = (1, 2, 4)
MP_N = 48
MP_CFG = {"arch": "gin-tu", "n_layers": 2, "d_hidden": 16, "d_in": 8,
          "d_out": 4}

MP_REFERENCE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from jax.sharding import Mesh
import repro
from repro.models import gnn

cfg = gnn.GNNConfig(**json.loads(sys.argv[3]))
inp = dict(np.load(sys.argv[2]))
params = gnn.gin_init(jax.random.PRNGKey(0), cfg)
out = {f"param/{i}": np.asarray(a)
       for i, a in enumerate(jax.tree_util.tree_leaves(params))}
for P in json.loads(sys.argv[4]):
    mesh = Mesh(np.array(jax.devices()[:P]), ("data",))
    out[f"out/{P}"] = np.asarray(gnn.gin_apply_mp(
        params, cfg, inp["h"], inp[f"src/{P}"], inp[f"dst/{P}"], mesh))
np.savez(sys.argv[1], **out)
print("reference ok")
"""


def edges_by_dst_owner(src: np.ndarray, dst: np.ndarray, n: int, P: int):
    """[P, cap] rows of the edges owned by each destination shard,
    sentinel-padded with n."""
    owner = dst // (n // P)
    rows = [np.flatnonzero(owner == p) for p in range(P)]
    cap = max(8, -(-max(len(r) for r in rows) // 8) * 8)
    e_src = np.full((P, cap), n, np.int32)
    e_dst = np.full((P, cap), n, np.int32)
    for p, r in enumerate(rows):
        e_src[p, :len(r)], e_dst[p, :len(r)] = src[r], dst[r]
    return e_src, e_dst


@pytest.fixture(scope="module")
def mp_reference(tmp_path_factory):
    """Inputs, the reference's parameters and its outputs per P, from a
    fresh interpreter with 8 fake XLA host devices."""
    tmp = tmp_path_factory.mktemp("gnn_mp")
    rng = np.random.default_rng(13)
    src = rng.integers(0, MP_N, 300)
    dst = rng.integers(0, MP_N - 3, 300)
    inp = {"h": rng.normal(size=(MP_N, MP_CFG["d_in"])).astype(np.float32)}
    for P in MP_SHARDS:
        inp[f"src/{P}"], inp[f"dst/{P}"] = edges_by_dst_owner(src, dst,
                                                              MP_N, P)
    np.savez(tmp / "in.npz", **inp)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", MP_REFERENCE,
                        str(tmp / "out.npz"), str(tmp / "in.npz"),
                        json.dumps(MP_CFG), json.dumps(MP_SHARDS)],
                       capture_output=True, text=True, timeout=600, env=env,
                       cwd=str(ROOT))
    assert r.returncode == 0, r.stdout + r.stderr
    return inp, dict(np.load(tmp / "out.npz")), (src, dst)


@pytest.mark.parametrize("P", MP_SHARDS)
def test_gin_apply_mp_matches_reference(mp_reference, P):
    inp, ref, (src, dst) = mp_reference
    cfg = gnn.GNNConfig(**MP_CFG)
    treedef = jax.tree_util.tree_structure(
        ref_gnn.gin_init(KEY, ref_gnn.GNNConfig(**MP_CFG)))
    leaves = [ref[f"param/{i}"] for i in range(treedef.num_leaves)]
    p = gnn.params_from_arrays(jax.tree_util.tree_unflatten(treedef, leaves),
                               CPU)
    mesh = make_shard_mesh(P, devices=[CPU] * P)
    got = gnn.gin_apply_mp(p, cfg, t(inp["h"]), t(inp[f"src/{P}"]),
                           t(inp[f"dst/{P}"]), mesh)
    close(got, ref[f"out/{P}"])
    # and the single-device GIN over the same edges
    ev = EdgeView(src=t(src.astype(np.int32)), dst=t(dst.astype(np.int32)),
                  w=torch.ones(len(src)), n=MP_N, m=len(src))
    torch.testing.assert_close(got, gnn.gin_apply(p, cfg, ev, t(inp["h"])),
                               rtol=1e-5, atol=1e-5)
    # gradients reach the parameters through every shard
    leaves = tree_leaves(p)
    for leaf in leaves:
        leaf.requires_grad_()
    out = gnn.gin_apply_mp(p, cfg, t(inp["h"]), t(inp[f"src/{P}"]),
                           t(inp[f"dst/{P}"]), mesh)
    grads = torch.autograd.grad(out.square().mean(), leaves)
    want = torch.autograd.grad(
        gnn.gin_apply(p, cfg, ev, t(inp["h"])).square().mean(), leaves)
    for a, b in zip(grads, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_gin_apply_mp_refuses_rows_that_do_not_split():
    cfg = gnn.GNNConfig(**MP_CFG)
    p = gnn.gin_init(cfg, device=CPU)
    e = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="split"):
        gnn.gin_apply_mp(p, cfg, torch.zeros(10, 8), e, e,
                         make_shard_mesh(4, devices=[CPU] * 4))
