"""The port's sharded engine (``repro_torch.shard``, the graph side of
``repro_torch.dist`` and ``DistributedBackend``) on the CPU.

The reference runs once per module in a fresh interpreter with XLA
faking 8 host devices, as ``tests/test_shard.py`` runs it, and writes its
results to an ``.npz`` file; the port runs the same cases on meshes of
``[torch.device("cpu")] * P`` and must equal it:

  * ``ShardedBackend`` on ``erdos_renyi(130, 4.0, seed=5)`` (130 does
    not divide by 4 or 8: the partition pads) for BFS, PageRank and
    Δ-stepping SSSP × push, pull and auto × P = 1, 2, 4 and 8: state,
    every ``Cost`` counter, steps and every ``StepTrace`` row. States
    are exact but for float sums (rtol 1e-5, atol 1e-6, the reference's
    own tolerance): the push's ``psum_scatter`` reassociates, and the
    port's segment sums differ from XLA's in the last bit already on one
    device (the sharded pull equals the port's dense backend exactly);
  * ``solve_batch`` of BFS and SSSP through an 8-shard backend;
  * ``DistributedBackend`` at n = 128, P = 4 (BFS and PageRank under
    push and pull), and at n = 130, where the reference stops at a jax
    limit, against the port's dense backend;
  * PageRank push compressed with ``topk`` and with ``int8`` at P = 4:
    state and ``collective_bytes``.

The rest runs the port alone: mesh and partition validation, the
predictor against the charged wire bytes with a real cut, the pull
layout's COO order, the communication-only AutoSwitch flip, identity
semantics, the inner executors against the single-device backends,
``run`` against ``run_stepwise`` with the compression carry, checkpoint
resumes, and the ``shard.exchange.*`` fault sites.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import api, resilience
from repro_torch.core import (AutoSwitch, Cost, CostPredictor, CostWeights,
                              CudaBackend, Direction, EllBackend,
                              PushPullEngine, StepStats)
from repro_torch.core.algorithms import pagerank_init, pagerank_program
from repro_torch.core.backend import DistributedBackend
from repro_torch.core.engine import Checkpoint
from repro_torch.dist import CompressionConfig, compress_tree
from repro_torch.graphs import GRAPH_ARRAYS, erdos_renyi, graph_from_arrays
from repro_torch.graphs.partition import partition_1d
from repro_torch.dist import collectives
from repro_torch.shard import (ShardedBackend, build_topology,
                               make_shard_mesh)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SHARDS = (1, 2, 4, 8)
POLICIES = ("push", "pull", "auto")
CASES = {"bfs": {"root": 0}, "pagerank": {"iters": 20},
         "sssp_delta": {"source": 0, "delta": 2.0}}
TRACE = 64
DIST_RUNS = [(alg, pol) for alg in ("bfs", "pagerank")
             for pol in ("push", "pull")]
COMPRESSIONS = {"topk": CompressionConfig("topk", 0.05),
                "int8": CompressionConfig("int8")}
BATCHES = {"bfs": ([0, 5, 9], {}), "sssp_delta": ([0, 5], {"delta": 2.0})}

REFERENCE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from repro import api
from repro.core.backend import DistributedBackend
from repro.dist.compression import CompressionConfig
from repro.graphs.generators import erdos_renyi
from repro.shard import ShardedBackend

out, meta = {}, {}
ARRAYS, CASES, SHARDS, POLICIES, TRACE, DIST_RUNS, COMP, BATCHES = \
    json.loads(sys.argv[2])


def record(key, r, trace=True):
    for i, leaf in enumerate(jax.tree_util.tree_leaves(r.state)):
        out[f"{key}/state/{i}"] = np.asarray(leaf)
    steps = int(r.steps)
    meta[key] = {"cost": r.cost.as_dict(), "steps": steps,
                 "push_steps": int(r.push_steps),
                 "converged": bool(r.converged), "epochs": int(r.epochs),
                 "trace": r.trace.as_dict(steps) if trace else None}


def graph(n, key):
    g = erdos_renyi(n, 4.0, seed=5, weighted=True)
    for f in ARRAYS:
        out[f"{key}/{f}"] = np.asarray(getattr(g, f))
    meta[key] = [g.n, g.m, g.d_ell]
    return g


g = graph(130, "g130")
for algo, kw in CASES.items():
    for pol in POLICIES:
        for P in SHARDS:
            sb = ShardedBackend.prepare(g, num_shards=P)
            record(f"shard|{algo}|{pol}|{P}",
                   api.solve(g, algo, policy=pol, backend=sb, trace=TRACE,
                             **kw))
for algo, (sources, kw) in BATCHES.items():
    br = api.solve_batch(g, algo, sources=sources, backend="shard", **kw)
    for i, st in enumerate(br.states):
        for j, leaf in enumerate(jax.tree_util.tree_leaves(st)):
            out[f"batch|{algo}/{i}/{j}"] = np.asarray(leaf)
    meta[f"batch|{algo}"] = {"cost": br.cost.as_dict(),
                             "steps": int(br.steps),
                             "push_steps": int(br.push_steps)}
for kind, frac in COMP.items():
    sb = ShardedBackend.prepare(
        g, num_shards=4, compression=CompressionConfig(kind, frac))
    record(f"comp|{kind}", api.solve(g, "pagerank", policy="push",
                                     backend=sb, iters=20), trace=False)

# one compressed push step at P = 2 (its psum_scatter adds two terms, so
# it is exact) with a nonzero error carry
from repro.core.direction import Direction
rng = np.random.default_rng(0)
out["step/vals"] = rng.random(g.n).astype(np.float32)
out["step/front"] = rng.random(g.n) < 0.5
out["step/err"] = (rng.standard_normal((2, g.n)) * 1e-3).astype(np.float32)
for kind, frac in COMP.items():
    sb = ShardedBackend.prepare(
        g, num_shards=2, compression=CompressionConfig(kind, frac))
    o, c, e = sb.relax_ex(g, out["step/vals"], out["step/front"],
                          direction=Direction.PUSH, combine="sum",
                          msg_fn=lambda x, w: x * w, xstate=out["step/err"])
    out[f"step|{kind}/out"], out[f"step|{kind}/err"] = np.asarray(o), \
        np.asarray(e)
    meta[f"step|{kind}"] = c.as_dict()

g128 = graph(128, "g128")
db = DistributedBackend.prepare(g128, mesh=jax.make_mesh((4, 1),
                                                         ("data", "model")))
for algo, pol in DIST_RUNS:
    record(f"dist|{algo}|{pol}",
           api.solve(g128, algo, policy=pol, backend=db, trace=TRACE,
                     **CASES[algo]))
np.savez(sys.argv[1], **out)
with open(sys.argv[1] + ".json", "w") as f:
    json.dump(meta, f)
print("reference ok")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's results, from a fresh interpreter with 8 fake XLA
    host devices: ``(arrays, meta)``."""
    path = str(tmp_path_factory.mktemp("shard_ref") / "ref.npz")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    args = [list(GRAPH_ARRAYS), CASES, SHARDS, POLICIES, TRACE, DIST_RUNS,
            {k: c.topk_frac for k, c in COMPRESSIONS.items()},
            {k: list(v) for k, v in BATCHES.items()}]
    r = subprocess.run([sys.executable, "-c", REFERENCE, path,
                        json.dumps(args)], capture_output=True, text=True,
                       timeout=600, env=env, cwd=str(ROOT))
    assert r.returncode == 0, r.stdout + r.stderr
    with open(path + ".json") as f:
        meta = json.load(f)
    return dict(np.load(path)), meta


def port_graph(reference, key):
    arrays, meta = reference
    n, m, d_ell = meta[key]
    return graph_from_arrays({f: arrays[f"{key}/{f}"] for f in GRAPH_ARRAYS},
                             n=n, m=m, d_ell=d_ell, device="cpu")


def leaves(state) -> list:
    return ([state[k] for k in sorted(state)] if isinstance(state, dict)
            else [state])


def assert_state(got, arrays, key, float_tol: bool):
    got = leaves(got)
    want = [arrays[f"{key}/state/{i}"] for i in range(len(got))]
    assert f"{key}/state/{len(got)}" not in arrays
    for a, b in zip(got, want):
        a = a.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape
        if float_tol and a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_array_equal(a, b)


def assert_run(got, meta: dict, trace: bool = True):
    assert got.cost.as_dict() == meta["cost"]
    assert (got.steps, got.push_steps, got.converged, got.epochs) == (
        meta["steps"], meta["push_steps"], meta["converged"],
        meta["epochs"])
    if trace:
        assert got.trace.as_dict(got.steps) == meta["trace"]


def cpu_shards(g, P: int, **kw) -> ShardedBackend:
    return ShardedBackend.prepare(g, num_shards=P, devices=[CPU] * P, **kw)


# ---------------------------------------------------------------------
# against the reference on 8 fake host devices

@pytest.mark.dist
@pytest.mark.subprocess
@pytest.mark.parametrize("P", SHARDS)
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("alg", sorted(CASES))
def test_sharded_solve_matches_reference(reference, alg, policy, P):
    arrays, meta = reference
    g = port_graph(reference, "g130")
    sb = cpu_shards(g, P)
    got = api.solve(g, alg, policy=policy, backend=sb, trace=TRACE,
                    **CASES[alg])
    key = f"shard|{alg}|{policy}|{P}"
    # min combines are exact; float sums are held to 1e-5 / 1e-6: a push
    # sum's psum_scatter adds the shards' partials in another order, and
    # the port's single-device segment sums already differ from XLA's in
    # the last bit (the sharded pull equals the port's dense backend bit
    # for bit: test_sharded_pull_keeps_the_dense_combine_order)
    assert_state(got.state, arrays, key, float_tol=(alg == "pagerank"))
    assert_run(got, meta[key])


@pytest.mark.dist
@pytest.mark.subprocess
@pytest.mark.parametrize("alg", sorted(BATCHES))
def test_sharded_solve_batch_matches_reference(reference, alg):
    arrays, meta = reference
    g = port_graph(reference, "g130")
    sources, kw = BATCHES[alg]
    br = api.solve_batch(g, alg, sources=sources, backend=cpu_shards(g, 8),
                         **kw)
    for i, st in enumerate(br.states):
        for j, leaf in enumerate(leaves(st)):
            np.testing.assert_array_equal(leaf.numpy(),
                                          arrays[f"batch|{alg}/{i}/{j}"])
        single = api.solve(g, alg, **{("root" if alg == "bfs"
                                       else "source"): sources[i]}, **kw)
        for a, b in zip(leaves(st), leaves(single.state)):
            assert torch.equal(a, b)
    want = meta[f"batch|{alg}"]
    assert br.cost.as_dict() == want["cost"]
    assert (br.steps, br.push_steps) == (want["steps"], want["push_steps"])


@pytest.mark.dist
@pytest.mark.subprocess
@pytest.mark.parametrize("alg,policy", DIST_RUNS)
def test_distributed_backend_matches_reference(reference, alg, policy):
    arrays, meta = reference
    g = port_graph(reference, "g128")
    db = DistributedBackend.prepare(g, devices=[CPU] * 4)
    got = api.solve(g, alg, policy=policy, backend=db, trace=TRACE,
                    **CASES[alg])
    key = f"dist|{alg}|{policy}"
    assert_state(got.state, arrays, key, float_tol=True)
    assert_run(got, meta[key])


@pytest.mark.dist
@pytest.mark.parametrize("alg,policy", DIST_RUNS)
def test_distributed_backend_pads_where_p_does_not_divide_n(alg, policy):
    """n = 130 over 4 shards (the reference raises there, a jax limit):
    the partition pads and the answer equals the dense backend's."""
    g = erdos_renyi(130, 4.0, seed=5, weighted=True, device="cpu")
    db = DistributedBackend.prepare(g, devices=[CPU] * 4)
    assert db.part.n_padded == 132
    got = api.solve(g, alg, policy=policy, backend=db, **CASES[alg])
    want = api.solve(g, alg, policy=policy, **CASES[alg])
    for a, b in zip(leaves(got.state), leaves(want.state)):
        if a.dtype.is_floating_point:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        else:
            assert torch.equal(a, b)
    # per step, over 4 devices: the combined alltoall moves n_padded
    # float32/int32 items per device, the all_gather 3/4 of them
    nbytes = 132 * 4 * 4 if policy == "push" else 132 * 4 * 3 // 4 * 4
    assert int(got.cost.collective_bytes) == got.steps * nbytes


@pytest.mark.dist
@pytest.mark.subprocess
@pytest.mark.parametrize("kind", sorted(COMPRESSIONS))
def test_compressed_push_step_matches_reference(reference, kind):
    """One compressed push with a nonzero error carry at P = 2: the
    delivered sums, the new error carry and the Cost bit for bit."""
    arrays, meta = reference
    g = port_graph(reference, "g130")
    sb = cpu_shards(g, 2, compression=COMPRESSIONS[kind])
    err = tuple(torch.from_numpy(e) for e in arrays["step/err"])
    out, cost, new_err = sb.relax_ex(
        g, torch.from_numpy(arrays["step/vals"]),
        torch.from_numpy(arrays["step/front"]), direction=Direction.PUSH,
        combine="sum", msg_fn=lambda x, w: x * w, xstate=err)
    np.testing.assert_array_equal(out.numpy(), arrays[f"step|{kind}/out"])
    np.testing.assert_array_equal(torch.stack(new_err).numpy(),
                                  arrays[f"step|{kind}/err"])
    assert cost.as_dict() == meta[f"step|{kind}"]


@pytest.mark.dist
@pytest.mark.subprocess
@pytest.mark.parametrize("kind", sorted(COMPRESSIONS))
def test_compressed_push_matches_reference(reference, kind):
    """PageRank push, 20 steps at P = 4. top-k holds 1e-5 / 1e-6. int8
    is held to two of its quanta (max|rank| / 127 each): the two packages'
    float32 sums differ in the last bit (the reassociated psum_scatter),
    and at step 9 one accumulator entry that lies within an ulp of a
    half quantum rounds the other way in each, a one-quantum difference
    that error feedback then carries (the step itself is exact, above).
    Every Cost counter and the wire bytes are exact."""
    arrays, meta = reference
    g = port_graph(reference, "g130")
    sb = cpu_shards(g, 4, compression=COMPRESSIONS[kind])
    got = api.solve(g, "pagerank", policy="push", backend=sb, iters=20)
    key = f"comp|{kind}"
    if kind == "int8":
        want = arrays[f"{key}/state/0"]
        np.testing.assert_allclose(got.state.numpy(), want, rtol=0,
                                   atol=2 * np.abs(want).max() / 127)
    else:
        assert_state(got.state, arrays, key, float_tol=True)
    assert_run(got, meta[key], trace=False)
    cfg = COMPRESSIONS[kind]
    per_dev = (max(1, int(cfg.topk_frac * 132)) * 8 if kind == "topk"
               else 132 + 4)
    assert int(got.cost.collective_bytes) == got.steps * 4 * per_dev


def test_topk_keeps_the_lower_index_on_ties():
    """``compress_tree``'s top-k picks what ``jax.lax.top_k`` picks when
    magnitudes tie, and its int8 rounds as ``jnp.round`` does."""
    import jax
    import jax.numpy as jnp

    from repro.dist.compression import compress_tree as ref_compress
    from repro.dist.compression import CompressionConfig as RefConfig
    x = np.array([0.5, -2.0, 2.0, 1.0, -2.0, 0.25, 2.0, -1.0, 1.0, 0.5,
                  -0.5, 2.0], np.float32)
    for frac in (0.1, 0.25, 0.4, 0.75):
        tree = {"a": x, "b": [x[::-1].copy(), x[:5].copy()]}
        want, werr = ref_compress(jax.tree.map(jnp.asarray, tree),
                                  jax.tree.map(jnp.zeros_like, tree),
                                  RefConfig("topk", frac))
        tt = {"a": torch.from_numpy(x), "b": [torch.from_numpy(v) for v in
                                             tree["b"]]}
        got, gerr = compress_tree(
            tt, {"a": torch.zeros(12), "b": [torch.zeros(12),
                                             torch.zeros(5)]},
            CompressionConfig("topk", frac))
        for a, b in zip(jax.tree_util.tree_leaves(want) +
                        jax.tree_util.tree_leaves(werr),
                        [got["a"], *got["b"], gerr["a"], *gerr["b"]]):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    y = np.array([127 * 0.5, -127 * 1.5, 127.0, 3.0, -0.5, 2.5], np.float32)
    want, _ = ref_compress(jnp.asarray(y), jnp.zeros(6), RefConfig("int8"))
    got, _ = compress_tree(torch.from_numpy(y), torch.zeros(6),
                           CompressionConfig("int8"))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------
# the port alone

@pytest.fixture(scope="module")
def small_graph():
    return erdos_renyi(120, 4.0, seed=11, weighted=True, device="cpu")


def test_mesh_validation():
    with pytest.raises(ValueError, match="at least one shard"):
        make_shard_mesh(0, devices=[CPU] * 2)
    with pytest.raises(ValueError, match="exceeds the 2 devices in "
                                         "`devices`"):
        make_shard_mesh(3, devices=[CPU] * 2)
    mesh = make_shard_mesh(devices=[CPU] * 3)
    assert mesh.shape == {"data": 3, "model": 1} and mesh.devices == (CPU,) * 3


def test_mesh_and_shorthand_need_cuda_without_devices(small_graph):
    """No quiet CPU mesh: without CUDA and without ``devices`` the mesh,
    the backends and the ``"shard"`` shorthand raise naming
    ``devices``."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for call in (lambda: make_shard_mesh(),
                 lambda: ShardedBackend.prepare(small_graph),
                 lambda: DistributedBackend.prepare(small_graph),
                 lambda: api.solve(small_graph, "bfs", root=0,
                                   backend="shard")):
        with pytest.raises(RuntimeError, match="devices="):
            call()


def test_prepare_validates_num_shards(small_graph):
    with pytest.raises(ValueError, match="at least one shard"):
        cpu_shards(small_graph, 0)
    with pytest.raises(ValueError, match="unknown inner"):
        ShardedBackend.prepare(small_graph, devices=[CPU], inner="pallas")
    mesh = make_shard_mesh(1, devices=[CPU])
    with pytest.raises(ValueError, match="must equal the mesh"):
        ShardedBackend.prepare(small_graph, mesh=mesh, num_shards=2)
    tiny = erdos_renyi(6, 1.5, seed=1, device="cpu")
    with pytest.raises(ValueError, match="exceeds the vertex count"):
        cpu_shards(tiny, 8)


@pytest.mark.parametrize("combine,msg", [("sum", "mul"), ("min", "add"),
                                         ("max", "copy")])
def test_predictor_matches_charged_bytes_with_a_real_cut(small_graph,
                                                         combine, msg):
    """predict_comm_bytes equals what push and pull then charge, at
    P = 4 (a real cut), on a sparse and a full frontier."""
    g = small_graph
    sb = cpu_shards(g, 4)
    assert sb.cut_edges > 0
    fn = {"mul": lambda x, w: x * w, "add": lambda x, w: x + w,
          "copy": None}[msg]
    vals = torch.rand(g.n, generator=torch.Generator().manual_seed(0))
    for frontier in (torch.arange(g.n) % 7 == 0,
                     torch.ones(g.n, dtype=torch.bool)):
        pb, lb = sb.predict_comm_bytes(g, vals, frontier)
        _, cp = sb.push(g, vals, frontier, combine, fn, Cost())
        _, cl = sb.pull(g, vals, None, combine, fn, Cost())
        assert int(cp.collective_bytes) == int(pb) > 0
        assert int(cl.collective_bytes) == int(lb) > 0


def test_topology_pull_groups_preserve_coo_order(small_graph):
    g = small_graph
    part = partition_1d(g.n, 4)
    topo = build_topology(g, part)
    dst, src = g.coo_dst.numpy(), g.coo_src.numpy()
    own = part.owner_np(dst)
    for p in range(4):
        ok = topo.pull_edges.valid[p].numpy()
        np.testing.assert_array_equal(topo.pull_edges.src[p].numpy()[ok],
                                      src[own == p])
        np.testing.assert_array_equal(topo.pull_edges.dst[p].numpy()[ok],
                                      dst[own == p])
    # the ELL blocks: [P, shard_size, d_ell], sentinel rows past n
    idx = np.stack([b.numpy() for b in topo.ell_idx])
    w = np.stack([b.numpy() for b in topo.ell_w])
    assert idx.shape == (4, part.shard_size, g.d_ell)
    flat = idx.reshape(part.n_padded, g.d_ell)
    np.testing.assert_array_equal(flat[:g.n], g.ell_idx.numpy())
    assert (flat[g.n:] == g.n).all() and (w.reshape(-1, g.d_ell)[g.n:]
                                          == 0).all()
    lens = np.concatenate([t.numpy() for t in topo.row_len])
    np.testing.assert_array_equal(lens[:g.n], g.in_deg.numpy())


@pytest.mark.parametrize("P", (1, 3, 4))
def test_collectives_over_per_shard_tensors(P):
    """all_gather, psum_scatter and pmin/pmax with the owner slice over
    P per-shard tensors, against the same reductions on one stack."""
    devs = [CPU] * P
    gen = torch.Generator().manual_seed(P)
    blocks = [torch.randn(2, 3, generator=gen) for _ in range(P)]
    whole = torch.cat(blocks)
    assert all(torch.equal(x, whole)
               for x in collectives.all_gather(blocks, devs))
    full = [torch.randn(2 * P, 3, generator=gen) for _ in range(P)]
    stack = torch.stack(full)
    torch.testing.assert_close(
        torch.cat(collectives.psum_scatter(full, devs)), stack.sum(0),
        rtol=1e-6, atol=1e-6)
    assert torch.equal(torch.cat(collectives.pmin_scatter(full, devs)),
                       stack.amin(0))
    assert torch.equal(torch.cat(collectives.pmax_scatter(full, devs)),
                       stack.amax(0))
    assert torch.equal(collectives.unshard(
        collectives.shard_blocks(whole, devs), CPU), whole)


def test_autoswitch_flips_for_comm_asymmetry_alone():
    """Two steps equal in every §4 counter, differing only in wire
    bytes: the predictor orders them by the collective term."""
    i64 = lambda v: torch.tensor(v, dtype=torch.int64)  # noqa: E731
    base = dict(frontier_vertices=i64(8), frontier_edges=i64(100),
                pull_edges=i64(100), pull_vertices=i64(50),
                unvisited_edges=i64(100), step=1, prev_push=True)
    predictor = CostPredictor(weights=CostWeights(collective_byte=0.5))
    even = StepStats(**base, push_wire_bytes=i64(0), pull_wire_bytes=i64(0))
    push_heavy = StepStats(**base, push_wire_bytes=i64(10_000),
                           pull_wire_bytes=i64(0))
    pull_heavy = StepStats(**base, push_wire_bytes=i64(0),
                           pull_wire_bytes=i64(10_000))
    auto = AutoSwitch(predictor=predictor)
    assert float(predictor.predict_push(push_heavy)) == pytest.approx(
        float(predictor.predict_push(even)) + 10_000 * 0.5)
    assert float(predictor.predict_pull(pull_heavy)) == pytest.approx(
        float(predictor.predict_pull(even)) + 10_000 * 0.5)
    assert not bool(auto.decide(None, None, push_heavy))
    assert bool(auto.decide(None, None, pull_heavy))


def test_sparse_push_prices_below_pull_on_sparse_frontier():
    g = erdos_renyi(120, 4.0, seed=3, weighted=True, device="cpu")
    sb = cpu_shards(g, 4)
    vals = torch.ones(g.n)
    sparse = torch.zeros(g.n, dtype=torch.bool)
    sparse[0] = True
    pb_sparse, lb = sb.predict_comm_bytes(g, vals, sparse)
    pb_dense, _ = sb.predict_comm_bytes(g, vals,
                                        torch.ones(g.n, dtype=torch.bool))
    assert int(pb_sparse) < int(lb)
    assert int(pb_dense) >= int(lb)


@pytest.mark.parametrize("P", SHARDS)
def test_sharded_pull_keeps_the_dense_combine_order(P):
    """The dense inner executor's per-shard rows keep each destination's
    in-edges in the global COO order, so PageRank's pull sums equal the
    single-device dense backend's bit for bit at every shard count."""
    g = erdos_renyi(130, 4.0, seed=5, weighted=True, device="cpu")
    want = api.solve(g, "pagerank", policy="pull", iters=20)
    got = api.solve(g, "pagerank", policy="pull", backend=cpu_shards(g, P),
                    iters=20)
    assert torch.equal(got.state, want.state)


def test_shard_shorthand_requires_graph_context():
    with pytest.raises(ValueError, match="graph-specific"):
        api._resolve_backend("shard")


def test_shard_backend_identity_semantics(small_graph):
    a = cpu_shards(small_graph, 1)
    b = cpu_shards(small_graph, 1)
    assert a == a and a != b and len({a, b}) == 2


@pytest.mark.parametrize("P", (2, 8))
@pytest.mark.parametrize("inner", ("ell", "cuda"))
def test_inner_executors_match_single_device_pulls(P, inner):
    """Each inner executor equals its single-device backend bit for bit:
    ``ell`` the ELL backend, ``cuda`` the CUDA backend (both run the
    kernel's plain version here, which sums float32 in float64 and
    rounds once), and the ELL backend to float32 rounding; min and max
    equal the ELL backend's exactly."""
    g = erdos_renyi(130, 4.0, seed=5, weighted=True, device="cpu")
    vals = torch.rand(g.n, generator=torch.Generator().manual_seed(0))
    sb = cpu_shards(g, P, inner=inner)
    mul = lambda x, w: x * w  # noqa: E731
    got, _ = sb.pull(g, vals, None, "sum", mul, Cost())
    ell, _ = EllBackend().pull(g, vals, None, "sum", mul, Cost())
    if inner == "ell":
        assert torch.equal(got, ell)
    else:
        kern, _ = CudaBackend(autotune=False, block_n=64).pull(
            g, vals, None, "sum", mul, Cost())
        assert torch.equal(got, kern)
        torch.testing.assert_close(got, ell, rtol=1e-6, atol=0)
        assert sb.stats == {"kernel_pull": P, "fallback_pull": 0}
    ivals = torch.randint(0, 50, (g.n, 3), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(1))
    for combine in ("min", "max"):
        got, _ = sb.pull(g, ivals, None, combine, None, Cost())
        ell, _ = EllBackend().pull(g, ivals, None, combine, None, Cost())
        assert torch.equal(got, ell)


def test_unclassifiable_message_gives_way_to_ell_before_any_launch():
    g = erdos_renyi(130, 4.0, seed=5, weighted=True, device="cpu")
    vals = torch.rand(g.n, generator=torch.Generator().manual_seed(0))
    sb = cpu_shards(g, 4, inner="cuda")
    odd = lambda x, w: x * w * 2 + 1  # noqa: E731
    got, _ = sb.pull(g, vals, None, "sum", odd, Cost())
    want, _ = cpu_shards(g, 4, inner="ell").pull(g, vals, None, "sum", odd,
                                                 Cost())
    assert torch.equal(got, want)
    assert sb.stats == {"kernel_pull": 0, "fallback_pull": 1}
    assert sb.telemetry_counters()["fallback_pull"] == 1


def _pagerank_engine(g, backend, max_steps=20):
    program, _ = pagerank_program(g, iters=max_steps)
    return PushPullEngine(program=program,
                          policy=api.Fixed(Direction.PUSH),
                          max_steps=max_steps, backend=backend,
                          trace_capacity=32)


def _same(a, b):
    assert torch.equal(a.state, b.state)
    assert a.cost.as_dict() == b.cost.as_dict()
    assert (a.steps, a.push_steps, a.converged) == (b.steps, b.push_steps,
                                                    b.converged)
    assert a.trace.as_dict(a.steps) == b.trace.as_dict(b.steps)
    assert len(a.xstate) == len(b.xstate) == 4
    for x, y in zip(a.xstate, b.xstate):
        assert torch.equal(x, y)


@pytest.mark.parametrize("kind", sorted(COMPRESSIONS))
def test_run_equals_run_stepwise_with_the_compression_carry(kind):
    g = erdos_renyi(130, 4.0, seed=5, weighted=True, device="cpu")
    eng = _pagerank_engine(g, cpu_shards(g, 4,
                                         compression=COMPRESSIONS[kind]))
    init = pagerank_init(g)
    run = eng.run(g, *init)
    step = eng.run_stepwise(g, *init, on_step=lambda i, us: None)
    _same(run, step)
    # the carry is live: error feedback is left over at the end
    assert sum(float(e.abs().sum()) for e in run.xstate) > 0


def test_checkpointed_resume_equals_an_unbroken_run():
    g = erdos_renyi(130, 4.0, seed=5, weighted=True, device="cpu")
    eng = _pagerank_engine(g, cpu_shards(
        g, 4, compression=COMPRESSIONS["topk"]))
    init = pagerank_init(g)
    whole = eng.run_stepwise(g, *init)
    with pytest.raises(resilience.SolveInterrupted) as ei:
        plan = resilience.FaultPlan(name="t", seed=0, specs=(
            resilience.FaultSpec(site="engine.step", kind="permanent",
                                 start=10),))
        with resilience.inject(plan):
            eng.run_stepwise(g, *init, checkpoint_every=7)
    ck = ei.value.checkpoint
    assert isinstance(ck, Checkpoint) and ck.step == 7
    assert len(ck.carry.xstate) == 4
    _same(eng.run_stepwise(g, *init, resume_from=ck), whole)


@pytest.mark.parametrize("site,policy", [("shard.exchange.push", "push"),
                                         ("shard.exchange.pull", "pull")])
def test_exchange_fault_sites_fire_and_retry(site, policy):
    g = erdos_renyi(130, 4.0, seed=5, weighted=True, device="cpu")
    clean = api.solve(g, "bfs", root=0, policy=policy,
                      backend=cpu_shards(g, 4, inner="cuda"))
    plan = resilience.FaultPlan(name="t", seed=0, specs=(
        resilience.FaultSpec(site=site, kind="transient", every=3),))
    resilience.clear_resilience_stats()
    with resilience.inject(plan) as inj:
        got = api.solve(g, "bfs", root=0, policy=policy,
                        backend=cpu_shards(g, 4, inner="cuda"))
    assert inj.stats()["injected"].get(site, 0) >= 1
    assert resilience.resilience_stats().get(f"retry.{site}", 0) >= 1
    resilience.drain_events()
    assert torch.equal(got.state["dist"], clean.state["dist"])
    assert got.cost.as_dict() == clean.cost.as_dict()


def test_telemetry_reports_shard_geometry_and_residual():
    from repro_torch.obs import Telemetry
    g = erdos_renyi(130, 4.0, seed=5, weighted=True, device="cpu")
    sb = cpu_shards(g, 4, compression=COMPRESSIONS["int8"])
    tel = Telemetry()
    api.solve(g, "pagerank", policy="push", backend=sb, iters=5,
              telemetry=tel)
    c = tel.counters.as_dict()
    assert c["backend.ShardedBackend.num_shards"] == 4
    assert c["backend.ShardedBackend.cut_edges"] == sb.cut_edges > 0
    assert c["backend.ShardedBackend.n_padded"] == 132
    assert c["backend.ShardedBackend.compression"] == 1
    assert c["backend.shard.compression_residual_l1"] > 0


def test_query_service_serves_through_the_sharded_backend():
    from repro_torch.service import QueryService
    g = erdos_renyi(130, 4.0, seed=5, weighted=True, device="cpu")
    svc = QueryService(g, slots=4, backend=cpu_shards(g, 4, inner="cuda"))
    rids = [svc.submit("bfs", s) for s in (0, 5, 9)] + [
        svc.submit("ppr", 3)]
    svc.run_until_complete()
    for rid, s in zip(rids, (0, 5, 9)):
        assert torch.equal(svc.poll(rid)["dist"],
                           api.solve(g, "bfs", root=s).state["dist"])
    torch.testing.assert_close(
        svc.poll(rids[3])["ranks"],
        api.solve(g, "ppr", source=3).state["ranks"], rtol=1e-5, atol=1e-6)
