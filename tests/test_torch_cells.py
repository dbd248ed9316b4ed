"""Slice 12 of the port against the JAX package: the cell registry
(``configs.steps``, ``configs.registry``), ``launch.mesh`` and the
parameter specs of ``dist.sharding``.

  * the 40 (arch, shape) cells at (16, 16) and (2, 16, 16): a module
    fixture builds the reference's cells in a fresh interpreter with 512
    fake XLA host devices, on meshes made with ``AxisType.Auto`` axes
    (``make_production_mesh``'s Explicit axes make jax 0.9 refuse the
    five ``prefill_32k`` cells), and writes each cell's argument leaves,
    meta and per-device argument, output and donated bytes
    (``NamedSharding.shard_shape``) as JSON. The port's cells must have
    the same leaves (shape and dtype, the reference's stacked [L, ...]
    layer leaves read as L per-layer leaves, as
    ``transformer.params_from_arrays`` reads them), the same meta and
    the same bytes from its specs on a ``MeshLayout``;
  * the step functions: with each package's ``full_config`` patched to
    its smoke config, one step of the LM (train, prefill, decode; int8
    caches, gemma2's ring, deepseek's experts), GNN (the four archs,
    ``mp_exchange``) and recsys (train, serve, retrieval) cells on a
    (1, 1) mesh, on the reference's weights and inputs carried across.
    Losses and outputs agree to 1e-5 (f32); after one AdamW step the
    parameters to 1e-5 and the first moments (the clipped gradients),
    leaf by leaf, to 1e-4 of their global norm: a ReLU input within f32
    rounding of zero takes its unit's gradient with it. (GraphSAGE runs
    at ``molecule``: at ``full_graph_sm`` one of its 43,000 first-layer
    ReLU inputs sits within f32 rounding of zero, and through 1433-wide
    features that one unit moves the first-layer moments by 2e-3 of the
    norm in the port's f32 run, while the reference's run and a float64
    run of the port agree to 2e-8; GIN covers ``full_graph_sm``.) bf16
    caches to one bf16 rounding, int8 caches to one quantization step.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import archs as ref_archs
from repro.configs import steps as ref_steps
from repro.configs.shapes import ShapeSpec as RefShapeSpec
from repro.dist import sharding as ref_sharding
from repro.models import gnn as ref_gnn
from repro.models import recsys as ref_recsys
from repro.models import transformer as ref_tf
from repro.train.optimizer import init_opt as ref_init_opt
from repro_torch.configs import (ALL_ARCHS, ARCH_FAMILY, all_cells,
                                 build_cell, full_config, shape_table,
                                 smoke_config)
from repro_torch.configs import steps
from repro_torch.configs.registry import activation_mesh
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.dist import sharding
from repro_torch.dist.sharding import (REPLICATED, LayerSpec, Spec,
                                       make_sharding, shard_shape,
                                       tree_bytes_per_device)
from repro_torch.launch.mesh import (MeshLayout, make_local_mesh,
                                     make_production_mesh)
from repro_torch.models import gnn, recsys
from repro_torch.models import transformer as tf
from repro_torch.models.common import tensor_from_array, tree_leaves
from repro_torch.train.optimizer import opt_state_from_arrays

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"16x16": (("data", 16), ("model", 16)),
          "2x16x16": (("pod", 2), ("data", 16), ("model", 16))}
META_KEYS = ("n", "m", "n_true", "labeled", "n_graphs", "task", "kind",
             "cache_kind")

ORACLE = r"""
import json, math, sys
import numpy as np
import jax
from jax.sharding import AxisType
from repro.configs.registry import all_cells, build_cell

MESHES, META_KEYS = json.loads(sys.argv[2])


def leaves(tree):
    out = []
    for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = []
        for p in path:
            for attr in ("key", "idx", "name"):
                if hasattr(p, attr):
                    keys.append(getattr(p, attr))
                    break
        out.append([keys, list(x.shape), str(x.dtype)])
    return out


def dev_bytes(tree, shardings):
    return sum(math.prod(sh.shard_shape(x.shape)) * np.dtype(x.dtype).itemsize
               for x, sh in zip(jax.tree.leaves(tree),
                                jax.tree.leaves(shardings)))


F32 = jax.ShapeDtypeStruct((), np.float32)
res = {"cells": all_cells()}
for tag, axes in MESHES.items():
    names = tuple(a for a, _ in axes)
    mesh = jax.make_mesh(tuple(n for _, n in axes), names,
                         axis_types=(AxisType.Auto,) * len(names))
    for arch, sname in all_cells():
        c = build_cell(arch, sname, mesh)
        kind = c.meta["kind"]
        if kind == "train":
            outs = (c.args[0], c.args[1], F32)
        elif kind == "prefill":
            outs = jax.eval_shape(c.fn, *c.args)
        elif kind == "decode":
            outs = (jax.ShapeDtypeStruct(
                (c.args[1].shape[0], c.meta["cfg"].vocab), np.float32),
                c.args[2])
        elif kind == "serve":
            outs = jax.ShapeDtypeStruct((c.args[1].shape[0],), np.float32)
        else:
            outs = jax.ShapeDtypeStruct((c.args[2].shape[0],), np.float32)
        res[f"{tag}|{arch}@{sname}"] = {
            "name": c.name,
            "leaves": [leaves(a) for a in c.args],
            "meta": {k: c.meta[k] for k in META_KEYS if k in c.meta},
            "arg_bytes": dev_bytes(c.args, c.in_shardings),
            "out_bytes": dev_bytes(outs, c.out_shardings),
            "donated_bytes": sum(dev_bytes(c.args[i], c.in_shardings[i])
                                 for i in c.donate),
        }
with open(sys.argv[1], "w") as f:
    json.dump(res, f)
print("reference ok")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's 80 cells, built in a fresh interpreter with 512
    fake XLA host devices (set there, never in this process)."""
    path = str(tmp_path_factory.mktemp("cells_ref") / "cells.json")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=512")
    r = subprocess.run([sys.executable, "-c", ORACLE, path,
                        json.dumps([MESHES, META_KEYS])],
                       capture_output=True, text=True, timeout=600, env=env,
                       cwd=str(ROOT))
    assert r.returncode == 0, r.stdout + r.stderr
    with open(path) as f:
        return json.load(f)


@pytest.fixture(autouse=True)
def no_activation_mesh():
    """Cells install an activation mesh; leave none behind."""
    yield
    sharding.set_activation_mesh(None)
    ref_sharding.set_activation_mesh(None)


def port_leaves(tree, keys=()):
    """[dict keys / list indices / field names, shape, dtype] per tensor."""
    if isinstance(tree, torch.Tensor):
        return [[list(keys), list(tree.shape), str(tree.dtype).split(".")[1]]]
    if isinstance(tree, dict):
        return [x for k in tree for x in port_leaves(tree[k], keys + (k,))]
    if hasattr(tree, "_fields"):
        return [x for f in tree._fields
                for x in port_leaves(getattr(tree, f), keys + (f,))]
    return [x for i, t in enumerate(tree)
            for x in port_leaves(t, keys + (i,))]


def ref_leaves_as_port(leaves, family: str):
    """The reference's leaves with each stacked transformer layer leaf
    [L, ...] read as L leaves [...] (``params_from_arrays``)."""
    out = []
    for keys, shape, dt in leaves:
        if family == "lm" and "layers" in keys:
            i = keys.index("layers") + 1
            out += [[keys[:i] + [li] + keys[i:], shape[1:], dt]
                    for li in range(shape[0])]
        else:
            out.append([keys, shape, dt])
    return out


def by_path(leaves):
    return sorted(leaves, key=lambda x: json.dumps(x[0]))


def structural_outputs(cell):
    """The step's outputs as meta tensors, as the oracle builds them."""
    kind = cell.meta["kind"]
    meta = lambda *s: torch.empty(s, device="meta")  # noqa: E731
    if kind == "train":
        return cell.args[0], cell.args[1], meta()
    if kind == "prefill":
        B, T = cell.args[1].shape
        return (meta(B, cell.meta["cfg"].vocab),
                tf.init_kv_cache(cell.meta["cfg"], B, T,
                                 kind=cell.meta["cache_kind"],
                                 device="meta"))
    if kind == "decode":
        return meta(cell.args[1].shape[0], cell.meta["cfg"].vocab), \
            cell.args[2]
    return meta(cell.args[1 if kind == "serve" else 2].shape[0])


def test_all_cells_equal_the_reference(reference):
    assert [list(c) for c in all_cells()] == reference["cells"]
    assert len(all_cells()) == 40


@pytest.mark.parametrize("tag", list(MESHES))
@pytest.mark.parametrize("arch,shape", all_cells(),
                         ids=[f"{a}@{s}" for a, s in all_cells()])
def test_cell_matches_reference(reference, tag, arch, shape):
    ref = reference[f"{tag}|{arch}@{shape}"]
    mesh = MeshLayout(MESHES[tag])
    cell = build_cell(arch, shape, mesh)
    assert cell.name == ref["name"]
    assert len(cell.args) == len(ref["leaves"])
    for got, want in zip(cell.args, ref["leaves"]):
        assert by_path(port_leaves(got)) == by_path(
            ref_leaves_as_port(want, ARCH_FAMILY[arch]))
    assert {k: cell.meta[k] for k in META_KEYS if k in cell.meta} \
        == ref["meta"]
    assert all(t.device.type == "meta" for t in tree_leaves(cell.args))
    got = (tree_bytes_per_device(mesh, cell.in_shardings, cell.args),
           tree_bytes_per_device(mesh, cell.out_shardings,
                                 structural_outputs(cell)),
           sum(tree_bytes_per_device(mesh, cell.in_shardings[i],
                                     cell.args[i]) for i in cell.donate))
    assert got == (ref["arg_bytes"], ref["out_bytes"],
                   ref["donated_bytes"])


# ------------------------------------------------ meshes and specs --
def test_production_mesh_layout():
    single, multi = make_production_mesh(), make_production_mesh(
        multi_pod=True)
    assert single.shape == {"data": 16, "model": 16} and single.size == 256
    assert multi.axis_names == ("pod", "data", "model")
    assert multi.size == 512
    assert sharding.batch_axes(multi) == ("pod", "data")


def test_local_mesh_needs_the_card():
    if torch.cuda.is_available():
        assert make_local_mesh().shape["model"] == 1
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_local_mesh()


def test_make_sharding_drops_absent_and_non_dividing_axes():
    mesh = make_production_mesh(multi_pod=True)
    spec = make_sharding(mesh, (("pod", "data"), "model", "nope"),
                         (64, 40, 8))
    assert isinstance(spec, Spec) and tuple(spec) == (("pod", "data"),
                                                      None, None)
    assert shard_shape(mesh, spec, (64, 40, 8)) == (2, 40, 8)
    assert tuple(make_sharding(mesh, ("data",), (48,))) == ("data",)
    assert shard_shape(mesh, REPLICATED, (3, 5)) == (3, 5)


def test_layer_specs_split_the_layer_index_only_when_it_divides():
    mesh = make_production_mesh()
    cfg = full_config("gemma2-9b")                  # 42 layers over 16
    p = tf.init_params(cfg, device="meta")
    specs = sharding.transformer_param_specs(mesh, p, zero="pull")
    wq = specs["layers"][0]["attn"]["wq"]["w"]
    assert isinstance(wq, LayerSpec) and wq.layer is None
    assert tuple(wq.spec) == (None, "model")
    llama = tf.init_params(full_config("llama3.2-1b"), device="meta")
    s = sharding.transformer_param_specs(mesh, llama, zero="pull")
    assert s["layers"][3]["ln1"].layer == ("data",) or \
        s["layers"][3]["ln1"].layer == "data"
    push = sharding.transformer_param_specs(mesh, llama, zero="push")
    assert push["layers"][3]["ln1"].layer is None
    # 16 layers over 16 data ranks: each device holds one layer's share
    one = tree_bytes_per_device(mesh, s["layers"][0], llama["layers"][0])
    assert tree_bytes_per_device(mesh, s["layers"], llama["layers"]) == one \
        * 16


def test_activation_mesh_runs_the_model_axis_on_the_cell_device():
    act = activation_mesh(make_production_mesh(), "meta")
    assert act.shape == {"model": 16} and act.size == 16
    assert {d.type for d in act.devices} == {"meta"}


def test_meta_inits_match_the_cpu_inits_shapes():
    for arch in ALL_ARCHS:
        cfg = smoke_config(arch)
        if ARCH_FAMILY[arch] == "lm":
            init = tf.init_params
        elif ARCH_FAMILY[arch] == "recsys":
            init = recsys.xdeepfm_init
        else:
            cfg = dataclasses.replace(cfg, d_in=5, d_out=3)
            init = steps._GNN_INIT[arch]
        cpu = port_leaves(init(cfg, seed=0, device="cpu"))
        meta = init(cfg, seed=0, device="meta")
        assert port_leaves(meta) == cpu, arch
        assert {t.device.type for t in tree_leaves(meta)} == {"meta"}
    kv = tf.init_kv_cache(smoke_config("gemma2-9b"), 2, 16, "int8",
                          device="meta")
    assert port_leaves(kv) == port_leaves(tf.init_kv_cache(
        smoke_config("gemma2-9b"), 2, 16, "int8", device="cpu"))


def test_cpu_init_draws_the_same_weights_as_before():
    """The meta path leaves the seeded draws on a real device as they
    were: ``randn`` then scale, in f32, from the generator."""
    cfg = smoke_config("xdeepfm")
    p = recsys.xdeepfm_init(cfg, seed=3, device="cpu")
    gen = torch.Generator().manual_seed(3)
    want = torch.randn((cfg.n_fields, cfg.vocab_per_field, cfg.embed_dim),
                       generator=gen).mul_(0.01)
    assert torch.equal(p["tables"], want)


def test_cells_build_on_a_device_with_seeded_inputs():
    shape = ShapeSpec("serve_p99", "serve", {"batch": 32})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(steps, "full_config", smoke_config)
        a = steps.build_recsys_cell("xdeepfm", shape,
                                    make_production_mesh(), device="cpu")
        b = steps.build_recsys_cell("xdeepfm", shape,
                                    make_production_mesh(), device="cpu")
    ids = a.args[1]
    assert ids.dtype == torch.int32 and ids.device.type == "cpu"
    assert 0 <= int(ids.min()) and int(ids.max()) < smoke_config(
        "xdeepfm").vocab_per_field
    assert torch.equal(ids, b.args[1])
    assert torch.equal(a.fn(*a.args), b.fn(*b.args))


# --------------------------------------------------- step functions --
def ref_small_config(arch):
    cfg = ref_archs.smoke_config(arch)
    return dataclasses.replace(cfg, n_vars=227) if arch == "graphcast" \
        else cfg


def port_small_config(arch):
    cfg = smoke_config(arch)
    return dataclasses.replace(cfg, n_vars=227) if arch == "graphcast" \
        else cfg


LM_SMALL = {"train": dict(seq_len=16, global_batch=2),
            "prefill": dict(seq_len=16, global_batch=2),
            "decode": dict(seq_len=16, global_batch=2)}
RECSYS_SMALL = {"train_batch": ("train", dict(batch=8)),
                "serve_p99": ("serve", dict(batch=8)),
                "retrieval_cand": ("retrieval",
                                   dict(batch=1, n_candidates=16))}
STEP_CASES = [
    ("llama3.2-1b", "train"), ("llama3.2-1b", "prefill"),
    ("llama3.2-1b", "decode"), ("qwen1.5-32b", "prefill"),
    ("qwen1.5-32b", "decode"), ("gemma2-9b", "train"),
    ("gemma2-9b", "decode"), ("deepseek-moe-16b", "train"),
    ("gin-tu", "full_graph_sm"), ("gin-tu", "molecule"),
    ("gin-tu", "mp_exchange"), ("egnn", "molecule"),
    ("graphsage-reddit", "molecule"), ("graphcast", "molecule"),
    ("xdeepfm", "train_batch"), ("xdeepfm", "serve_p99"),
    ("xdeepfm", "retrieval_cand"),
]
ONE = (("data", 1), ("model", 1))


def build_pair(arch, case, monkeypatch):
    """(reference cell, port cell on the CPU) at the case's small size,
    each package's ``full_config`` its smoke config, meshes (1, 1)."""
    monkeypatch.setattr(ref_steps, "full_config", ref_small_config)
    monkeypatch.setattr(steps, "full_config", port_small_config)
    rmesh = jax.make_mesh((1, 1), ("data", "model"),
                          axis_types=(AxisType.Auto,) * 2)
    pmesh = MeshLayout(ONE)
    ref_sharding.set_activation_mesh(rmesh)
    sharding.set_activation_mesh(activation_mesh(pmesh, "cpu"))
    family = ARCH_FAMILY[arch]
    if family == "lm":
        kind = case
        return (ref_steps.build_lm_cell(
                    arch, RefShapeSpec(kind, kind, LM_SMALL[kind]), rmesh),
                steps.build_lm_cell(arch, ShapeSpec(kind, kind,
                                                    LM_SMALL[kind]),
                                    pmesh, device="cpu"))
    if family == "recsys":
        kind, params = RECSYS_SMALL[case]
        return (ref_steps.build_recsys_cell(
                    arch, RefShapeSpec(case, kind, params), rmesh),
                steps.build_recsys_cell(arch, ShapeSpec(case, kind, params),
                                        pmesh, device="cpu"))
    over = {"mp_exchange": True} if case == "mp_exchange" else None
    shape = "full_graph_sm" if case == "mp_exchange" else case
    return (ref_steps.build_gnn_cell(arch, shape_table("gnn")[shape], rmesh,
                                     overrides=over),
            steps.build_gnn_cell(arch, shape_table("gnn")[shape], pmesh,
                                 overrides=over, device="cpu"))


def ref_inputs(cell, arch, rng):
    """Numpy arguments for the reference cell: its own initializers'
    weights, zero moments, inputs within their ranges."""
    cfg, kind, meta = cell.meta["cfg"], cell.meta["kind"], cell.meta
    family = ARCH_FAMILY[arch]
    key = jax.random.PRNGKey(0)
    if family == "lm":
        params = ref_tf.init_params(key, cfg)
    elif family == "recsys":
        params = ref_recsys.xdeepfm_init(key, cfg)
    else:
        params = {"egnn": ref_gnn.egnn_init, "gin-tu": ref_gnn.gin_init,
                  "graphsage-reddit": ref_gnn.sage_init,
                  "graphcast": ref_gnn.graphcast_init}[arch](key, cfg)

    def ints(shape_, high, low=0):
        return rng.integers(low, high, size=shape_).astype(np.int32)

    def normal(shape_):
        return rng.standard_normal(shape_).astype(np.float32)

    args = [params]
    if kind == "train":
        args.append(ref_init_opt(params, ref_steps.OPT_CFG))
        batch = {}
        for name, sds in cell.args[2].items():
            shp = sds.shape
            if name in ("tokens", "labels") and family == "lm":
                batch[name] = ints(shp, cfg.vocab)
            elif name == "ids":
                batch[name] = ints(shp, cfg.vocab_per_field)
            elif name == "labels" and family == "recsys":
                batch[name] = ints(shp, 2).astype(np.float32)
            elif name in ("src", "dst"):
                batch[name] = ints(shp, meta["n"])
            elif name in ("e_src", "e_dst"):
                batch[name] = ints(shp, meta["n"])
            elif name == "w":
                batch[name] = rng.random(shp).astype(np.float32)
            elif name == "graph_ids":
                batch[name] = (np.arange(meta["n"]) * meta["n_graphs"]
                               // meta["n"]).astype(np.int32)
            elif name == "labels" and sds.dtype == jnp.int32:
                n_classes = cfg.d_out
                batch[name] = ints(shp, n_classes, low=-1 if meta.get(
                    "mp_exchange") else 0)
            else:
                batch[name] = normal(shp)
        args.append(batch)
    elif kind == "prefill":
        args.append(ints(cell.args[1].shape, cfg.vocab))
    elif kind == "decode":
        args.append(ints(cell.args[1].shape, cfg.vocab))

        def fill(sds):
            if sds.dtype == jnp.int8:
                return ints(sds.shape, 128, low=-127).astype(np.int8)
            if sds.shape[-1] == 1:                   # int8 scales
                return (rng.random(sds.shape) * 0.05 + 0.01).astype(
                    np.float32)
            return np.asarray(jnp.asarray(normal(sds.shape), sds.dtype))

        args.append(jax.tree.map(fill, cell.args[2]))
        args.append(np.int32(11))                # of 16 positions
    elif kind == "serve":
        args.append(ints(cell.args[1].shape, cfg.vocab_per_field))
    else:
        args.append(ints(cell.args[1].shape, cfg.vocab_per_field))
        args.append(ints(cell.args[2].shape, cfg.vocab_per_field))
    return args


def to_port(args, arch):
    """The reference's numpy arguments as the port's on the CPU."""
    family = ARCH_FAMILY[arch]
    conv = {"lm": tf.params_from_arrays, "recsys": recsys.params_from_arrays,
            "gnn": gnn.params_from_arrays}[family]
    np_tree = jax.tree.map(np.asarray, args[0])
    out = [conv(np_tree, device="cpu")]
    for a in args[1:]:
        if hasattr(a, "mu"):
            out.append(opt_state_from_arrays(
                np.asarray(a.step), jax.tree.map(np.asarray, a.mu),
                jax.tree.map(np.asarray, a.nu), device="cpu", convert=conv))
        elif isinstance(a, dict):
            out.append({k: (tensor_from_array(v, "cpu") if not isinstance(
                v, dict) else {kk: tensor_from_array(vv, "cpu")
                               for kk, vv in v.items()})
                        for k, v in a.items()})
        else:
            out.append(tensor_from_array(a, "cpu"))
    return out, conv


def assert_close(got: torch.Tensor, want, tol=1e-5, what=""):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               rtol=tol, atol=tol, err_msg=what)


def assert_cache(got: dict, want: dict):
    for name, w in want.items():
        if isinstance(w, dict):
            assert_cache(got[name], w)
            continue
        g = got[name].detach()
        w = np.asarray(w)
        if w.dtype == np.int8:
            assert np.abs(g.numpy().astype(np.int32)
                          - w.astype(np.int32)).max() <= 1, name
        elif w.dtype == np.float32:
            assert_close(g, w, what=name)
        else:                                    # bf16: one rounding
            wf = np.asarray(jnp.asarray(w, jnp.float32))
            np.testing.assert_allclose(g.float().numpy(), wf,
                                       rtol=2 ** -7, atol=1e-6,
                                       err_msg=name)


@pytest.mark.parametrize("arch,case", STEP_CASES,
                         ids=[f"{a}-{c}" for a, c in STEP_CASES])
def test_step_matches_reference(arch, case, monkeypatch):
    rcell, pcell = build_pair(arch, case, monkeypatch)
    assert pcell.name == rcell.name
    rng = np.random.default_rng(7)
    args = ref_inputs(rcell, arch, rng)
    want = jax.jit(rcell.fn)(*args)
    got_args, conv = to_port(args, arch)
    got = pcell.fn(*got_args)
    kind = pcell.meta["kind"]
    if kind == "train":
        assert_close(got[2], want[2], what="loss")
        wp = conv(jax.tree.map(np.asarray, want[0]), device="cpu")
        for g, w in zip(tree_leaves(got[0]), tree_leaves(wp)):
            assert_close(g, w.numpy(), what="params")
        wm = tree_leaves(conv(jax.tree.map(np.asarray, want[1].mu),
                              device="cpu"))
        scale = math.sqrt(sum(float((w.double() ** 2).sum()) for w in wm))
        for g, w in zip(tree_leaves(got[1].mu), wm):
            assert float((g.double() - w.double()).norm()) <= 1e-4 * scale
        assert int(got[1].step) == int(want[1].step) == 1
    elif kind in ("prefill", "decode"):
        assert_close(got[0], want[0], what="logits")
        assert_cache(got[1], jax.tree.map(np.asarray, want[1]))
    else:
        assert_close(got, want, what=kind)
