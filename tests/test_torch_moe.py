"""The port's MoE family against the JAX package, on the same weights.

``models/moe.py`` (push and pull dispatch, capacity drops, aux losses,
shared experts), expert parallelism (``moe_apply_ep`` over a
``ShardMesh`` with a "model" axis, installed with
``dist.sharding.set_activation_mesh``) and the MoE LMs
(``models/transformer.py`` with ``cfg.moe``). The reference's parameters
are carried across as numpy arrays; inputs are numpy draws. The routers
see random float32 logits, so no two experts tie for a token's top k
(``torch.topk`` may order ties otherwise than ``jax.lax.top_k``).
``moe_apply_ep`` runs the reference once per module in a fresh
interpreter with XLA faking 8 host devices, on meshes ``(1, P)`` over
("data", "model") (tokens replicated, as the port replicates them) with a
capacity that drops tokens, and on ``(2, 4)`` with one that drops none.

Tolerances: float32 rtol = atol = 1e-5 (sums in other orders);
gradients within 1e-5 of each leaf's largest |entry|; the bf16 combine
within 2^-6 of the largest |output| (the P partial outputs are rounded
to bf16 and summed in bf16, in another order than XLA's all-reduce).
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

from repro.configs import archs as ref_archs
from repro.models import moe as ref_moe
from repro.models import transformer as ref_tf
from repro_torch.configs import archs
from repro_torch.dist.overlap import value_and_grad
from repro_torch.dist.sharding import (BATCH, batch_axes,
                                       get_activation_mesh, hint,
                                       set_activation_mesh)
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.models.common import tree_from_arrays, tree_leaves
from repro_torch.shard import make_shard_mesh

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
KEY = jax.random.PRNGKey(0)
MOE_LMS = ("moonshot-v1-16b-a3b", "deepseek-moe-16b")
CFG = dict(d_model=16, d_ff_expert=8, n_experts=8, top_k=2, n_shared=1,
           dispatch="pull")
REF_LM_GRAD = jax.jit(jax.value_and_grad(ref_tf.lm_loss), static_argnums=1)


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def close(got: torch.Tensor, want, tol: float = 1e-5) -> None:
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def scaled_close(got: torch.Tensor, want, tol: float, what: str = "") -> None:
    """Every entry within ``tol`` times the largest |entry| of ``want``."""
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy()
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    gap = float(np.abs(got - want).max(initial=0.0))
    assert gap <= tol * scale, f"{what}: {gap} > {tol} * {scale}"


def pair(**kw):
    """(ref cfg, cfg, ref params, port params)."""
    ref_cfg = ref_moe.MoEConfig(**(CFG | kw))
    cfg = moe.MoEConfig(**(CFG | kw))
    ref_p = ref_moe.moe_init(KEY, ref_cfg)
    return ref_cfg, cfg, ref_p, tree_from_arrays(to_numpy(ref_p), CPU)


def tokens(B: int = 2, T: int = 12, D: int = 16, seed: int = 1):
    return np.random.default_rng(seed).normal(size=(B, T, D)).astype(
        np.float32)


@pytest.mark.parametrize("n_shared", (0, 1))
@pytest.mark.parametrize("dispatch", ("push", "pull"))
def test_moe_apply_matches_reference(dispatch, n_shared):
    ref_cfg, cfg, ref_p, p = pair(dispatch=dispatch, n_shared=n_shared)
    x = tokens()
    got = moe.moe_apply(p, cfg, t(x))
    assert got.shape == x.shape and got.dtype == torch.float32
    close(got, ref_moe.moe_apply(ref_p, ref_cfg, jnp.asarray(x)))


@pytest.mark.parametrize("capacity", (0.25, 1.0, 8.0))
def test_push_equals_pull(capacity):
    _, cfg, _, p = pair(capacity_factor=capacity)
    x = t(tokens(seed=2))
    push = moe.moe_apply(p, dataclasses.replace(cfg, dispatch="push"), x)
    pull = moe.moe_apply(p, cfg, x)
    torch.testing.assert_close(push, pull, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dispatch", ("push", "pull"))
def test_capacity_drops_and_aux_match_reference(dispatch):
    ref_cfg, cfg, ref_p, p = pair(dispatch=dispatch, capacity_factor=0.25,
                                  n_shared=0)
    x = tokens(1, 32)
    got, aux = moe.moe_apply(p, cfg, t(x), return_aux=True)
    want, ref_aux = ref_moe.moe_apply(ref_p, ref_cfg, jnp.asarray(x),
                                      return_aux=True)
    close(got, want)
    assert float(aux["dropped_frac"]) > 0.0
    for k in ("lb_loss", "dropped_frac"):
        np.testing.assert_allclose(float(aux[k]), float(ref_aux[k]),
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("dispatch", ("push", "pull"))
def test_moe_grads_match_reference(dispatch):
    ref_cfg, cfg, ref_p, p = pair(dispatch=dispatch, capacity_factor=1.0)
    x = tokens(seed=3)

    def ref_loss(params, xx):
        y, aux = ref_moe.moe_apply(params, ref_cfg, xx, return_aux=True)
        return jnp.mean(y ** 2) + aux["lb_loss"]

    want_loss, (want_p, want_x) = jax.value_and_grad(ref_loss, (0, 1))(
        ref_p, jnp.asarray(x))
    xt = t(x).requires_grad_()
    leaves = tree_leaves(p)
    for leaf in leaves:
        leaf.requires_grad_()
    y, aux = moe.moe_apply(p, cfg, xt, return_aux=True)
    loss = (y ** 2).mean() + aux["lb_loss"]
    grads = torch.autograd.grad(loss, leaves + [xt])
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    want = tree_leaves(tree_from_arrays(to_numpy(want_p), CPU))
    for i, (a, b) in enumerate(zip(grads, want + [t(want_x)])):
        scaled_close(a, b.numpy(), 1e-5, f"leaf {i}")


def test_moe_init_stacks_experts():
    _, cfg, ref_p, p = pair(n_shared=2)
    got = moe.moe_init(torch.Generator().manual_seed(0), moe.MoEConfig(
        **(CFG | {"n_shared": 2})), torch.bfloat16)
    assert [(tuple(a.shape)) for a in tree_leaves(got)] == [
        tuple(b.shape) for b in tree_leaves(p)]
    assert got["router"]["w"].dtype == torch.float32
    assert got["experts"]["wi"]["w"].dtype == torch.bfloat16
    assert got["experts"]["wi"]["w"].shape == (8, 16, 8)
    assert got["shared"]["wo"]["w"].shape == (2, 8, 16)


# -- the activation mesh and expert parallelism -------------------------------
def test_shard_mesh_names_its_axis():
    m = make_shard_mesh(4, axis="model", devices=[CPU] * 4)
    assert m.shape == {"model": 4} and m.axis_names == ("model",)
    d = make_shard_mesh(2, devices=[CPU] * 2)
    assert d.shape == {"data": 2, "model": 1}
    assert d.axis_names == ("data", "model") and batch_axes(d) == ("data",)
    assert batch_axes(m) == ()


def test_hint_returns_its_input():
    x = torch.ones(2, 3)
    assert hint(x, BATCH, None) is x
    set_activation_mesh(make_shard_mesh(2, axis="model", devices=[CPU] * 2))
    try:
        assert hint(x, BATCH, "model") is x
    finally:
        set_activation_mesh(None)
    assert get_activation_mesh() is None


def test_moe_apply_ep_falls_back_where_the_reference_does():
    _, cfg, _, p = pair()
    x = t(tokens())
    want = moe.moe_apply(p, cfg, x)
    assert torch.equal(moe.moe_apply_ep(p, cfg, x), want)     # no mesh
    for mesh in (make_shard_mesh(3, axis="model", devices=[CPU] * 3),
                 make_shard_mesh(2, axis="data", devices=[CPU] * 2)):
        set_activation_mesh(mesh)
        try:
            got = moe.moe_apply_ep(p, cfg, x)
        finally:
            set_activation_mesh(None)
        # 8 experts over 3 shards: moe_apply; over a "data" mesh the
        # "model" axis has one shard, which holds every expert
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


EP_CASES = [(mesh, P, mode, comb)
            for mesh, P in (((1, 2), 2), ((1, 4), 4), ((2, 4), 4))
            for mode in ("psum", "a2a") for comb in ("f32", "bf16")]
# a capacity that drops tokens where tokens are replicated, as in the
# port; one that drops none on the data-sharded mesh
EP_CAPACITY = {(1, 2): 1.0, (1, 4): 1.0, (2, 4): 8.0}

EP_REFERENCE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses
import jax, numpy as np
from jax.sharding import Mesh
import repro
from repro.models import moe
from repro.dist.sharding import set_activation_mesh

CFG, CASES, CAPACITY = json.loads(sys.argv[2])
x = np.load(sys.argv[3])
out = {}
for i, (shape, P, mode, comb) in enumerate(CASES):
    cfg = moe.MoEConfig(**CFG, capacity_factor=CAPACITY[str(shape)],
                        ep_mode=mode, combine_dtype=comb)
    params = moe.moe_init(jax.random.PRNGKey(0), cfg)
    mesh = Mesh(np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape),
                ("data", "model"))
    # a fresh jit per case: the mesh is read while tracing
    set_activation_mesh(mesh)
    out[f"ep/{i}"] = np.asarray(jax.jit(
        lambda p, xx: moe.moe_apply_ep(p, cfg, xx))(params, x))
    set_activation_mesh(None)
    out[f"plain/{i}"] = np.asarray(jax.jit(
        lambda p, xx: moe.moe_apply(p, cfg, xx))(params, x))
np.savez(sys.argv[1], **out)
print("reference ok")
"""


@pytest.fixture(scope="module")
def ep_reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_ep")
    x = tokens(4, 8, seed=4)
    np.save(tmp / "x.npy", x)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    args = [CFG, [[list(m), P, mode, comb] for m, P, mode, comb in EP_CASES],
            {str(list(k)): v for k, v in EP_CAPACITY.items()}]
    r = subprocess.run([sys.executable, "-c", EP_REFERENCE,
                        str(tmp / "out.npz"), json.dumps(args),
                        str(tmp / "x.npy")], capture_output=True, text=True,
                       timeout=600, env=env, cwd=str(ROOT))
    assert r.returncode == 0, r.stdout + r.stderr
    return x, dict(np.load(tmp / "out.npz"))


@pytest.mark.parametrize("case", range(len(EP_CASES)),
                         ids=lambda i: "mesh{}-P{}-{}-{}".format(*EP_CASES[i]))
def test_moe_apply_ep_matches_reference(ep_reference, case):
    shape, P, mode, comb = EP_CASES[case]
    x, ref = ep_reference
    kw = {"capacity_factor": EP_CAPACITY[shape], "ep_mode": mode,
          "combine_dtype": comb}
    _, cfg, _, p = pair(**kw)
    set_activation_mesh(make_shard_mesh(P, axis="model", devices=[CPU] * P))
    try:
        got = moe.moe_apply_ep(p, cfg, t(x))
    finally:
        set_activation_mesh(None)
    assert got.dtype == torch.float32
    if comb == "bf16":
        scaled_close(got, ref[f"ep/{case}"], 2 ** -6)
    else:
        close(got, ref[f"ep/{case}"])
    if EP_CAPACITY[shape] == 8.0:     # nothing dropped: equals moe_apply
        close(got, ref[f"plain/{case}"], 1e-5 if comb == "f32" else 2e-2)


def test_moe_apply_ep_gradients_equal_moe_apply():
    _, cfg, _, p = pair(capacity_factor=8.0)
    x = t(tokens(4, 8, seed=5))
    leaves = tree_leaves(p)
    for leaf in leaves:
        leaf.requires_grad_()
    want = torch.autograd.grad(moe.moe_apply(p, cfg, x).square().mean(),
                               leaves)
    for mode in ("psum", "a2a"):
        set_activation_mesh(make_shard_mesh(4, axis="model",
                                            devices=[CPU] * 4))
        try:
            y = moe.moe_apply_ep(p, dataclasses.replace(cfg, ep_mode=mode),
                                 x)
        finally:
            set_activation_mesh(None)
        got = torch.autograd.grad(y.square().mean(), leaves)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


# -- the MoE LMs ------------------------------------------------------------
def lm_case(arch: str, seed: int = 0):
    kw = {"attn_impl": "naive", "remat": False}
    ref_cfg = dataclasses.replace(ref_archs.smoke_config(arch), **kw)
    cfg = dataclasses.replace(archs.smoke_config(arch), **kw)
    ref_p = to_numpy(ref_tf.init_params(jax.random.PRNGKey(seed), ref_cfg))
    return ref_cfg, cfg, ref_p


@pytest.mark.parametrize("arch", MOE_LMS)
def test_moe_lm_loss_and_grads_match_reference(arch):
    ref_cfg, cfg, ref_p = lm_case(arch)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab, size=(2, 21)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[1, 4] = -1
    want_loss, want_g = REF_LM_GRAD(jax.tree.map(jnp.asarray, ref_p),
                                    ref_cfg, jnp.asarray(toks[:, :-1]),
                                    jnp.asarray(labels))
    params = tf.params_from_arrays(ref_p, CPU)
    loss, grads = value_and_grad(
        lambda p, b: tf.lm_loss(p, cfg, b[0], b[1]), params,
        (t(toks[:, :-1]), t(labels)))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    got, want = tree_leaves(grads), tree_leaves(
        tf.params_from_arrays(to_numpy(want_g), CPU))
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        scaled_close(a, b.numpy(), 1e-5, f"{arch} leaf {i}")


@pytest.mark.parametrize("arch", MOE_LMS)
def test_moe_lm_prefill_and_decode_match_reference(arch):
    ref_cfg, cfg, ref_p = lm_case(arch, seed=1)
    params = tf.params_from_arrays(ref_p, CPU)
    toks = np.random.default_rng(7).integers(0, cfg.vocab, (2, 9)).astype(
        np.int32)
    want, ref_cache = jax.jit(ref_tf.prefill, static_argnums=(1, 3))(
        jax.tree.map(jnp.asarray, ref_p), ref_cfg, jnp.asarray(toks[:, :8]),
        "f32")
    got, cache = tf.prefill(params, cfg, t(toks[:, :8]), "f32")
    close(got, want, 1e-4)
    ref_cache = jax.tree.map(lambda a: jnp.pad(
        a, ((0, 0), (0, 0), (0, 1), (0, 0), (0, 0))), ref_cache)
    want, _ = jax.jit(ref_tf.decode_step, static_argnums=1)(
        jax.tree.map(jnp.asarray, ref_p), ref_cfg, jnp.asarray(toks[:, 8:]),
        ref_cache, jnp.int32(8))
    got, _ = tf.decode_step(params, cfg, t(toks[:, 8:]),
                            tf.pad_kv_cache(cache, 9), 8)
    close(got, want, 1e-4)


def test_params_from_arrays_keeps_experts_stacked():
    ref_cfg, cfg, ref_p = lm_case("deepseek-moe-16b")
    params = tf.params_from_arrays(ref_p, CPU)
    L, E = cfg.n_layers, cfg.moe.n_experts
    assert len(params["layers"]) == L
    for i, lp in enumerate(params["layers"]):
        assert "ffn" not in lp
        w = lp["moe"]["experts"]["wi"]["w"]
        assert w.shape == (E, cfg.d_model, cfg.moe.d_ff_expert)
        np.testing.assert_array_equal(
            w.numpy(), ref_p["layers"]["moe"]["experts"]["wi"]["w"][i])
        assert lp["moe"]["shared"]["wo"]["w"].shape == (
            cfg.moe.n_shared, cfg.moe.d_ff_expert, cfg.d_model)
    mask = tf.decay_mask(params)
    assert all(tree_leaves(mask["layers"]))
    own = tf.init_params(cfg, seed=0, device=CPU)
    assert [tuple(a.shape) for a in tree_leaves(own)] == [
        tuple(a.shape) for a in tree_leaves(params)]
