"""The port's xDeepFM, embedding bag and configs against the JAX package.

The reference's xDeepFM parameters (``repro.models.recsys.xdeepfm_init``,
seeded with ``jax.random.PRNGKey``) are carried across as numpy arrays
by ``recsys.params_from_arrays``; ids and payloads are numpy draws. On
the CPU, where ``cin_layer`` runs its plain version.

Tolerances: rtol = atol = 1e-5 (f32 sums in other orders). Configs and
shape tables must be equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import archs as ref_archs
from repro.configs import shapes as ref_shapes
from repro.models import recsys as ref_recsys
from repro.sparse import embedding as ref_embedding
from repro_torch.configs import archs, shapes
from repro_torch.models import recsys
from repro_torch.sparse import embedding_bag, one_hot_matmul_lookup

# compiled once (eager JAX dispatches op by op)
REF_XDEEPFM = jax.jit(ref_recsys.xdeepfm_apply, static_argnums=1)
CPU = "cpu"


def close(got, want, tol: float = 1e-5) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("combiner", ["sum", "mean", "max"])
def test_embedding_bag_matches_reference(combiner):
    rng = np.random.default_rng(5)
    table = rng.normal(size=(20, 6)).astype(np.float32)
    ids = rng.integers(0, 24, size=40).astype(np.int32)  # some >= V
    bags = rng.integers(0, 9, size=40).astype(np.int32)  # bag 8 may be empty
    weights = rng.uniform(0.5, 2.0, size=40).astype(np.float32)
    for w in (None, weights):
        want = ref_embedding.embedding_bag(
            jnp.asarray(table), jnp.asarray(ids), jnp.asarray(bags), 10,
            None if w is None else jnp.asarray(w), combiner)
        got = embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                            torch.from_numpy(bags), 10,
                            None if w is None else torch.from_numpy(w),
                            combiner)
        close(got, want, 1e-5)
    close(one_hot_matmul_lookup(torch.from_numpy(table),
                                torch.from_numpy(ids)),
          ref_embedding.one_hot_matmul_lookup(jnp.asarray(table),
                                              jnp.asarray(ids)), 1e-5)


def test_xdeepfm_matches_reference():
    ref_cfg = ref_archs.smoke_config("xdeepfm")
    cfg = archs.smoke_config("xdeepfm")
    ref_p = ref_recsys.xdeepfm_init(jax.random.PRNGKey(6), ref_cfg)
    p = recsys.params_from_arrays(jax.tree.map(np.asarray, ref_p), CPU)
    rng = np.random.default_rng(6)
    ids = rng.integers(0, cfg.vocab_per_field, (37, cfg.n_fields),
                       dtype=np.int32)
    close(recsys.xdeepfm_apply(p, cfg, torch.from_numpy(ids)),
          REF_XDEEPFM(ref_p, ref_cfg, jnp.asarray(ids)), 1e-5)
    x0 = rng.normal(size=(37, cfg.n_fields, cfg.embed_dim)).astype(
        np.float32)
    close(recsys.cin_apply(p["cin"], torch.from_numpy(x0)),
          ref_recsys.cin_apply(ref_p["cin"], jnp.asarray(x0)), 1e-5)
    fu = cfg.n_fields // 2
    user, cand = ids[:1, :fu], ids[:, fu:]
    close(recsys.retrieval_score(p, cfg, torch.from_numpy(user),
                                 torch.from_numpy(cand)),
          ref_recsys.retrieval_score(ref_p, ref_cfg, jnp.asarray(user),
                                     jnp.asarray(cand)), 1e-5)


@pytest.mark.parametrize("arch", archs.ALL_ARCHS)
def test_configs_match_reference(arch):
    assert archs.ARCH_FAMILY == ref_archs.ARCH_FAMILY
    assert archs.PORTED_ARCHS == tuple(archs.ALL_ARCHS)
    for make, ref_make in ((archs.full_config, ref_archs.full_config),
                           (archs.smoke_config, ref_archs.smoke_config)):
        got, want = make(arch), ref_make(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        if archs.ARCH_FAMILY[arch] == "lm":
            assert got.hd == want.hd
            np.testing.assert_array_equal(
                np.asarray(got.window_array(64)),
                np.asarray(want.window_array(64)))
    family = archs.ARCH_FAMILY[arch]
    got = {k: (s.name, s.kind, s.params)
           for k, s in shapes.shape_table(family).items()}
    want = {k: (s.name, s.kind, s.params)
            for k, s in ref_shapes.shape_table(family).items()}
    assert got == want


def test_common_blocks_match_reference():
    from repro.models import common as ref_common
    from repro_torch.models import common
    rng = np.random.default_rng(7)
    x = rng.normal(size=(3, 5, 16)).astype(np.float32)
    scale = rng.normal(size=16).astype(np.float32) * 0.1
    bias = rng.normal(size=16).astype(np.float32)
    tx, ts, tb = (torch.from_numpy(a) for a in (x, scale, bias))
    close(common.rms_norm(tx, ts), ref_common.rms_norm(x, scale))
    close(common.layer_norm(tx, ts, tb),
          ref_common.layer_norm(x, scale, bias))
    close(common.gelu(tx), ref_common.gelu(x))
    close(common.silu(tx), ref_common.silu(x))
    close(common.softcap(tx, 3.0), ref_common.softcap(x, 3.0))
    ref_mlp = ref_common.mlp_init(jax.random.PRNGKey(8), [16, 12, 4])
    mlp = common.tree_from_arrays(jax.tree.map(np.asarray, ref_mlp), CPU)
    close(common.mlp_apply(mlp, tx, final_act=True),
          ref_common.mlp_apply(ref_mlp, x, final_act=True))
    assert common.param_count(mlp) == ref_common.param_count(ref_mlp)
    assert common.tree_size_bytes(mlp) == ref_common.tree_size_bytes(
        ref_mlp)
    # the port's initializers draw the reference's shapes and dtypes
    got = common.mlp_init(torch.Generator().manual_seed(0), [16, 12, 4])
    assert [tuple(t.shape) for t in common.tree_leaves(got)] == [
        tuple(a.shape) for a in jax.tree.leaves(ref_mlp)]
