"""The port's training slice against the JAX package, on the same numbers.

Losses, the optimizer, ``lm_loss`` and xDeepFM gradients, microbatched
gradients, the training loop (with error feedback), checkpoints, the
ring all-reduce, the data streams and the launcher, each run by both
packages on numpy inputs drawn from a seed (the reference's parameters
carried across with ``params_from_arrays``, its optimizer state with
``opt_state_from_arrays``). Everything runs on the CPU, where the
flash-attention and CIN wrappers run their plain versions and, under
autograd, their ``autograd.Function``s: the forward's plain version and
the backward the card runs too (the q-chunked attention recompute; the
CIN backward's two layers on permuted weights and its chunked GEMM).

Tolerances (f32):
  * losses, the learning rate: rtol 1e-6;
  * gradients: each leaf within 1e-5 of its largest entry (sums in
    other orders over the batch);
  * ``apply_updates`` fed the same gradients and state: f32 leaves rtol
    1e-6 (atol 1e-9), bf16 leaves within one bf16 step (2^-8 relative);
  * the loop under SGD: losses rtol 1e-5, parameters within 1e-5 of each
    leaf's largest entry; under AdamW the losses only, rtol 1e-4 (Adam
    turns a gradient's float noise into a ±lr step, so its parameters
    are no fair target between two frameworks);
  * the error-feedback carry: within 1e-3 of each leaf's largest entry
    (it is the residue of the gradient, whose float noise is a larger
    share of the residue);
  * the ring all-reduce: exact (integer-valued floats).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import archs as ref_archs
from repro.data import pipeline as ref_data
from repro.dist import (CompressionConfig as RefCompression,
                        microbatch_grads as ref_microbatch_grads)
from repro.models import recsys as ref_recsys
from repro.models import transformer as ref_tf
from repro.train import (LoopConfig as RefLoopConfig, OptConfig as RefOpt,
                         TrainLoop as RefTrainLoop, apply_updates as ref_apply,
                         init_opt as ref_init_opt, losses as ref_losses)
from repro.train.optimizer import warmup_cosine as ref_warmup_cosine
from repro_torch.configs import archs
from repro_torch.data import pipeline as data
from repro_torch.dist.compression import CompressionConfig
from repro_torch.dist.overlap import (microbatch_grads, ring_allreduce_psum,
                                      value_and_grad)
from repro_torch.kernels import cin as cin_mod
from repro_torch.kernels.cin import cin_layer, cin_layer_plain
from repro_torch.kernels.flash_attention import (GLOBAL_WINDOW,
                                                 FlashAttention,
                                                 flash_attention,
                                                 flash_attention_plain_gqa)
from repro_torch.launch import train as launch_train
from repro_torch.models import recsys
from repro_torch.models import transformer as tf
from repro_torch.models.common import tree_from_arrays, tree_leaves
from repro_torch.train import (LoopConfig, OptConfig, TrainLoop,
                               apply_updates, checkpoint as ckpt, init_opt,
                               losses, opt_state_from_arrays, warmup_cosine)
from repro_torch.train.loop import Watchdog

CPU = "cpu"
LMS = ("llama3.2-1b", "qwen1.5-32b", "gemma2-9b")
REF_LM_GRAD = jax.jit(jax.value_and_grad(ref_tf.lm_loss), static_argnums=1)


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def leaf_close(got: torch.Tensor, want, tol: float, what: str = "") -> None:
    """Every entry within ``tol`` times the leaf's largest |entry|."""
    want = np.asarray(want, np.float64)
    got = got.detach().double().numpy()
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    gap = float(np.abs(got - want).max(initial=0.0))
    assert gap <= tol * scale, f"{what}: {gap} > {tol} * {scale}"


def trees_close(got, want, tol: float) -> None:
    """Port tree against the reference's carried into the port's layout
    (leaves in the same order); a bf16 leaf within one bf16 step
    (2^-8) of its largest entry at least."""
    gl, wl = tree_leaves(got), tree_leaves(want)
    assert len(gl) == len(wl)
    for i, (g, w) in enumerate(zip(gl, wl)):
        leaf_tol = max(tol, 2 ** -8) if w.dtype == torch.bfloat16 else tol
        leaf_close(g, w.double().numpy(), leaf_tol, f"leaf {i}")


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a))


# -- losses and the schedule ----------------------------------------------
@pytest.mark.parametrize("name", ["bce_with_logits", "mse",
                                  "softmax_xent_dense"])
def test_losses_match_reference(name):
    rng = np.random.default_rng(1)
    if name == "softmax_xent_dense":
        a = rng.normal(size=(12, 7)).astype(np.float32) * 3
        b = rng.integers(0, 7, size=12).astype(np.int32)
    else:
        a = rng.normal(size=(40,)).astype(np.float32) * 4
        b = (rng.random(40) < 0.3).astype(np.float32)
    want = getattr(ref_losses, name)(jnp.asarray(a), jnp.asarray(b))
    got = getattr(losses, name)(t(a), t(b))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_warmup_cosine_matches_reference():
    cfg = OptConfig(lr=3e-3, warmup_steps=5, total_steps=40)
    ref = RefOpt(lr=3e-3, warmup_steps=5, total_steps=40)
    for s in (0, 1, 4, 5, 6, 20, 39, 40, 55):
        want = float(ref_warmup_cosine(ref, jnp.asarray(s, jnp.int32)))
        np.testing.assert_allclose(float(warmup_cosine(cfg, s)), want,
                                   rtol=1e-6, atol=1e-12)


# -- apply_updates ----------------------------------------------------------
def opt_tree(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(8, 6)).astype(jnp.bfloat16),
            "v": rng.normal(size=(6,)).astype(np.float32),
            "m": {"k": rng.normal(size=(4, 5)).astype(np.float32)},
            "layers": [{"b": rng.normal(size=(3,)).astype(np.float32)}]}


def assert_updated(got, want) -> None:
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        w = np.asarray(w)
        if w.dtype == jnp.bfloat16:
            np.testing.assert_allclose(g.float().numpy(), w.astype(
                np.float32), rtol=2 ** -8, atol=1e-30)
        else:
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("clip", [1e3, 0.05], ids=["no_clip", "clipped"])
@pytest.mark.parametrize("kind", ["adamw", "sgd"])
def test_apply_updates_matches_reference(kind, clip):
    kw = dict(kind=kind, lr=1e-2, clip_norm=clip, warmup_steps=2,
              total_steps=6, weight_decay=0.1)
    cfg, ref = OptConfig(**kw), RefOpt(**kw)
    params = opt_tree(0)
    ref_p = jax.tree.map(jnp.asarray, params)
    ref_s = ref_init_opt(ref_p, ref)
    port_p = tree_from_arrays(params, CPU)
    port_s = init_opt(port_p, cfg)
    rng = np.random.default_rng(7)
    for _ in range(3):
        grads = jax.tree.map(
            lambda p: (rng.normal(size=p.shape) * 3).astype(p.dtype), params)
        # one step from the reference's own state, carried across
        carried = opt_state_from_arrays(np.asarray(ref_s.step),
                                        to_numpy(ref_s.mu),
                                        to_numpy(ref_s.nu), CPU)
        one_p = tree_from_arrays(to_numpy(ref_p), CPU)
        apply_updates(one_p, tree_from_arrays(grads, CPU), carried, cfg)
        ref_p, ref_s = ref_apply(ref_p, jax.tree.map(jnp.asarray, grads),
                                 ref_s, ref)
        assert_updated(one_p, ref_p)
        assert_updated(carried.mu, ref_s.mu)
        # and the port's own state carried over every step
        apply_updates(port_p, tree_from_arrays(grads, CPU), port_s, cfg)
        assert int(port_s.step) == int(ref_s.step)
    trees_close(port_p, tree_from_arrays(to_numpy(ref_p), CPU), 1e-5)


def test_apply_updates_writes_in_place():
    p = {"w": torch.ones(3, 2)}
    w, version = p["w"], p["w"]._version
    state = init_opt(p, OptConfig(warmup_steps=0))
    out, state2 = apply_updates(p, {"w": torch.ones(3, 2)}, state,
                                OptConfig(warmup_steps=0))
    assert out["w"] is w and w._version > version and state2 is state
    assert not torch.equal(w, torch.ones(3, 2))


def test_apply_updates_on_lm_tree_decays_like_reference():
    """On the stacked reference tree AdamW's ndim >= 2 rule decays each
    layer's norm scales; ``decay_mask`` says so for the port's list."""
    ref_cfg = ref_archs.smoke_config("qwen1.5-32b")
    ref_p = to_numpy(ref_tf.init_params(jax.random.PRNGKey(3), ref_cfg))
    rng = np.random.default_rng(4)
    ref_p = jax.tree.map(lambda a: (a + rng.normal(size=a.shape) * 0.1
                                    ).astype(a.dtype), ref_p)
    grads = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(a.dtype),
                         ref_p)
    kw = dict(lr=1e-2, warmup_steps=0, total_steps=4, weight_decay=0.5)
    ref_state = ref_init_opt(ref_p, RefOpt(**kw))
    want, _ = ref_apply(jax.tree.map(jnp.asarray, ref_p),
                        jax.tree.map(jnp.asarray, grads), ref_state,
                        RefOpt(**kw))
    port_p = tf.params_from_arrays(ref_p, CPU)
    state = opt_state_from_arrays(np.asarray(ref_state.step),
                                  to_numpy(ref_state.mu),
                                  to_numpy(ref_state.nu), CPU,
                                  convert=tf.params_from_arrays)
    apply_updates(port_p, tf.params_from_arrays(grads, CPU), state,
                  OptConfig(**kw), decay=tf.decay_mask(port_p))
    trees_close(port_p, tf.params_from_arrays(to_numpy(want), CPU), 1e-6)


# -- gradients --------------------------------------------------------------
def lm_case(arch: str, impl: str, seed: int = 0):
    kw = {"attn_impl": impl, "q_chunk": 8, "kv_chunk": 8}
    ref_cfg = dataclasses.replace(ref_archs.smoke_config(arch), **kw)
    cfg = dataclasses.replace(archs.smoke_config(arch), **kw)
    ref_p = to_numpy(ref_tf.init_params(jax.random.PRNGKey(seed), ref_cfg))
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, size=(2, 41)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, 3] = -1                     # an ignored position
    return ref_cfg, cfg, ref_p, toks[:, :-1], labels


@pytest.mark.parametrize("impl", ["naive", "blockwise"])
@pytest.mark.parametrize("arch", LMS)
def test_lm_loss_and_grads_match_reference(arch, impl):
    """Remat on (the smoke configs' default), 40 tokens: two loss chunks
    of 32 and, blockwise, five query blocks of 8 in the Function's
    backward."""
    ref_cfg, cfg, ref_p, toks, labels = lm_case(arch, impl)
    assert cfg.remat
    want_loss, want_g = REF_LM_GRAD(jax.tree.map(jnp.asarray, ref_p),
                                    ref_cfg, jnp.asarray(toks),
                                    jnp.asarray(labels))
    params = tf.params_from_arrays(ref_p, CPU)
    loss, grads = value_and_grad(
        lambda p, b: tf.lm_loss(p, cfg, b[0], b[1]), params,
        (t(toks), t(labels)))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    trees_close(grads, tf.params_from_arrays(to_numpy(want_g), CPU), 1e-5)


def test_lm_loss_blockwise_goes_through_the_function(monkeypatch):
    _, cfg, ref_p, toks, labels = lm_case("gemma2-9b", "blockwise")
    params = tf.params_from_arrays(ref_p, CPU)
    seen = []
    real = FlashAttention.apply

    def spy(*a):
        seen.append(a[3:])
        return real(*a)

    monkeypatch.setattr(FlashAttention, "apply", spy)
    value_and_grad(lambda p, b: tf.lm_loss(p, cfg, b[0], b[1]), params,
                   (t(toks), t(labels)))
    # each of 4 layers once, and once more in its remat recompute
    assert len(seen) == 2 * cfg.n_layers
    assert {s[0] for s in seen} == {cfg.local_window, GLOBAL_WINDOW}
    assert all(s[1] == cfg.attn_softcap and s[3] == cfg.q_chunk
               for s in seen)


def test_xdeepfm_loss_and_grads_match_reference():
    ref_cfg = ref_archs.smoke_config("xdeepfm")
    cfg = archs.smoke_config("xdeepfm")
    ref_p = to_numpy(ref_recsys.xdeepfm_init(jax.random.PRNGKey(2),
                                             ref_cfg))
    rng = np.random.default_rng(2)
    ids = rng.integers(0, cfg.vocab_per_field, size=(24, cfg.n_fields)
                       ).astype(np.int32)
    y = (rng.random(24) < 0.4).astype(np.float32)

    def ref_loss(p, ids, y):
        return ref_losses.bce_with_logits(
            ref_recsys.xdeepfm_apply(p, ref_cfg, ids), y)

    want_loss, want_g = jax.value_and_grad(ref_loss)(
        jax.tree.map(jnp.asarray, ref_p), jnp.asarray(ids), jnp.asarray(y))
    params = recsys.params_from_arrays(ref_p, CPU)
    loss, grads = value_and_grad(
        lambda p, b: losses.bce_with_logits(
            recsys.xdeepfm_apply(p, cfg, b[0]), b[1]), params,
        (t(ids), t(y)))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    trees_close(grads, recsys.params_from_arrays(to_numpy(want_g), CPU),
                1e-5)


@pytest.mark.parametrize("T,H,Hk,d,window,cap,chunk", [
    (37, 4, 2, 16, GLOBAL_WINDOW, 0.0, 8),
    (37, 4, 1, 8, 5, 50.0, 8),
    (20, 2, 2, 8, 7, 3.0, 64),
    (9, 8, 2, 4, 1, 0.0, 3)])
def test_flash_function_grads_match_plain_autograd(T, H, Hk, d, window,
                                                   cap, chunk):
    """The Function's backward against autograd through the plain
    version: f32, each leaf within 1e-5 of its largest entry."""
    gen = torch.Generator().manual_seed(T + H)
    q, k, v = (torch.randn(2, T, h, d, generator=gen).requires_grad_()
               for h in (H, Hk, Hk))
    dout = torch.randn(2, T, H, d, generator=gen)
    out = flash_attention(q, k, v, window, cap, None, chunk)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (q, k, v), dout)
    want = torch.autograd.grad(
        flash_attention_plain_gqa(q, k, v, window, cap), (q, k, v), dout)
    for g, w in zip(got, want):
        leaf_close(g, w.numpy(), 1e-5)


@pytest.mark.parametrize("B,Hp,F,H,D", [(5, 4, 4, 7, 3), (9, 6, 4, 5, 2),
                                        (33, 13, 9, 37, 3)])
def test_cin_function_grads_match_plain_autograd(B, Hp, F, H, D,
                                                 monkeypatch):
    """dxk through the layer on a permuted weight, dx0 and dw through
    their plain versions on the CPU (chunks of at most 300 entries here,
    so that every batch walks several) against autograd through the
    plain version; f32, within 1e-5 of each leaf's largest entry."""
    monkeypatch.setattr(cin_mod, "_PLAIN_CHUNK", 300)
    gen = torch.Generator().manual_seed(B)
    xk = torch.randn(B, Hp, D, generator=gen).requires_grad_()
    x0 = torch.randn(B, F, D, generator=gen).requires_grad_()
    w = torch.randn(H, Hp, F, generator=gen).requires_grad_()
    g = torch.randn(B, H, D, generator=gen)
    out = cin_layer(xk, x0, w)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (xk, x0, w), g)
    want = torch.autograd.grad(
        torch.einsum("hij,bid,bjd->bhd", w, xk, x0), (xk, x0, w), g)
    for a, b in zip(got, want):
        leaf_close(a, b.numpy(), 1e-5)
    # layer 0: xk is x0 itself, both gradients summed
    out0 = cin_layer(x0, x0, w[:, :F].detach())
    g0 = torch.autograd.grad(out0, x0, g)[0]
    w0 = torch.autograd.grad(torch.einsum("hij,bid,bjd->bhd", w[:, :F],
                                          x0, x0), x0, g)[0]
    leaf_close(g0, w0.numpy(), 1e-5)


def test_outputs_carry_grad_only_when_asked():
    q = torch.randn(1, 5, 2, 4)
    xk, w = torch.randn(3, 2, 4), torch.randn(3, 2, 2)
    assert flash_attention(q, q, q).grad_fn is None
    assert cin_layer(xk, xk, w).grad_fn is None
    qg = q.clone().requires_grad_()
    assert flash_attention(qg, q, q).grad_fn is not None
    assert cin_layer(xk, xk, w.clone().requires_grad_()).grad_fn is not None
    with torch.no_grad():
        assert flash_attention(qg, q, q).grad_fn is None
    assert cin_layer_plain(xk, xk, w).grad_fn is None


def test_cin_weight_grad_chunks_bound_the_outer_product(monkeypatch):
    """No chunk of z holds more than ``_PLAIN_CHUNK`` entries: the GEMM
    operands it sees have at most that many."""
    monkeypatch.setattr(cin_mod, "_PLAIN_CHUNK", 500)
    sizes = []
    real = torch.Tensor.addmm_

    def spy(self, a, b, **kw):
        sizes.append(b.numel())
        return real(self, a, b, **kw)

    monkeypatch.setattr(torch.Tensor, "addmm_", spy)
    gen = torch.Generator().manual_seed(0)
    g, xk, x0 = (torch.randn(s, generator=gen)
                 for s in ((50, 6, 4), (50, 5, 4), (50, 3, 4)))
    dw = cin_mod.cin_weight_grad_plain(g, xk, x0)
    assert len(sizes) > 1 and max(sizes) <= 500
    want = torch.einsum("bhd,bid,bjd->hij", g, xk, x0)
    leaf_close(dw, want.numpy(), 1e-5)


# -- microbatches, the ring -------------------------------------------------
def quad_problem():
    rng = np.random.default_rng(0)
    w_true = rng.normal(size=(8, 8)).astype(np.float32)
    xs = rng.normal(size=(64, 8)).astype(np.float32)
    return {"w": np.zeros((8, 8), np.float32)}, {"x": xs, "y": xs @ w_true.T}


def quad_loss(p, b):
    return ((b["x"] @ p["w"].T - b["y"]) ** 2).mean()


def test_microbatch_grads_match_full_batch_and_reference():
    params, batch = quad_problem()
    pt = tree_from_arrays(params, CPU)
    bt = tree_from_arrays(batch, CPU)
    _, g_full = value_and_grad(quad_loss, pt, bt)
    g_micro, loss = microbatch_grads(quad_loss, pt, bt, num_micro=4)
    np.testing.assert_allclose(g_micro["w"].numpy(), g_full["w"].numpy(),
                               atol=1e-5)
    jp = jax.tree.map(jnp.asarray, params)
    jb = jax.tree.map(jnp.asarray, batch)
    want_g, want_loss = ref_microbatch_grads(quad_loss, jp, jb, 4)
    leaf_close(g_micro["w"], want_g["w"], 1e-5)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    with pytest.raises(ValueError, match="not divisible"):
        microbatch_grads(quad_loss, pt, bt, num_micro=5)


@pytest.mark.parametrize("extra", [0, 1], ids=["divides", "ragged"])
@pytest.mark.parametrize("P", range(1, 9))
def test_ring_allreduce_equals_plain_sum(P, extra):
    rng = np.random.default_rng(P)
    n = 3 * P + extra
    xs = [torch.from_numpy(rng.integers(-50, 50, n).astype(np.float32))
          for _ in range(P)]
    want = torch.stack(xs).sum(0)
    out = ring_allreduce_psum(xs, [torch.device(CPU)] * P)
    assert len(out) == P
    for o in out:
        assert torch.equal(o, want)


# -- the loop ---------------------------------------------------------------
def lm_loop_case():
    kw = {"attn_impl": "blockwise", "q_chunk": 8, "kv_chunk": 8}
    ref_cfg = dataclasses.replace(ref_archs.smoke_config("llama3.2-1b"),
                                  **kw)
    cfg = dataclasses.replace(archs.smoke_config("llama3.2-1b"), **kw)
    ref_p = to_numpy(ref_tf.init_params(jax.random.PRNGKey(1), ref_cfg))

    def ref_loss(p, b):
        return ref_tf.lm_loss(p, ref_cfg, b["tokens"], b["labels"])

    def loss(p, b):
        return tf.lm_loss(p, cfg, b["tokens"], b["labels"])

    return (ref_loss, ref_p, ref_data.token_batches(4, 16, cfg.vocab, 3),
            loss, tf.params_from_arrays(ref_p, CPU),
            data.token_batches(4, 16, cfg.vocab, 3), tf.params_from_arrays)


def xdeepfm_loop_case():
    ref_cfg = ref_archs.smoke_config("xdeepfm")
    cfg = archs.smoke_config("xdeepfm")
    ref_p = to_numpy(ref_recsys.xdeepfm_init(jax.random.PRNGKey(1),
                                             ref_cfg))

    def ref_loss(p, b):
        return ref_losses.bce_with_logits(
            ref_recsys.xdeepfm_apply(p, ref_cfg, b["ids"]), b["labels"])

    def loss(p, b):
        return losses.bce_with_logits(recsys.xdeepfm_apply(p, cfg, b["ids"]),
                                      b["labels"])

    args = (32, cfg.n_fields, cfg.vocab_per_field, 5)
    return (ref_loss, ref_p, ref_data.recsys_batches(*args), loss,
            recsys.params_from_arrays(ref_p, CPU),
            data.recsys_batches(*args), recsys.params_from_arrays)


def run_both(case, kind: str, comp: str = "none", num_micro: int = 1,
             steps: int = 3):
    ref_loss, ref_p, ref_it, loss, p, it, convert = case()
    kw = dict(kind=kind, lr=5e-2 if kind == "sgd" else 1e-2,
              warmup_steps=1, total_steps=steps)
    ref_loop = RefTrainLoop(ref_loss, jax.tree.map(jnp.asarray, ref_p),
                            RefOpt(**kw),
                            RefLoopConfig(total_steps=steps, log_every=1,
                                          num_micro=num_micro,
                                          compression=RefCompression(comp)))
    ref_res = ref_loop.run(ref_it)
    loop = TrainLoop(loss, p, OptConfig(**kw),
                     LoopConfig(total_steps=steps, log_every=1,
                                num_micro=num_micro,
                                compression=CompressionConfig(comp)))
    res = loop.run(it)
    got = [h["loss"] for h in res["history"]]
    want = [h["loss"] for h in ref_res["history"]]
    assert len(got) == len(want) == steps
    return got, want, loop, ref_loop, convert


@pytest.mark.parametrize("case", [lm_loop_case, xdeepfm_loop_case],
                         ids=["llama", "xdeepfm"])
def test_loop_sgd_matches_reference(case):
    got, want, loop, ref_loop, convert = run_both(case, "sgd", num_micro=2)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    trees_close(loop.params, convert(to_numpy(ref_loop.params), CPU), 1e-5)


@pytest.mark.parametrize("case", [lm_loop_case, xdeepfm_loop_case],
                         ids=["llama", "xdeepfm"])
def test_loop_adamw_losses_match_reference(case):
    got, want, *_ = run_both(case, "adamw")
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("comp", ["topk", "int8"])
def test_loop_error_feedback_matches_reference(comp):
    got, want, loop, ref_loop, convert = run_both(xdeepfm_loop_case, "sgd",
                                                  comp)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    trees_close(loop.params, convert(to_numpy(ref_loop.params), CPU), 1e-5)
    # the carry is what compression leaves of the gradient, so the
    # gradient's float noise (1e-6 of it) is a larger share of the carry
    trees_close(loop.err_state, convert(to_numpy(ref_loop.err_state), CPU),
                1e-3)


# -- checkpoints (the mirrors of tests/test_train.py) -----------------------
def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.int32)},
            "h": [torch.randn(3).to(torch.bfloat16)]}
    d = str(tmp_path)
    ckpt.save(d, 7, tree, meta={"next_step": 7})
    assert ckpt.latest_step(d) == 7
    restored, meta = ckpt.restore(d, 7, tree)
    assert meta["next_step"] == 7
    for a, b in zip(tree_leaves(restored), tree_leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with np.load(os.path.join(d, "step_000000007", "arrays.npz")) as z:
        assert "['b']['c']" in z and "['h'][0]" in z


@pytest.mark.parametrize("size", [0, 5, 64, 65, 200, 1000])
def test_checkpoint_crc_over_pieces_equals_zlib(size, tmp_path,
                                                monkeypatch):
    """The parallel CRC, in pieces of 64 bytes here, combined over equal
    and shorter last pieces, equals one ``zlib.crc32``."""
    import zlib
    monkeypatch.setattr(ckpt, "_CRC_PIECE", 64)
    data = np.random.default_rng(size).integers(0, 256, size,
                                                dtype=np.uint8).tobytes()
    path = tmp_path / "blob"
    path.write_bytes(data)
    assert ckpt._crc_file(str(path)) == zlib.crc32(data)


def test_checkpoint_async_snapshots_before_the_write(tmp_path):
    w = torch.zeros(5)
    ckpt.save_async(str(tmp_path), 2, {"w": w})
    w.add_(1.0)                       # after the snapshot
    ckpt.wait_pending()
    restored, _ = ckpt.restore(str(tmp_path), 2, {"w": w})
    assert torch.equal(restored["w"], torch.zeros(5))


def test_checkpoint_corruption_detected(tmp_path):
    d = str(tmp_path)
    tree = {"a": torch.ones(3)}
    path = ckpt.save(d, 1, tree)
    with open(os.path.join(path, "arrays.npz"), "r+b") as f:
        f.seek(10)
        f.write(b"\xde\xad")
    assert ckpt.latest_step(d) is None       # CRC rejects the torn file
    with pytest.raises(IOError):
        ckpt.restore(d, 1, tree)


def test_checkpoint_torn_write_invisible(tmp_path):
    d = str(tmp_path)
    tree = {"a": torch.ones(3)}
    ckpt.save(d, 1, tree)
    # simulate a crash mid-write: tmp dir left behind
    os.makedirs(os.path.join(d, "step_000000002.tmp-zzz"), exist_ok=True)
    assert ckpt.latest_step(d) == 1
    ckpt.gc_tmp(d)
    assert not any(".tmp-" in n for n in os.listdir(d))


def test_loop_resume_after_crash(tmp_path):
    """The reference's test, then: steps 8-10 of the resumed loop equal
    an uninterrupted run's bit for bit (on the CPU)."""
    params, batch = quad_problem()
    bt = tree_from_arrays(batch, CPU)
    pt = tree_from_arrays(params, CPU)

    def batches():
        while True:
            yield bt

    d = str(tmp_path)
    lp = LoopConfig(total_steps=10, ckpt_every=5, ckpt_dir=d, log_every=1)
    oc = OptConfig(lr=1e-2, total_steps=10)
    tl = TrainLoop(quad_loss, pt, oc, lp)
    res = tl.run(batches(), steps=7)
    assert res["final_step"] == 7
    tl2 = TrainLoop(quad_loss, pt, oc, lp)
    assert tl2.start_step == 7
    res2 = tl2.run(batches(), steps=10)
    assert res2["final_step"] == 10
    whole = TrainLoop(quad_loss, pt, oc, dataclasses.replace(lp,
                                                             ckpt_dir=None))
    full = whole.run(batches(), steps=10)
    assert [h["loss"] for h in full["history"][7:]] == [
        h["loss"] for h in res2["history"]]
    assert torch.equal(whole.params["w"], tl2.params["w"])


def test_watchdog_flags_stragglers():
    wd = Watchdog(factor=3.0)
    for i in range(20):
        wd.observe(i, 0.01)
    assert wd.observe(21, 0.5) is True
    assert wd.observe(22, 0.011) is False
    assert len(wd.stragglers) == 1


# -- data and the launcher --------------------------------------------------
@pytest.mark.parametrize("name,args", [
    ("token_batches", (3, 10, 50, 4)),
    ("recsys_batches", (6, 5, 40, 4)),
    ("molecule_batches", (3, 5, 8, 4, 4))])
def test_data_streams_match_reference(name, args):
    ref_it = getattr(ref_data, name)(*args)
    it = data.prefetch(getattr(data, name)(*args), 2)
    for _ in range(2):
        want, got = next(ref_it), next(it)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].device.type == CPU
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))
            assert got[k].numpy().dtype == np.asarray(want[k]).dtype
    it.close()


@pytest.mark.parametrize("arch", ["llama3.2-1b", "xdeepfm"])
def test_launcher_trains_on_the_cpu(arch, tmp_path, capsys):
    assert launch_train.main(["--arch", arch, "--steps", "3", "--batch", "4",
                              "--seq", "16", "--device", "cpu",
                              "--num-micro", "2",
                              "--ckpt-dir", str(tmp_path)]) == 0
    assert f"{arch}: step=3" in capsys.readouterr().out
    assert ckpt.latest_step(str(tmp_path)) == 3


def test_launcher_refuses_gnn_archs():
    """A GNN arch trains on the whole graph: the launcher refuses to cut
    it into microbatches."""
    for arch in ("gin-tu", "egnn"):
        with pytest.raises(ValueError, match="whole graph"):
            launch_train.main(["--arch", arch, "--device", "cpu",
                               "--num-micro", "2"])


@pytest.mark.parametrize("arch", ["gin-tu", "graphcast"])
def test_launcher_trains_gnn_archs_on_the_cpu(arch, tmp_path, capsys):
    assert launch_train.main(["--arch", arch, "--steps", "2", "--device",
                              "cpu", "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert f"{arch}: step=2" in out and "loss=nan" not in out
    assert ckpt.latest_step(str(tmp_path)) == 2
