"""The port's transformer LM against the JAX package, on the same weights.

The reference's parameters (``repro.models.transformer.init_params``,
seeded with ``jax.random.PRNGKey``) are carried across as numpy arrays
by ``params_from_arrays``; tokens are numpy draws. Every model config is
a smoke config of ``configs/archs.py`` (f32), on the CPU, where the
port's kernels run their plain versions. xDeepFM, the embedding bag and
the configs are held to the reference in ``tests/test_torch_recsys.py``.

Tolerances: f32 logits, hidden states and float cache entries rtol =
atol = 1e-4 (the reference's own decode-vs-forward tolerance in
``tests/test_models.py``; both packages sum in f32 in other orders);
bf16 cache entries rtol = atol = 2 ** -7 (two packages may round a value
that lies at a rounding boundary of bf16 to either side); int8 cache
entries within one quantization step and their scales rtol = 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import archs as ref_archs
from repro.models import attention as ref_attention
from repro.models import transformer as ref_tf
from repro_torch.configs import archs
from repro_torch.models import attention, recsys
from repro_torch.models import transformer as tf
from repro_torch.models.common import tree_from_arrays

LMS = ("llama3.2-1b", "qwen1.5-32b", "gemma2-9b")
# the reference's entry points, compiled once per config (eager JAX
# dispatches op by op)
REF_FORWARD = jax.jit(ref_tf.forward, static_argnums=1)
REF_PREFILL = jax.jit(ref_tf.prefill, static_argnums=(1, 3))
REF_DECODE = jax.jit(ref_tf.decode_step, static_argnums=1)
IMPLS = ("blockwise", "naive")
CPU = "cpu"


def configs(arch: str, impl: str):
    """The smoke config for both packages; blockwise chunks smaller than
    the sequences below, so the streaming path walks several chunks.
    Remat off: it changes only what the reference's backward pass
    recomputes, and the reference compiles faster without it."""
    kw = {"attn_impl": impl, "q_chunk": 4, "kv_chunk": 8, "remat": False}
    return (dataclasses.replace(ref_archs.smoke_config(arch), **kw),
            dataclasses.replace(archs.smoke_config(arch), **kw))


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def lm_pair(arch: str, impl: str, seed: int = 0):
    ref_cfg, cfg = configs(arch, impl)
    ref_p = ref_tf.init_params(jax.random.PRNGKey(seed), ref_cfg)
    return ref_cfg, cfg, ref_p, tf.params_from_arrays(to_numpy(ref_p), CPU)


def tokens(B: int, T: int, vocab: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, (B, T),
                                                dtype=np.int32)


def close(got, want, tol: float = 1e-4) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def flat(cache: dict) -> list:
    """(name, buffer) pairs of a cache, gemma2's halves included."""
    return [(f"{half}.{k}", v) for half, c in cache.items()
            for k, v in c.items()] if "global" in cache else list(
                cache.items())


def same_cache(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for name in want:
        g, w = got[name], want[name]
        if isinstance(w, dict):
            same_cache(g, w)
            continue
        assert tuple(g.shape) == w.shape, name
        if w.dtype == jnp.int8:
            assert g.dtype == torch.int8
            gap = np.abs(g.numpy().astype(np.int32)
                         - np.asarray(w).astype(np.int32))
            assert gap.max() <= 1, name
        elif w.dtype == jnp.bfloat16:
            assert g.dtype == torch.bfloat16
            close(g, np.asarray(w, np.float32), 2 ** -7)
        elif name.endswith("scale"):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)
        else:
            close(g, w)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", LMS)
def test_forward_and_prefill_match_reference(arch, impl):
    ref_cfg, cfg, ref_p, p = lm_pair(arch, impl)
    toks = tokens(2, 13, cfg.vocab)
    close(tf.forward(p, cfg, torch.from_numpy(toks)),
          REF_FORWARD(ref_p, ref_cfg, jnp.asarray(toks)))
    for kind in ("f32", "bf16", "int8"):
        logits, cache = tf.prefill(p, cfg, torch.from_numpy(toks), kind)
        ref_logits, ref_cache = REF_PREFILL(ref_p, ref_cfg,
                                               jnp.asarray(toks), kind)
        close(logits, ref_logits)
        same_cache(cache, ref_cache)


@pytest.mark.parametrize("arch", LMS)
def test_decode_steps_match_reference(arch):
    """A run of decode steps from an empty cache, per-row positions on
    the last steps; gemma2's local ring (window 8) wraps."""
    ref_cfg, cfg, ref_p, p = lm_pair(arch, "blockwise", seed=1)
    B, steps = 2, 12
    toks = tokens(B, steps, cfg.vocab, seed=1)
    cache = tf.init_kv_cache(cfg, B, steps, kind="f32", device=CPU)
    ref_cache = ref_tf.init_kv_cache(ref_cfg, B, steps, kind="f32")
    for t in range(steps):
        cur = t if t < steps - 2 else np.array([t, t - 1], np.int32)
        logits, cache = tf.decode_step(
            p, cfg, torch.from_numpy(toks[:, t:t + 1]), cache,
            torch.from_numpy(np.asarray(cur)) if t >= steps - 2 else cur)
        ref_logits, ref_cache = REF_DECODE(
            ref_p, ref_cfg, jnp.asarray(toks[:, t:t + 1]), ref_cache,
            jnp.asarray(cur, jnp.int32))
        close(logits, ref_logits)
    same_cache(cache, ref_cache)


@pytest.mark.parametrize("arch", LMS)
def test_int8_decode_matches_reference(arch):
    ref_cfg, cfg, ref_p, p = lm_pair(arch, "blockwise", seed=2)
    toks = tokens(2, 6, cfg.vocab, seed=2)
    cache = tf.init_kv_cache(cfg, 2, 6, kind="int8", device=CPU)
    ref_cache = ref_tf.init_kv_cache(ref_cfg, 2, 6, kind="int8")
    for t in range(6):
        logits, cache = tf.decode_step(p, cfg,
                                       torch.from_numpy(toks[:, t:t + 1]),
                                       cache, t)
        ref_logits, ref_cache = REF_DECODE(
            ref_p, ref_cfg, jnp.asarray(toks[:, t:t + 1]), ref_cache,
            jnp.int32(t))
        close(logits, ref_logits)
    same_cache(cache, ref_cache)


@pytest.mark.parametrize("arch", LMS)
def test_decode_after_prefill_equals_longer_prefill(arch):
    """Prefill T tokens, grow the cache, decode token T: the logits are
    the reference's prefill of T + 1 tokens (gemma2's ring: T > window)."""
    ref_cfg, cfg, ref_p, p = lm_pair(arch, "blockwise", seed=3)
    toks = tokens(2, 12, cfg.vocab, seed=3)
    _, cache = tf.prefill(p, cfg, torch.from_numpy(toks[:, :11]), "f32")
    kept = {k: v.clone() for k, v in flat(cache)}
    grown = tf.pad_kv_cache(cache, 16)
    logits, _ = tf.decode_step(p, cfg, torch.from_numpy(toks[:, 11:]),
                               grown, 11)
    want, _ = REF_PREFILL(ref_p, ref_cfg, jnp.asarray(toks), "f32")
    close(logits, want)
    # decoding into the grown cache leaves the prefill cache as it was
    for name, buf in flat(cache):
        assert torch.equal(buf, kept[name]), name


@pytest.mark.parametrize("window", [None, 5])
def test_attn_apply_matches_reference(window):
    """Full attention through the plain ``_sdpa``, qwen's QKV bias, a
    sliding window."""
    cfg_kw = dict(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8,
                  qkv_bias=True, window=window, logit_softcap=30.0)
    ref_p = ref_attention.attn_init(jax.random.PRNGKey(9),
                                    ref_attention.AttnConfig(**cfg_kw))
    ref_p = jax.tree.map(lambda a: a + 0.1, ref_p)    # nonzero biases
    p = tree_from_arrays(jax.tree.map(np.asarray, ref_p), CPU)
    x = np.random.default_rng(9).normal(size=(2, 11, 32)).astype(np.float32)
    close(attention.attn_apply(p, attention.AttnConfig(**cfg_kw),
                               torch.from_numpy(x)),
          ref_attention.attn_apply(ref_p, ref_attention.AttnConfig(**cfg_kw),
                                   jnp.asarray(x)))


@pytest.mark.parametrize("window", [7, 1 << 30])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blockwise_sdpa_matches_reference(window, dtype):
    B, T, H, Hk, Dh = 2, 45, 8, 4, 16
    rng = np.random.default_rng(4)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((B, T, H, Dh), (B, T, Hk, Dh), (B, T, Hk, Dh)))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    kw = dict(d_model=H * Dh, n_heads=H, n_kv_heads=Hk, head_dim=Dh,
              logit_softcap=20.0)
    want = ref_attention.blockwise_sdpa(
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v)),
        ref_attention.AttnConfig(**kw), jnp.int32(window), 16, 8)
    got = attention.blockwise_sdpa(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
        attention.AttnConfig(**kw), window, 16, 8)
    assert got.dtype == tdt
    close(got, np.asarray(want, np.float32),
          2e-2 if dtype == "bfloat16" else 1e-5)


def test_moe_config_and_entry_points_default_to_the_card():
    """A MoE config builds MoE layers (no FFN) on the device asked for;
    without CUDA the entry points refuse the default device."""
    cfg = archs.smoke_config("deepseek-moe-16b")
    p = tf.init_params(cfg, device=CPU)
    assert all("moe" in lp and "ffn" not in lp for lp in p["layers"])
    logits, _ = tf.prefill(p, cfg, torch.zeros((1, 4), dtype=torch.long))
    assert logits.shape == (1, cfg.vocab) and logits.device.type == CPU
    if torch.cuda.is_available():
        return
    for lm in (archs.smoke_config("llama3.2-1b"), cfg):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            tf.init_params(lm)
    lm = archs.smoke_config("llama3.2-1b")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tf.init_params(lm)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tf.init_kv_cache(lm, 1, 4)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        recsys.xdeepfm_init(archs.smoke_config("xdeepfm"))
