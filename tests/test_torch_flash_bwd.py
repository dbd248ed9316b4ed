"""The flash-attention gradient of the port against the JAX package, on
the CPU.

The JAX package has no backward kernel: it differentiates its plain
attention. These tests take ``jax.vjp`` of the reference oracle
``repro.kernels.ref.flash_attention_ref`` (KV heads repeated inside the
JAX function for GQA; an explicit ``scale`` enters as a factor on q,
since the oracle scales by d ** -0.5) and hold against it, on the same
numpy inputs in f32:

* ``flash_attention_bwd_plain`` given the forward's output and row
  logsumexp (the plain version the CUDA kernel mirrors: P = exp(s - lse),
  D = rowsum(dO ∘ out)), and without them (its softmax recompute);
* the ``FlashAttention`` Function through autograd, whose backward on a
  CPU tensor is that plain version;
* the plain forward's logsumexp against ``jax.scipy.special.logsumexp``
  of the oracle's masked, capped f32 scores.

Tolerance: 1e-5 of each leaf's largest |entry| (f32 sums in other
orders). Where a query sees one key only (T = 1, window 1), dq and dk
are 0 in exact arithmetic and the oracle gives exact zeros, but the
path through ``out`` and ``lse`` computes dP − D with D = rowsum(dO ∘
out) as a difference of f32 roundings (~1e-7 of |dO| |v|): such a leaf
is held to 1e-5 of the largest |entry| over the three gradients. On
``meta`` the backward launches nothing and counts exactly
``roofline.flash_bwd_work``. The kernel itself is held against the plain
version on the card (``chip_smoke.py``, ``tests/test_torch_cuda.py``).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.special import logsumexp

from repro.kernels import ref as R
from repro_torch.kernels import _build
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.flash_attention import (BWD_PAD, GLOBAL_WINDOW,
                                                 FlashAttention,
                                                 flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_plain_gqa)
from repro_torch.kernels.roofline import flash_bwd_work, flash_pairs

fa_mod = importlib.import_module("repro_torch.kernels.flash_attention")

TOL = 1e-5
B, HK, D = 2, 2, 16

# (T, group, window, softcap, scale): T off every tile size and T = 1;
# groups 1, 2, 4; windows 1, 5 and global; softcaps 0, 3, 50; explicit
# scales
CASES = [(37, 1, GLOBAL_WINDOW, 0.0, None),
         (37, 2, 5, 3.0, None),
         (37, 4, 1, 50.0, None),
         (1, 2, GLOBAL_WINDOW, 50.0, None),
         (1, 4, 5, 0.0, None),
         (1, 1, 1, 3.0, 0.7),
         (70, 4, GLOBAL_WINDOW, 3.0, 0.3),
         (70, 1, 5, 50.0, 0.3),
         (65, 2, 1, 0.0, 0.3),
         (130, 2, GLOBAL_WINDOW, 50.0, None)]
IDS = [f"T{c[0]}-g{c[1]}-w{'all' if c[2] == GLOBAL_WINDOW else c[2]}-"
       f"cap{c[3]:g}-sc{c[4]}" for c in CASES]


def case_inputs(T, group, seed=0):
    rng = np.random.default_rng(seed + T + 7 * group)
    H = HK * group
    return [rng.normal(size=s).astype(np.float32)
            for s in ((B, T, H, D), (B, T, HK, D), (B, T, HK, D),
                      (B, T, H, D))]


def q_factor(scale):
    """The factor on q that turns the oracle's d ** -0.5 into ``scale``."""
    return 1.0 if scale is None else scale * D ** 0.5


def ref_attention(window, softcap, scale, group):
    def f(q, k, v):
        kb = jnp.repeat(k, group, axis=2).transpose(0, 2, 1, 3)
        vb = jnp.repeat(v, group, axis=2).transpose(0, 2, 1, 3)
        o = R.flash_attention_ref((q * q_factor(scale)).transpose(0, 2, 1, 3),
                                  kb, vb, causal_window=window,
                                  softcap=softcap)
        return o.transpose(0, 2, 1, 3)
    return f


def ref_vjp(arrays, window, softcap, scale, group):
    q, k, v, do = (jnp.asarray(a) for a in arrays)
    out, vjp = jax.vjp(ref_attention(window, softcap, scale, group), q, k, v)
    return np.asarray(out), [np.asarray(g) for g in vjp(do)]


def ref_lse(q, k, window, softcap, scale, group):
    """logsumexp over keys of the oracle's masked, capped f32 scores."""
    T = q.shape[1]
    qb = jnp.asarray(q * q_factor(scale)).transpose(0, 2, 1, 3)
    kb = jnp.repeat(jnp.asarray(k), group, axis=2).transpose(0, 2, 1, 3)
    s = jnp.einsum("bhqd,bhkd->bhqk", qb, kb) * (D ** -0.5)
    if softcap > 0:
        s = softcap * jnp.tanh(s / softcap)
    pos = jnp.arange(T)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :]
                                             > pos[:, None] - window)
    return np.asarray(logsumexp(jnp.where(mask, s, -1e30), axis=-1))


def close(got: torch.Tensor, want: np.ndarray, floor: float = 0.0) -> None:
    """Within TOL of want's largest |entry| (or of ``floor``, the largest
    entry of the call's gradients, where that is larger)."""
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    gap = float(np.abs(got - want).max())
    assert gap <= TOL * max(float(np.abs(want).max()), floor), gap


def grads_close(got, want) -> None:
    floor = max(float(np.abs(w).max()) for w in want)
    for g, w in zip(got, want):
        close(g, w, floor)


@pytest.mark.parametrize("T,group,window,softcap,scale", CASES, ids=IDS)
def test_plain_lse_matches_jax_logsumexp(T, group, window, softcap, scale):
    q, k, v, _ = case_inputs(T, group)
    out, lse = flash_attention_plain_gqa(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        window, softcap, scale, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (B, HK * group, T)
    close(lse, ref_lse(q, k, window, softcap, scale, group))
    close(out, ref_vjp(case_inputs(T, group), window, softcap, scale,
                       group)[0])


@pytest.mark.parametrize("with_lse", [True, False],
                         ids=["out_and_lse", "recompute"])
@pytest.mark.parametrize("T,group,window,softcap,scale", CASES, ids=IDS)
def test_plain_backward_matches_jax_vjp(T, group, window, softcap, scale,
                                        with_lse):
    arrays = case_inputs(T, group)
    _, want = ref_vjp(arrays, window, softcap, scale, group)
    q, k, v, do = (torch.from_numpy(a) for a in arrays)
    kw = {}
    if with_lse:
        out, lse = flash_attention_plain_gqa(q, k, v, window, softcap,
                                             scale, return_lse=True)
        kw = {"out": out, "lse": lse}
    # blocks of 16 queries: ragged against T and cut by the window
    got = flash_attention_bwd_plain(q, k, v, do, window, softcap, scale,
                                    16, **kw)
    assert all(g.dtype == torch.float32 for g in got)
    grads_close(got, want)


@pytest.mark.parametrize("T,group,window,softcap,scale", CASES, ids=IDS)
def test_function_gradients_match_jax_vjp(T, group, window, softcap, scale):
    arrays = case_inputs(T, group, seed=1)
    want_out, want = ref_vjp(arrays, window, softcap, scale, group)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrays[:3])
    out = flash_attention(q, k, v, window, softcap, scale, 8)
    assert out.grad_fn is not None
    close(out, want_out)
    got = torch.autograd.grad(out, (q, k, v), torch.from_numpy(arrays[3]))
    grads_close(got, want)


def test_cpu_wrapper_is_the_plain_version_with_out_and_lse():
    q, k, v, do = (torch.from_numpy(a) for a in case_inputs(70, 2))
    out, lse = flash_attention_plain_gqa(q, k, v, 5, 3.0, return_lse=True)
    got = flash_attention_bwd(q, k, v, out, lse, do, 5, 3.0, None, 16)
    want = flash_attention_bwd_plain(q, k, v, do, 5, 3.0, None, 16, out=out,
                                     lse=lse)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_plain_backward_keeps_bf16():
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16)
                   for a in case_inputs(37, 2))
    out, lse = flash_attention_plain_gqa(q, k, v, return_lse=True)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    got = flash_attention_bwd(q, k, v, out, lse, do)
    assert all(g.dtype == torch.bfloat16 for g in got)
    want = flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                     do.float())
    for g, w in zip(got, want):
        assert float((g.float() - w).abs().max()) <= \
            2e-2 * float(w.abs().max())


def test_plain_backward_refuses_out_without_lse():
    q, k, v, do = (torch.from_numpy(a) for a in case_inputs(5, 1))
    with pytest.raises(ValueError, match="both"):
        flash_attention_bwd_plain(q, k, v, do, out=q)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, k, v, q, torch.zeros(B, HK, 4), do)
    with pytest.raises(ValueError, match="float32"):
        flash_attention_bwd(q, k, v, q, torch.zeros(B, HK, 5,
                                                   dtype=torch.float64), do)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("window", [GLOBAL_WINDOW, 17])
@pytest.mark.parametrize("T,d", [(300, 64), (2048, 256)])
def test_backward_on_meta_counts_its_work_and_launches_nothing(dtype,
                                                               window, T, d):
    """On meta: outputs of the right shapes, the work of five products
    over the kept pairs (the kernel's scratch, its dQ tiles and turn
    flags, is neither made nor counted), and no launch."""
    H = 8
    q = torch.empty(B, T, H, d, dtype=dtype, device="meta")
    kv = torch.empty(B, T, HK, d, dtype=dtype, device="meta")
    lse = torch.empty(B, H, T, device="meta")
    launches = _build.launch_counts()
    _build.reset_kernel_work()
    got = flash_attention_bwd(q, kv, kv, q, lse, q, window)
    assert [(g.shape, g.dtype, g.device.type) for g in got] == [
        (q.shape, dtype, "meta"), (kv.shape, dtype, "meta"),
        (kv.shape, dtype, "meta")]
    nbytes, ops = flash_bwd_work(B, T, H, HK, d, window, q.element_size())
    assert ops == 10 * d * B * H * flash_pairs(T, window)
    assert _build.kernel_work()["flash_attention_bwd"] == {"flops": ops,
                                                           "bytes": nbytes}
    assert _build.launch_counts() == launches
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_bwd(q[..., :8], kv[..., :8], kv[..., :8],
                            q[..., :8], lse, q[..., :8])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("T,H,Hk,d", [(1, 4, 2, 64), (300, 8, 8, 256),
                                      (4096, 32, 8, 64)])
def test_backward_scratch_holds_dq_tiles_and_turn_flags(dtype, T, H, Hk, d):
    """The kernel's scratch beside lse and D: in bf16 f32 dQ tiles of 64
    queries x d for every (b, head, tile), and zeroed uint32 flags (the
    tile counter, two turn counts a dQ tile); in f32 each head's partial
    dK and dV where a KV head serves a group, else nothing."""
    Tp, scratch, sync = fa_mod._bwd_scratch(B, T, H, Hk, d, dtype,
                                            torch.device("cpu"))
    assert Tp % BWD_PAD == 0 and T <= Tp < T + BWD_PAD
    if dtype == torch.bfloat16:
        assert scratch.dtype == torch.float32
        assert scratch.numel() == B * H * (Tp // 64) * 64 * d
        assert sync.dtype == torch.int32
        assert sync.numel() == 1 + 2 * B * H * (Tp // 64)
        assert not sync.any()
    else:
        assert sync is None
        if H == Hk:
            assert scratch is None
        else:
            assert scratch.shape == (2, B, T, H, d)


def test_function_on_meta_counts_forward_and_backward():
    T, H, d = 130, 8, 64
    q = torch.empty(B, T, H, d, dtype=torch.bfloat16, device="meta",
                    requires_grad=True)
    k = torch.empty(B, T, HK, d, dtype=torch.bfloat16, device="meta",
                    requires_grad=True)
    launches = _build.launch_counts()
    _build.reset_kernel_work()
    out = kernel_ops.flash_attention(q, k, k, causal_window=17)
    assert out.grad_fn is not None
    dq, dk = torch.autograd.grad(out, (q, k), torch.empty_like(out))
    assert dq.shape == q.shape and dk.shape == k.shape
    work = _build.kernel_work()
    assert work["flash_attention_bwd"]["flops"] == \
        flash_bwd_work(B, T, H, HK, d, 17, 2)[1]
    assert _build.launch_counts() == launches


@pytest.mark.parametrize("T,window", [(1, GLOBAL_WINDOW), (300, 17),
                                      (4096, GLOBAL_WINDOW), (8192, 4096)])
def test_flash_bwd_work_counts_five_products_over_the_kept_pairs(T, window):
    Bb, H, Hk, d = 2, 32, 8, 64
    nbytes, ops = flash_bwd_work(Bb, T, H, Hk, d, window, 2)
    assert ops == 10 * d * Bb * H * flash_pairs(T, window)
    assert nbytes == (4 * Bb * T * H * d + 4 * Bb * T * Hk * d) * 2 \
        + 2 * Bb * H * T * 4


def test_saved_logsumexp_is_the_forwards():
    """The Function saves q, k, v, the output and its logsumexp."""
    q, k, v, _ = (torch.from_numpy(a).requires_grad_()
                  for a in case_inputs(37, 2))
    out = FlashAttention.apply(q, k, v, 5, 3.0, None, 16)
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 5
    want_out, want_lse = flash_attention_plain_gqa(q, k, v, 5, 3.0,
                                                   return_lse=True)
    assert torch.equal(saved[3], want_out) and torch.equal(saved[4],
                                                           want_lse)
