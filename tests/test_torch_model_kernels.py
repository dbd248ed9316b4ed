"""The port's model kernels against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; the
reference kernels run in Pallas interpret mode, as ``tests/test_kernels.py``
runs them, and the reference oracles (``repro.kernels.ref``) as plain
jnp. Both packages get the same numpy inputs (bf16 inputs are rounded
from the same f32 values by both), over the grids of
``tests/test_kernels.py``.

Tolerances, as ``tests/test_kernels.py`` holds the Pallas kernels: flash
attention rtol = atol = 3e-4 in f32 and 2e-2 in bf16; the CIN layer
rtol = atol = 2e-4 (f32 sums in another order). The CIN kernel's weight
packing (TF32 hi and lo parts, exact, cached per tensor and version) is
checked directly, and its three TF32 products are emulated on the CPU
against the Pallas kernel at the same 2e-4.

The CUDA kernels themselves are held against these plain versions on
the card by ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import cin_layer as ref_cin_layer
from repro.kernels import flash_attention as ref_flash_attention
from repro.kernels import ref as R
from repro.kernels.cin import cin_layer_pallas
from repro_torch.kernels import cin_layer, flash_attention, ops
from repro_torch.kernels import cin as cin_module
from repro_torch.kernels.cin import (K_TILE, cin_layer_plain, cin_splits,
                                     cin_tile, kernel_weights,
                                     packed_weights)
from repro_torch.kernels.flash_attention import (GLOBAL_WINDOW,
                                                 flash_attention_plain_gqa)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def inputs(shapes, seed: int, dtype: str):
    """The same values for both packages: numpy normals rounded to
    ``dtype`` by each."""
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    arrays = [rng.normal(size=s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def close(got: torch.Tensor, want, tol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def ref_bhtd(q, k, v, window, softcap):
    """``flash_attention_ref`` on [B, T, H, d] inputs with GQA heads."""
    group = q.shape[2] // k.shape[2]
    kb = jnp.repeat(k, group, axis=2).transpose(0, 2, 1, 3)
    vb = jnp.repeat(v, group, axis=2).transpose(0, 2, 1, 3)
    return R.flash_attention_ref(q.transpose(0, 2, 1, 3), kb, vb,
                                 causal_window=window,
                                 softcap=softcap).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,H,Hk,d", [(96, 4, 2, 32), (130, 2, 2, 64),
                                      (64, 8, 1, 16)])
def test_flash_attention_sweep(T, H, Hk, d, dtype):
    (jq, jk, jv), (q, k, v) = inputs(
        [(2, T, H, d), (2, T, Hk, d), (2, T, Hk, d)], 0, dtype)
    pallas = ref_flash_attention(jq, jk, jv, block_q=32, block_k=64)
    oracle = ref_bhtd(jq, jk, jv, 1 << 30, 0.0)
    tol = 2e-2 if dtype == "bfloat16" else 3e-4
    got = ops.flash_attention(q, k, v, block_q=32, block_k=64)
    assert got.dtype == q.dtype and got.shape == q.shape
    close(got, pallas, tol)
    close(got, oracle, tol)
    close(flash_attention_plain_gqa(q, k, v, GLOBAL_WINDOW, 0.0), oracle,
          tol)


@pytest.mark.parametrize("window,softcap", [(17, 0.0), (1 << 30, 20.0),
                                            (9, 30.0)])
def test_flash_attention_window_softcap(window, softcap):
    (jq, jk, jv), (q, k, v) = inputs([(1, 80, 2, 32)] * 3, 3, "float32")
    pallas = ref_flash_attention(jq, jk, jv, causal_window=window,
                                 softcap=softcap, block_q=16, block_k=16)
    oracle = ref_bhtd(jq, jk, jv, window, softcap)
    got = flash_attention(q, k, v, causal_window=window, softcap=softcap)
    close(got, pallas, 3e-4)
    close(got, oracle, 3e-4)
    close(flash_attention_plain_gqa(q, k, v, window, softcap), oracle,
          3e-4)


@pytest.mark.parametrize("B,Hp,F,H,D", [(32, 8, 6, 12, 10), (65, 16, 8, 8, 4),
                                        (128, 200, 39, 200, 10)])
def test_cin_sweep(B, Hp, F, H, D):
    (jxk, jx0, jw), (xk, x0, w) = inputs(
        [(B, Hp, D), (B, F, D), (H, Hp, F)], 1, "float32")
    jw, w = jw * 0.1, w * 0.1
    pallas = ref_cin_layer(jxk, jx0, jw)
    oracle = R.cin_layer_ref(jxk, jx0, jw)
    got = cin_layer(xk, x0, w)
    assert got.dtype == xk.dtype and got.shape == (B, H, D)
    close(got, pallas, 2e-4)
    close(got, oracle, 2e-4)
    close(ops.cin_layer(xk, x0, w), oracle, 2e-4)


def test_cin_block_boundary():
    """B = 37 is no multiple of the reference's 16-row block (padding)."""
    (jxk, jx0, jw), (xk, x0, w) = inputs(
        [(37, 5, 6), (37, 4, 6), (7, 5, 4)], 2, "float32")
    want = cin_layer_pallas(jxk, jx0, jw, block_b=16)
    close(cin_layer_plain(xk, x0, w), want, 2e-4)
    close(cin_layer(xk, x0, w), R.cin_layer_ref(jxk, jx0, jw), 2e-4)


def test_cin_plain_chunks_rows(monkeypatch):
    """The plain version walks the batch in chunks (the outer product of
    a whole serving batch would not fit); the result does not depend on
    the chunk."""
    from repro_torch.kernels import cin as cin_module
    (_, _, _), (xk, x0, w) = inputs([(37, 5, 6), (37, 4, 6), (7, 5, 4)], 4,
                                    "float32")
    whole = cin_layer_plain(xk, x0, w)
    monkeypatch.setattr(cin_module, "_PLAIN_CHUNK", 5 * 4 * 6 * 3)
    torch.testing.assert_close(cin_layer_plain(xk, x0, w), whole,
                               rtol=0, atol=0)


def test_wrappers_refuse_mismatched_shapes():
    q = torch.zeros((1, 8, 3, 16))
    with pytest.raises(ValueError, match="group"):
        flash_attention(q, q[:, :, :2], q[:, :, :2])
    with pytest.raises(ValueError, match="chain"):
        cin_layer(torch.zeros((2, 3, 4)), torch.zeros((2, 5, 4)),
                  torch.zeros((6, 3, 4)))
    with pytest.raises(ValueError, match="positive"):
        ops.flash_attention(q, q, q, block_q=0)


def unpack_weights(wp: torch.Tensor, H: int, Hp: int, F: int):
    """hi + lo of :func:`kernel_weights` back as [H, Hp, F], and the
    padding (F to Fp, K to the K tile, H to the product width) alone."""
    ht, kt, _, nc, kc, _, _ = wp.shape
    fp = -(-F // 8) * 8
    full = (wp[:, :, 0] + wp[:, :, 1]).permute(0, 2, 4, 1, 3, 5).reshape(
        ht * nc * 8, kt * kc * 4)
    w = full[:H, :Hp * fp].reshape(H, Hp, fp)
    pad = torch.cat([w[..., F:].flatten(), full[:H, Hp * fp:].flatten(),
                     full[H:].flatten()])
    return w[..., :F], pad


@pytest.mark.parametrize("H,Hp,F", [(200, 200, 39), (200, 39, 39),
                                    (7, 5, 4), (70, 13, 9)])
def test_cin_kernel_weights_split_exactly(H, Hp, F):
    """hi + lo is w exactly in f32, hi has its low 13 mantissa bits
    clear (a TF32 value), and the padding is zero; the product width is
    H itself for H = 200, else 64."""
    w = torch.from_numpy(np.random.default_rng(H + Hp).normal(
        size=(H, Hp, F)).astype(np.float32))
    wp = kernel_weights(w)
    nb = cin_tile(H)
    assert nb == (200 if H == 200 else 64)
    assert wp.shape == (-(-H // nb), -(-Hp * (-(-F // 8) * 8) // K_TILE), 2,
                        nb // 8, K_TILE // 4, 8, 4)
    assert not (wp[:, :, 0].contiguous().view(torch.int32) & 0x1FFF).any()
    back, pad = unpack_weights(wp, H, Hp, F)
    assert torch.equal(back, w) and not pad.any()


def test_cin_packed_weights_cached(monkeypatch):
    """A second call on the same tensor does not repack; an in-place
    update (a new version) does, and another tensor gets its own."""
    w = torch.randn(7, 5, 4)
    calls = []
    real = cin_module.kernel_weights

    def counting(t):
        calls.append(t)
        return real(t)
    monkeypatch.setattr(cin_module, "kernel_weights", counting)
    first = packed_weights(w)
    assert packed_weights(w) is first and len(calls) == 1
    w.mul_(2.0)
    again = packed_weights(w)
    assert again is not first and len(calls) == 2
    torch.testing.assert_close(unpack_weights(again, 7, 5, 4)[0], w,
                               rtol=0, atol=0)
    other = w.clone()
    assert packed_weights(other) is not again and len(calls) == 3


def tf32_truncate(x: torch.Tensor) -> torch.Tensor:
    """What a TF32 tensor core reads of an f32 operand: the low 13
    mantissa bits dropped."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


@pytest.mark.parametrize("B,Hp,F,H,D", [(32, 8, 6, 12, 10),
                                        (64, 200, 39, 200, 10)])
def test_cin_three_tf32_products_hold_the_tolerance(B, Hp, F, H, D):
    """The kernel's numerics on the CPU: z = xk * x0 in f32, both z and w
    split into TF32 hi and lo parts, the products hi * hi + hi * lo +
    lo * hi of the truncated operands summed in f32, against the Pallas
    kernel at 2e-4."""
    (jxk, jx0, jw), (xk, x0, w) = inputs(
        [(B, Hp, D), (B, F, D), (H, Hp, F)], 5, "float32")
    scale = (2.0 / (Hp * F)) ** 0.5
    jw, w = jw * scale, w * scale
    z = torch.einsum("bid,bjd->bdij", xk, x0).reshape(B * D, Hp * F)
    wk = w.reshape(H, Hp * F).T
    zh, zl = cin_module.tf32_split(z)
    wh, wl = cin_module.tf32_split(wk)
    zl, wl = tf32_truncate(zl), tf32_truncate(wl)
    got = zh @ wh + zh @ wl + zl @ wh
    got = got.reshape(B, D, H).permute(0, 2, 1)
    close(got, cin_layer_pallas(jxk, jx0, jw), 2e-4)


def test_cin_splits_fill_the_card():
    """serve_p99 (5,120 columns, 40 tiles) splits K in 3 on 132 SMs; a
    bulk batch does not split; a split keeps 8 K tiles at least."""
    assert cin_splits(5120, 1, 250, 132) == 3
    assert cin_splits(5120, 1, 49, 132) == 3
    assert cin_splits(2_621_440, 1, 250, 132) == 1
    assert cin_splits(10, 1, 250, 132) == 31
    assert cin_splits(10, 1, 7, 132) == 1
    assert cin_splits(370, 2, 3, 132) == 1


def test_cin_splits_bound_each_range():
    """No CTA accumulates more than 256 K tiles: a K of 200 · 200 (1,250
    tiles) over 5,120 column tiles splits in 5, over 40 in 5 rather than
    3; the forward's longest K (250 tiles) stays whole at a bulk
    batch."""
    assert cin_splits(655_360, 1, 1250, 132) == 5
    assert cin_splits(5120, 1, 1250, 132) == 5
    assert cin_splits(2_621_440, 1, 250, 132) == 1
    assert cin_splits(655_360, 1, 257, 132) == 2
