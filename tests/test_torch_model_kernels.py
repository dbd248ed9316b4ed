"""The port's model kernels against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; the
reference kernels run in Pallas interpret mode, as ``tests/test_kernels.py``
runs them, and the reference oracles (``repro.kernels.ref``) as plain
jnp. Both packages get the same numpy inputs (bf16 inputs are rounded
from the same f32 values by both), over the grids of
``tests/test_kernels.py``.

Tolerances, as ``tests/test_kernels.py`` holds the Pallas kernels: flash
attention rtol = atol = 3e-4 in f32 and 2e-2 in bf16; the CIN layer
rtol = atol = 2e-4 (f32 sums in another order).

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
from repro_torch.kernels.cin import cin_layer_plain
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
