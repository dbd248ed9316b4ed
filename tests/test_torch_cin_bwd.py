"""The CIN layer's backward in the port against the JAX package, on the
CPU.

The port's ``cin_weight_grad`` (dw) and ``cin_dx0`` launch the kernels of
``csrc/cin_bwd.cu`` on the card; on the CPU they run their plain
versions, held here against ``jax.vjp`` of ``repro.kernels.ref.
cin_layer_ref`` and of the reference ``cin_apply`` on the same numpy
inputs, f32, within 1e-5 of each gradient's largest entry (f32 sums in
other orders). The kernels' own side is checked without a card: the
operand packings their pre-passes write (TF32 hi + lo exactly the value,
zero padding, each entry where the layout puts it), their numerics
emulated from those packings (three TF32 products, hi * hi + hi * lo +
lo * hi on truncated operands, dw's K ranges summed in order) within
``chip_smoke.CIN_GRAD_TOL`` (1e-4 of the largest entry), the split
planning, and the meta path (work counted, nothing launched). The
kernels themselves are held against the plain versions on the card by
``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as R
from repro.models import recsys as ref_recsys
from repro_torch.kernels import _build
from repro_torch.kernels import cin as cin_mod
from repro_torch.kernels.cin import (DX0_CHUNK, DX0_TILE, DX0_WIDTH,
                                     K_TILE, MAX_SPLIT_TILES, cin_dx0,
                                     cin_dx0_plain, cin_layer, cin_tile,
                                     cin_weight_grad, cin_weight_grad_plain,
                                     dw_operands, dw_splits, dx0_fields,
                                     dx0_operands, dx0_splits, dx0_weights,
                                     packed_dx0_weights)
from repro_torch.kernels.roofline import cin_bwd_work
from repro_torch.models import recsys

TOL = 1e-5
EMULATED_TOL = 1e-4

# (B, Hp, F, H, D): Hp != F, F not a multiple of 8, B * D not a multiple
# of 64 (and of 32, the dw kernel's K tile), the layers' widths at a
# small batch, layer 0 (Hp = F, where xk is x0), and F above 200 (the
# dx0 kernel's fields in two blocks)
SHAPES = [(5, 4, 4, 7, 3), (9, 13, 9, 37, 3), (7, 6, 5, 11, 10),
          (3, 39, 39, 200, 10), (2, 200, 39, 200, 10), (11, 17, 3, 70, 6),
          (2, 203, 203, 7, 3)]


def ids(shape):
    return "B{}-Hp{}-F{}-H{}-D{}".format(*shape)


def arrays(shape, seed: int):
    B, Hp, F, H, D = shape
    rng = np.random.default_rng(seed)
    xk = rng.normal(size=(B, Hp, D)).astype(np.float32)
    x0 = rng.normal(size=(B, F, D)).astype(np.float32)
    w = (rng.normal(size=(H, Hp, F)) * (2.0 / (Hp * F)) ** 0.5).astype(
        np.float32)
    g = rng.normal(size=(B, H, D)).astype(np.float32)
    return xk, x0, w, g


def ref_grads(xk, x0, w, g):
    """(dxk, dx0, dw) of the reference oracle by ``jax.vjp``."""
    _, vjp = jax.vjp(R.cin_layer_ref, jnp.asarray(xk), jnp.asarray(x0),
                     jnp.asarray(w))
    return [np.asarray(a) for a in vjp(jnp.asarray(g))]


def close(got: torch.Tensor, want: np.ndarray, tol: float) -> None:
    """Within ``tol`` of the largest |entry| of ``want``."""
    got = got.detach().double().numpy()
    scale = max(float(np.abs(want).max()), 1e-30)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= tol * scale


def tf32_truncate(x: torch.Tensor) -> torch.Tensor:
    """What a TF32 tensor core reads of an f32 operand: the low 13
    mantissa bits dropped."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def unpack_kmajor(t: torch.Tensor) -> torch.Tensor:
    """The [2, R, K] parts (hi, lo) of a ``_tile_kmajor`` packing [R tiles,
    K tiles, 2, nb / 8, kt / 4, 8, 4]."""
    rt, kt, _, n8, k4, _, _ = t.shape
    return t.permute(2, 0, 3, 5, 1, 4, 6).reshape(2, rt * n8 * 8,
                                                  kt * k4 * 4)


# -- the plain versions against the reference -------------------------------
@pytest.mark.parametrize("shape", SHAPES, ids=ids)
def test_plain_grads_match_jax_vjp(shape, monkeypatch):
    """cin_weight_grad_plain and cin_dx0_plain against ``jax.vjp`` of
    ``cin_layer_ref``; chunks of at most 200 entries, so that every
    batch walks several."""
    monkeypatch.setattr(cin_mod, "_PLAIN_CHUNK", 200)
    xk, x0, w, g = arrays(shape, 1)
    _, want_dx0, want_dw = ref_grads(xk, x0, w, g)
    t = [torch.from_numpy(a) for a in (xk, x0, w, g)]
    close(cin_weight_grad_plain(t[3], t[0], t[1]), want_dw, TOL)
    close(cin_dx0_plain(t[3], t[0], t[2]), want_dx0, TOL)
    # the wrappers run them on a CPU tensor
    close(cin_weight_grad(t[3], t[0], t[1]), want_dw, TOL)
    close(cin_dx0(t[3], t[0], t[2]), want_dx0, TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=ids)
def test_cin_layer_gradients_match_jax_vjp(shape):
    """The whole ``CinLayer`` gradient (dxk, dx0, dw) on the CPU; where
    Hp = F also layer 0, xk being x0 itself (its two gradients summed)."""
    xk, x0, w, g = arrays(shape, 2)
    want = ref_grads(xk, x0, w, g)
    t = [torch.from_numpy(a).requires_grad_() for a in (xk, x0, w)]
    out = cin_layer(*t)
    assert out.grad_fn is not None
    for a, b in zip(torch.autograd.grad(out, t, torch.from_numpy(g)), want):
        close(a, b, TOL)
    if shape[1] == shape[2]:
        _, vjp = jax.vjp(lambda a, b: R.cin_layer_ref(a, a, b),
                         jnp.asarray(x0), jnp.asarray(w))
        want0 = [np.asarray(a) for a in vjp(jnp.asarray(g))]
        x, wt = (torch.from_numpy(a).requires_grad_() for a in (x0, w))
        got0 = torch.autograd.grad(cin_layer(x, x, wt), (x, wt),
                                   torch.from_numpy(g))
        for a, b in zip(got0, want0):
            close(a, b, TOL)


@pytest.mark.parametrize("layers", [(7, 5), (200, 200, 200)])
def test_cin_apply_gradients_match_reference(layers):
    """The port's ``cin_apply`` (every layer through ``CinLayer``, the
    first on xk = x0) against ``jax.vjp`` of the reference's, for the
    weights and x0, on a cotangent of the pooled features."""
    B, F, D = 3, 39, 10
    rng = np.random.default_rng(sum(layers))
    x0 = rng.normal(size=(B, F, D)).astype(np.float32)
    ws, h_prev = [], F
    for h in layers:
        ws.append((rng.normal(size=(h, h_prev, F))
                   * (2.0 / (h_prev * F)) ** 0.5).astype(np.float32))
        h_prev = h
    ct = rng.normal(size=(B, sum(layers))).astype(np.float32)
    _, vjp = jax.vjp(ref_recsys.cin_apply, [jnp.asarray(w) for w in ws],
                     jnp.asarray(x0))
    want_ws, want_x0 = vjp(jnp.asarray(ct))
    tws = [torch.from_numpy(w).requires_grad_() for w in ws]
    tx0 = torch.from_numpy(x0).requires_grad_()
    got = torch.autograd.grad(recsys.cin_apply(tws, tx0), [*tws, tx0],
                              torch.from_numpy(ct))
    for a, b in zip(got, [*want_ws, want_x0]):
        close(a, np.asarray(b), TOL)


# -- the packings the kernels read ------------------------------------------
@pytest.mark.parametrize("shape", SHAPES, ids=ids)
def test_dw_operands_split_exactly(shape):
    """g transposed into K-major tiles of the product width (200 for H =
    200, else 64) by 32 columns: hi + lo is g exactly, hi a TF32 value,
    zeros past H and past the B · D columns; xk and x0 over the columns
    in blocks of 16 and 8 rows, zeros past Hp, F and the columns."""
    B, Hp, F, H, D = shape
    xk, x0, _, g = (torch.from_numpy(a) for a in arrays(shape, 3))
    ops = dw_operands(g, xk, x0)
    nb, cols = cin_tile(H), B * D
    kt = -(-cols // K_TILE)
    assert ops["g"].shape == (-(-H // nb), kt, 2, nb // 8, K_TILE // 4, 8, 4)
    assert not (ops["g"][:, :, 0].contiguous().view(torch.int32)
                & 0x1FFF).any()
    parts = unpack_kmajor(ops["g"])
    full = parts[0] + parts[1]
    want = g.permute(1, 0, 2).reshape(H, cols)
    assert torch.equal(full[:H, :cols], want)
    assert not full[H:].any() and not full[:, cols:].any()
    # entry (h, c) of c = b · D + d is g[b, h, d]
    b, h, d = B - 1, H - 1, D - 1
    assert full[h, b * D + d] == g[b, h, d]
    for key, x, rb in (("xk", xk, 16), ("x0", x0, 8)):
        R_ = x.shape[1]
        assert ops[key].shape == (kt, -(-R_ // rb), K_TILE, rb)
        cols_x = ops[key].permute(0, 2, 1, 3).reshape(kt * K_TILE, -1)
        assert torch.equal(cols_x[:cols, :R_],
                           x.permute(0, 2, 1).reshape(cols, R_))
        assert not cols_x[cols:].any() and not cols_x[:, R_:].any()


@pytest.mark.parametrize("shape", SHAPES, ids=ids)
def test_dx0_packings_split_exactly(shape):
    """g as [(b, d), h] in K-major tiles of 128 columns by chunks of 40
    h; w K-major along h per block of Fq fields and group of 200 / Fq
    values of i (n = (i - group start) · Fq + j - block start), one stage
    a k-step of 8 h: hi + lo exact, hi a TF32 value, zeros past H, Hp, F
    and the columns."""
    B, Hp, F, H, D = shape
    _, _, w, g = (torch.from_numpy(a) for a in arrays(shape, 4))
    cols = B * D
    ga = dx0_operands(g)
    chunks = -(-H // DX0_CHUNK)
    assert ga.shape == (-(-cols // DX0_TILE), chunks, 2, DX0_TILE // 8,
                        DX0_CHUNK // 4, 8, 4)
    assert not (ga[:, :, 0].contiguous().view(torch.int32) & 0x1FFF).any()
    full = unpack_kmajor(ga).sum(0)
    assert torch.equal(full[:cols, :H], g.permute(0, 2, 1).reshape(cols, H))
    assert not full[cols:].any() and not full[:, H:].any()

    wb = dx0_weights(w)
    fq = dx0_fields(F)
    ig = DX0_WIDTH // fq
    blocks, groups = -(-F // fq), -(-Hp // ig)
    assert wb.shape == (blocks, chunks, groups, DX0_CHUNK // 8, 2,
                        DX0_WIDTH // 8, 2, 8, 4)
    assert not (wb[:, :, :, :, 0].contiguous().view(torch.int32)
                & 0x1FFF).any()
    full = (dx0_parts(wb)[0] + dx0_parts(wb)[1]).view(
        blocks, chunks * DX0_CHUNK, groups * ig, fq)
    # [block, h, i, j] -> [h, i, (block, j)]
    full = full.permute(1, 2, 0, 3).reshape(chunks * DX0_CHUNK, groups * ig,
                                            blocks * fq)
    assert torch.equal(full[:H, :Hp, :F], w)
    assert not full[H:].any() and not full[:, Hp:].any()
    assert not full[:, :, F:].any()


def test_packed_dx0_weights_cached(monkeypatch):
    """Packed once per tensor, anew after an in-place update, apart from
    the forward's packing of the same tensor."""
    w = torch.randn(7, 5, 4)
    calls = []
    real = cin_mod.dx0_weights

    def counting(t):
        calls.append(t)
        return real(t)
    monkeypatch.setattr(cin_mod, "dx0_weights", counting)
    first = packed_dx0_weights(w)
    assert packed_dx0_weights(w) is first and len(calls) == 1
    assert cin_mod.packed_weights(w) is not first
    w.add_(1.0)
    again = packed_dx0_weights(w)
    assert again is not first and len(calls) == 2
    assert torch.equal(again, real(w))


def dx0_parts(wb: torch.Tensor) -> torch.Tensor:
    """The [2, blocks, h, (group, n)] parts (hi, lo) of a
    ``dx0_weights`` packing [blocks, chunks, groups, q, 2, n8, k4, nr,
    kr]."""
    blocks, chunks, groups = wb.shape[:3]
    return wb.permute(4, 0, 1, 3, 6, 8, 2, 5, 7).reshape(
        2, blocks, chunks * DX0_CHUNK, groups * DX0_WIDTH)


# -- the kernels' numerics, emulated on their packings ----------------------
def three_products(a_hi, a_lo, b_hi, b_lo):
    """hi · hi + hi · lo + lo · hi, the lo parts truncated to TF32 as the
    tensor cores read them, in f32."""
    a_lo, b_lo = tf32_truncate(a_lo), tf32_truncate(b_lo)
    return a_hi @ b_hi + a_hi @ b_lo + a_lo @ b_hi


@pytest.mark.parametrize("shape", SHAPES, ids=ids)
def test_dw_kernel_numerics_emulated(shape):
    """dw as the kernel computes it, from the packed operands only: z =
    xk · x0 formed in f32 per (i, j) row and split, g's parts as packed,
    three products per K range (ranges of at most 4 K tiles here, so that
    every batch splits), the ranges' partials summed in order; against
    the reference's dw."""
    B, Hp, F, H, D = shape
    xk, x0, w, g = arrays(shape, 5)
    ops = dw_operands(*(torch.from_numpy(a) for a in (g, xk, x0)))
    kt = ops["g"].shape[1]
    gh, gl = unpack_kmajor(ops["g"])               # [N, K] = [h, c]
    X = ops["xk"].permute(0, 2, 1, 3).reshape(kt * K_TILE, -1)   # [c, i]
    Y = ops["x0"].permute(0, 2, 1, 3).reshape(kt * K_TILE, -1)   # [c, j]
    z = (X[:, :, None] * Y[:, None, :]).reshape(kt * K_TILE, -1)  # [c, ij]
    zh, zl = cin_mod.tf32_split(z)
    got = None
    for lo in range(0, kt, 4):
        c = slice(lo * K_TILE, (lo + 4) * K_TILE)
        part = three_products(zh[c].T, zl[c].T, gh[:, c].T, gl[:, c].T)
        got = part if got is None else got + part
    got = got.view(X.shape[1], Y.shape[1], -1)[:Hp, :F, :H].permute(2, 0, 1)
    close(got, ref_grads(xk, x0, w, g)[2], EMULATED_TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=ids)
def test_dx0_kernel_numerics_emulated(shape):
    """dx0 as the kernel computes it, from the packed operands only: per
    chunk of 40 h and group of i, u = G · W in three products, then dx0
    += xk[c, i] · u in f32; against the reference's dx0."""
    B, Hp, F, H, D = shape
    xk, x0, w, g = arrays(shape, 6)
    txk = torch.from_numpy(xk)
    ga = dx0_operands(torch.from_numpy(g))
    wb = dx0_weights(torch.from_numpy(w))
    blocks, chunks, groups = wb.shape[:3]
    fq = dx0_fields(F)
    ig = DX0_WIDTH // fq
    ah, al = unpack_kmajor(ga)                     # [c, h]
    bparts = dx0_parts(wb)                         # [p, block, h, (gr, n)]
    cols = B * D
    xc = torch.zeros((ah.shape[0], groups * ig))
    xc[:cols, :Hp] = txk.permute(0, 2, 1).reshape(cols, Hp)
    dx = torch.zeros((ah.shape[0], blocks, fq))
    for fb in range(blocks):
        for ch in range(chunks):
            h = slice(ch * DX0_CHUNK, (ch + 1) * DX0_CHUNK)
            u = three_products(ah[:, h], al[:, h], bparts[0, fb, h],
                               bparts[1, fb, h])
            u = u.view(-1, groups * ig, fq)
            dx[:, fb] += (xc[:, :, None] * u).sum(1)
    got = dx.view(-1, blocks * fq)[:cols, :F].reshape(B, D, F).permute(
        0, 2, 1)
    close(got, ref_grads(xk, x0, w, g)[1], EMULATED_TOL)


# -- planning ---------------------------------------------------------------
def test_dw_splits_bound_each_range_and_fill_the_card():
    """train_batch's Hp = 200 layer (65 tiles of 16 i by 8 j, 20,480 K
    tiles) splits in 80 ranges of 256 tiles; serve_p99's (160 K tiles)
    in 2 to fill 132 SMs, its first layer (15 tiles) in 8; a range keeps
    8 K tiles at least."""
    assert dw_splits(65, 20480, 132) == 80
    assert -(-20480 // 80) <= MAX_SPLIT_TILES
    assert dw_splits(65, 160, 132) == 2
    assert dw_splits(15, 160, 132) == 8
    assert dw_splits(15, 20480, 132) == 80
    assert dw_splits(1, 7, 132) == 1
    assert dw_splits(1, 40, 132) == 5
    assert dw_splits(200, 300, 132) == 2


def test_dx0_splits_fill_the_card():
    """serve_p99 (40 column tiles, 5 chunks by 40 groups) splits in 3; a
    bulk batch does not; one tile in up to 25; a CTA keeps 8 units."""
    assert dx0_splits(40, 200, 132) == 3
    assert dx0_splits(5120, 200, 132) == 1
    assert dx0_splits(1, 200, 132) == 25
    assert dx0_splits(1, 7, 132) == 1
    assert dx0_splits(2, 3, 132) == 1


def test_dx0_fields_pad_to_a_width_that_divides_200():
    """F pads to 40 or 200; above 200 it runs in blocks of 200."""
    assert [dx0_fields(F) for F in (1, 8, 39, 40, 41, 200, 201, 384)] == [
        40, 40, 40, 40, 200, 200, 200, 200]


# -- meta: the work counted, nothing launched -------------------------------
@pytest.mark.parametrize("dtype,item", [(torch.float32, 4),
                                        (torch.bfloat16, 2)])
def test_meta_counts_each_kernels_work(dtype, item):
    """On meta each wrapper returns its output's shape and counts 2 · B ·
    H · Hp · F · D FLOP and ``cin_bwd_work``'s bytes under its own name,
    and launches nothing."""
    B, Hp, F, H, D = 37, 200, 39, 200, 10
    g = torch.empty(B, H, D, device="meta", dtype=dtype)
    xk = torch.empty(B, Hp, D, device="meta", dtype=dtype)
    x0 = torch.empty(B, F, D, device="meta", dtype=dtype)
    w = torch.empty(H, Hp, F, device="meta", dtype=dtype)
    launches = _build.launch_counts()
    _build.reset_kernel_work()
    dw = cin_weight_grad(g, xk, x0)
    dx0 = cin_dx0(g, xk, w)
    assert dw.shape == (H, Hp, F) and dw.dtype == torch.float32
    assert dx0.shape == (B, F, D) and dx0.dtype == dtype
    assert dw.device.type == dx0.device.type == "meta"
    work = _build.kernel_work()
    for name, which in (("cin_dw", "dw"), ("cin_dx0", "dx0")):
        nbytes, ops = cin_bwd_work(which, B, H, Hp, F, D, item)
        assert ops == 2 * B * H * Hp * F * D
        assert work[name] == {"flops": ops, "bytes": nbytes}
    assert work["cin"] == {"flops": 0, "bytes": 0}
    assert _build.launch_counts() == launches


@pytest.mark.parametrize("H", [200, 37])
def test_dx0_takes_every_field_count_the_forward_takes(H):
    """Up to the forward's ``max_fields(H)`` (248 at H = 200, 384 on the
    width of 64), layer 0's shape (Hp = F) included: on meta dx0 plans
    its field blocks, returns its shape and counts its work."""
    B, D = 3, 10
    for F in (201, cin_mod.max_fields(H)):
        meta = {"device": "meta"}
        _build.reset_kernel_work()
        dx0 = cin_dx0(torch.empty((B, H, D), **meta),
                      torch.empty((B, F, D), **meta),
                      torch.empty((H, F, F), **meta))
        assert dx0.shape == (B, F, D)
        assert _build.kernel_work()["cin_dx0"]["flops"] == \
            2 * B * H * F * F * D


def test_wrappers_refuse_what_the_kernels_do_not_take():
    g, xk = torch.zeros((2, 5, 3)), torch.zeros((2, 4, 3))
    with pytest.raises(ValueError, match="chain"):
        cin_weight_grad(g, xk, torch.zeros((3, 6, 3)))
    with pytest.raises(ValueError, match="chain"):
        cin_dx0(g, xk, torch.zeros((5, 3, 6)))
    with pytest.raises(ValueError, match="dtypes"):
        cin_dx0(g, xk, torch.zeros((5, 4, 6), dtype=torch.float64))
    meta = {"device": "meta"}
    with pytest.raises(ValueError, match="f32 or bf16"):
        cin_weight_grad(*(torch.empty(s, dtype=torch.float16, **meta)
                          for s in ((2, 5, 3), (2, 4, 3), (2, 6, 3))))
