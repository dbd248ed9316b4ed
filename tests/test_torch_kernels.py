"""The port's ELL pull kernels against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; the
reference kernels run in Pallas interpret mode. Both get the same numpy
payloads over combine × dtype × msg × payload rank, on two graphs:

  * ``union`` — the disjoint union of ``graph_strategies``' ragged (hub),
    empty-rows, self-loop and duplicate-edge cases, so one ELL shape
    carries every adversarial row kind and the interpreter compiles once
    per cell;
  * ``edgeless`` — m = 0 on the same [n, d_ell] shape.

Tolerances: integer results and every min/max bit for bit; float sums
rtol = atol = 1e-5 (the port sums in float64, the reference in the
payload's type). Output dtypes must be equal, including the int32 → int64
widening of pull sums.

The CUDA kernels themselves are held against these plain versions on
the card by ``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graph_strategies import CASES, build_case
from repro.graphs.structure import build_graph as ref_build_graph
from repro.kernels.ell_spmv import ell_spmv_pallas
from repro_torch.graphs import GRAPH_ARRAYS, graph_from_arrays
from repro_torch.graphs.structure import pad_values
from repro_torch.kernels import _build
from repro_torch.kernels.ell_pull_frontier import (default_pull_cap,
                                                   ell_pull_frontier)
from repro_torch.kernels.ell_spmv import ell_spmv, ell_spmv_plain

COMBINES = ("sum", "min", "max")
DTYPES = ("float32", "float64", "int32", "int64")
MSGS = ("copy", "mul", "add")
RANKS = (None, 3)
GRID = [(c, d, m, b) for c in COMBINES for d in DTYPES for m in MSGS
        for b in RANKS]
GRID_IDS = [f"{c}-{d}-{m}-{'b' + str(b) if b else 'vec'}"
            for c, d, m, b in GRID]
ROWS = 32          # static compacted-row capacity of the frontier tests


def union_graph():
    """Disjoint union of the four non-empty adversarial cases (n=24
    each), built by the reference."""
    parts = [build_case(c, 0) for c in CASES if c != "edgeless"]
    src, dst, w, off = [], [], [], 0
    for g in parts:
        src.append(np.asarray(g.coo_src) + off)
        dst.append(np.asarray(g.coo_dst) + off)
        w.append(np.asarray(g.coo_w))
        off += g.n
    return ref_build_graph(np.concatenate(src), np.concatenate(dst), n=off,
                           weights=np.concatenate(w))


@pytest.fixture(scope="module")
def graphs():
    u = union_graph()
    e = ref_build_graph(np.zeros(0, np.int64), np.zeros(0, np.int64),
                        n=u.n, d_ell=u.d_ell)
    out = {}
    for name, g in (("union", u), ("edgeless", e)):
        tg = graph_from_arrays({f: np.asarray(getattr(g, f))
                                for f in GRAPH_ARRAYS},
                               n=g.n, m=g.m, d_ell=g.d_ell, device="cpu")
        out[name] = (g, tg)
    return out


def payload(n: int, dtype: str, batch, seed: int = 7) -> np.ndarray:
    rng = np.random.default_rng(seed)
    shape = (n,) if batch is None else (n, batch)
    if dtype.startswith("float"):
        return rng.normal(size=shape).astype(dtype)
    return rng.integers(-50, 50, size=shape).astype(dtype)


def assert_same(got: torch.Tensor, want, combine: str):
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    if combine == "sum" and got.dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("combine,dtype,msg,batch", GRID, ids=GRID_IDS)
def test_ell_spmv_matches_pallas(graphs, combine, dtype, msg, batch):
    for g, tg in graphs.values():
        x = payload(g.n + 1, dtype, batch)
        x[-1] = 0                                  # the sentinel row
        want = ell_spmv_pallas(jnp.asarray(x), g.ell_idx, g.ell_w,
                               combine=combine, msg=msg, block_n=32,
                               interpret=True)
        got = ell_spmv(torch.from_numpy(x), tg.ell_idx, tg.ell_w,
                       combine=combine, msg=msg)
        assert_same(got, want, combine)


def test_num_sources_masks_indices_anywhere_in_a_row(graphs):
    """An index ≥ num_sources is the identity wherever it sits, not only
    in the padded tail (reference ``ell_spmv.py`` masks the whole row)."""
    g, tg = graphs["union"]
    x = payload(g.n + 1, "int64", None)
    ns = g.n // 2
    want = ell_spmv_pallas(jnp.asarray(x), g.ell_idx, g.ell_w,
                           combine="min", msg="copy", block_n=32,
                           interpret=True, num_sources=ns)
    got = ell_spmv(torch.from_numpy(x), tg.ell_idx, tg.ell_w,
                   combine="min", msg="copy", num_sources=ns)
    assert_same(got, want, "min")


def test_default_pull_cap_and_sentinel_rows():
    from repro.kernels.ell_pull_frontier import default_pull_cap as ref_cap
    for n, m, d in ((24, 96, 56), (1 << 16, 1_818_572, 9816),
                    (1_960_000, 8_030_000, 8), (5, 0, 8)):
        assert default_pull_cap(n, m, d) == ref_cap(n, m, d)
    # all-sentinel rows give the identity row
    x = torch.arange(5, dtype=torch.float32)
    idx = torch.zeros((4, 8), dtype=torch.int32)
    w = torch.ones((4, 8), dtype=torch.float32)
    rows = torch.full((3,), 4, dtype=torch.int32)
    out = ell_pull_frontier(x, idx, w, rows, combine="min", msg="copy")
    assert torch.isinf(out).all() and (out > 0).all()


def test_wrappers_take_the_plain_version_only_on_cpu(graphs):
    """A CPU tensor runs the plain version and launches nothing; a
    device the kernels do not serve raises instead of falling back."""
    _, tg = graphs["union"]
    before = _build.launch_counts()
    x = pad_values(torch.ones(tg.n))
    got = ell_spmv(x, tg.ell_idx, tg.ell_w, combine="sum", msg="mul")
    torch.testing.assert_close(got, ell_spmv_plain(x, tg.ell_idx, tg.ell_w,
                                                   "sum", "mul"))
    assert _build.launch_counts() == before
    with pytest.raises(ValueError, match="cuda or cpu"):
        ell_spmv(x.to("meta"), tg.ell_idx.to("meta"), tg.ell_w.to("meta"))

