"""The port's graph substrate against the JAX package's.

For the same edge list, ``build_graph`` must give the same 12 views (the
same dtypes, shapes and values) and the same ``n``/``m``/``d_ell``; each
generator must give the same graph for the same seed; invalid input must
raise the same ``ValueError``; ``graph_from_arrays`` must carry a
reference graph across unchanged; and the dual ELL layout (whose out side
the port builds on first use) must hold the reference's arrays.
"""

import numpy as np
import pytest
import torch

from graph_strategies import CASES, build_case
from repro.graphs import generators as ref_gen
from repro.graphs.structure import build_graph as ref_build_graph
from repro.graphs.structure import pad_values as ref_pad_values
from repro.kernels.layout import build_dual_ell as ref_build_dual_ell
from repro.kernels.layout import touched_out_mask as ref_touched_out_mask
from repro_torch.graphs import (GRAPH_ARRAYS, STANDIN_SPECS, build_graph,
                                erdos_renyi, graph_from_arrays, kronecker,
                                pad_values, ring, road_grid, standin, star)
from repro_torch.kernels.layout import build_dual_ell, touched_out_mask


def assert_same_graph(tg, g):
    assert (tg.n, tg.m, tg.d_ell) == (g.n, g.m, g.d_ell)
    assert tg.device == torch.device("cpu")
    for f in GRAPH_ARRAYS:
        got, want = getattr(tg, f).numpy(), np.asarray(getattr(g, f))
        assert got.dtype == want.dtype and got.shape == want.shape, f
        np.testing.assert_array_equal(got, want, err_msg=f)


def carried(g):
    return graph_from_arrays({f: np.asarray(getattr(g, f))
                              for f in GRAPH_ARRAYS},
                             n=g.n, m=g.m, d_ell=g.d_ell, device="cpu")


def raw_edges(n: int, m: int, seed: int):
    """An unsorted edge list with duplicates and self loops."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, size=m)
    dst = rng.integers(0, n, size=m)
    return src, dst, rng.uniform(0.5, 3.0, size=m).astype(np.float32)


@pytest.mark.parametrize("n,m,seed,kw", [
    (50, 300, 0, {}),
    (50, 300, 1, {"pad_rows_to": 4}),
    (80, 90, 2, {"d_ell": 32}),
    (7, 0, 3, {}),
    (1, 3, 4, {}),
])
@pytest.mark.parametrize("weighted", (True, False))
def test_build_graph_views_match(n, m, seed, kw, weighted):
    src, dst, w = raw_edges(n, m, seed)
    if n == 1:
        src, dst = np.zeros(m, np.int64), np.zeros(m, np.int64)
    w = w if weighted else None
    assert_same_graph(build_graph(src, dst, n=n, weights=w, device="cpu",
                                  **kw),
                      ref_build_graph(src, dst, n=n, weights=w, **kw))


@pytest.mark.parametrize("case", CASES)
def test_adversarial_cases_carry_across(case):
    g = build_case(case, 0)
    assert_same_graph(carried(g), g)
    # rebuilt from its dst-sorted COO, by both packages
    edges = (np.asarray(g.coo_src), np.asarray(g.coo_dst))
    w = np.asarray(g.coo_w)
    assert_same_graph(build_graph(*edges, n=g.n, weights=w, device="cpu"),
                      ref_build_graph(*edges, n=g.n, weights=w))


@pytest.mark.parametrize("name,make,ref", [
    ("kronecker", lambda: kronecker(8, 8, seed=5, weighted=True,
                                    device="cpu"),
     lambda: ref_gen.kronecker(8, 8, seed=5, weighted=True)),
    ("kronecker_unweighted", lambda: kronecker(7, 4, seed=1, device="cpu"),
     lambda: ref_gen.kronecker(7, 4, seed=1)),
    ("erdos_renyi", lambda: erdos_renyi(200, 5.0, seed=3, weighted=True,
                                        device="cpu"),
     lambda: ref_gen.erdos_renyi(200, 5.0, seed=3, weighted=True)),
    ("road_grid", lambda: road_grid(15, seed=2, device="cpu"),
     lambda: ref_gen.road_grid(15, seed=2)),
    ("ring", lambda: ring(40, weighted=True, device="cpu"),
     lambda: ref_gen.ring(40, weighted=True)),
    ("star", lambda: star(30, device="cpu"), lambda: ref_gen.star(30)),
])
def test_generators_match_per_seed(name, make, ref):
    assert_same_graph(make(), ref())


@pytest.mark.parametrize("name", sorted(STANDIN_SPECS))
def test_standins_match(name):
    assert STANDIN_SPECS[name] == ref_gen.STANDIN_SPECS[name]
    assert_same_graph(standin(name, scale=1 / 8192, seed=1, weighted=True,
                              device="cpu"),
                      ref_gen.standin(name, scale=1 / 8192, seed=1,
                                      weighted=True))


@pytest.mark.parametrize("args,kw", [
    (([0, 1, 9], [1, 2, 0], 5), {}),
    (([0, 1], [1, -1], 5), {}),
    (([0, 1, 2], [1, 2], 5), {}),
    (([0, 1], [1, 2], 5), {"weights": [1.0, 2.0, 3.0]}),
    (([0, 1], [1, 2], 5), {"weights": [1.0, float("nan")]}),
    (([0, 1, 2], [1, 1, 1], 5), {"d_ell": 2}),
])
def test_same_value_errors(args, kw):
    with pytest.raises(ValueError) as want:
        ref_build_graph(*args, **kw)
    with pytest.raises(ValueError) as got:
        build_graph(*args, device="cpu", **kw)
    assert str(got.value) == str(want.value)


def test_graph_from_arrays_round_trips_and_checks_views():
    g = ref_gen.erdos_renyi(60, 3.0, seed=9, weighted=True)
    tg = carried(g)
    assert_same_graph(tg, g)
    back = carried(tg)
    assert_same_graph(back, g)
    arrays = {f: np.asarray(getattr(g, f)) for f in GRAPH_ARRAYS[:-1]}
    with pytest.raises(ValueError, match="out_deg"):
        graph_from_arrays(arrays, n=g.n, m=g.m, d_ell=g.d_ell, device="cpu")


@pytest.mark.parametrize("shape", [(9,), (9, 3)])
def test_pad_values_matches(shape):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    np.testing.assert_array_equal(pad_values(torch.from_numpy(x)).numpy(),
                                  np.asarray(ref_pad_values(x)))


@pytest.mark.parametrize("case", ["ragged", "empty_rows", "edgeless"])
def test_dual_layout_matches_and_builds_out_side_lazily(case):
    g = build_case(case, 1)
    tg = carried(g)
    ref = ref_build_dual_ell(g)
    lay = build_dual_ell(tg)
    assert lay._out == {}                    # nothing built yet
    assert lay.in_idx is tg.ell_idx and lay.d_in == ref.d_in
    np.testing.assert_array_equal(lay.out_idx.numpy(),
                                  np.asarray(ref.out_idx))
    np.testing.assert_array_equal(lay.out_w.numpy(), np.asarray(ref.out_w))
    assert lay.d_out == ref.d_out
    frontier = np.random.default_rng(2).random(g.n) < 0.2
    for cap in (None, 4):
        np.testing.assert_array_equal(
            touched_out_mask(lay, torch.from_numpy(frontier), cap).numpy(),
            np.asarray(ref_touched_out_mask(ref, frontier, cap)))
