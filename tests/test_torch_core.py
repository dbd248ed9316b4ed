"""The port's core pieces against the JAX package's, on equal inputs:
segment ops, the relaxation primitives (values and §4 counters), the
cost predictor, the direction policies and msg_fn classification.

Integer and min/max results bit for bit, float sums to rtol = atol =
1e-5, counters and decisions exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import cost_model as ref_cm
from repro.core import direction as ref_dir
from repro.core import primitives as ref_prim
from repro.core.backend import classify_msg_fn as ref_classify
from repro.graphs import generators as ref_gen
from repro.graphs.structure import Graph as RefGraph
from repro.sparse import segment as ref_seg
from repro_torch.core import cost_model as cm
from repro_torch.core import direction as dr
from repro_torch.core import primitives as prim
from repro_torch.core.backend import classify_msg_fn
from repro_torch.graphs import GRAPH_ARRAYS, graph_from_arrays
from repro_torch.sparse import segment as seg


def same(got: torch.Tensor, want, float_sum: bool = False):
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    if float_sum and got.dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def pair():
    g = ref_gen.kronecker(7, 6, seed=4, weighted=True)
    tg = graph_from_arrays({f: np.asarray(getattr(g, f))
                            for f in GRAPH_ARRAYS},
                           n=g.n, m=g.m, d_ell=g.d_ell, device="cpu")
    return g, tg


@pytest.mark.parametrize("dtype", ("float32", "float64", "int32", "int64"))
@pytest.mark.parametrize("combine", ("sum", "min", "max"))
@pytest.mark.parametrize("width", (None, 3))
def test_segment_ops_match(dtype, combine, width):
    rng = np.random.default_rng(1)
    shape = (40,) if width is None else (40, width)
    data = (rng.normal(size=shape) if dtype.startswith("float")
            else rng.integers(-9, 9, size=shape)).astype(dtype)
    ids = rng.integers(-2, 12, size=40).astype(np.int32)  # some dropped,
    fn = {"sum": "segment_sum", "min": "segment_min",     # some empty
          "max": "segment_max"}[combine]
    got = getattr(seg, fn)(torch.from_numpy(data), torch.from_numpy(ids), 14)
    want = getattr(ref_seg, fn)(jnp.asarray(data), jnp.asarray(ids), 14)
    same(got, want, float_sum=combine == "sum")


MSG_FNS = {"none": None, "mul": lambda x, w: x * w,
           "add": lambda x, w: x + w}


@pytest.mark.parametrize("msg", sorted(MSG_FNS))
@pytest.mark.parametrize("combine", ("sum", "min", "max"))
@pytest.mark.parametrize("dtype", ("float32", "int32"))
def test_relaxation_primitives_match(pair, msg, combine, dtype):
    g, tg = pair
    rng = np.random.default_rng(2)
    x = (rng.normal(size=g.n) if dtype == "float32"
         else rng.integers(0, 50, size=g.n)).astype(dtype)
    frontier = rng.random(g.n) < 0.3
    touched = rng.random(g.n) < 0.5
    fn = MSG_FNS[msg]
    xt, ft, tt = (torch.from_numpy(a) for a in (x, frontier, touched))
    xj = jnp.asarray(x)
    pairs = [
        (prim.push_relax(tg, xt, ft, combine=combine, msg_fn=fn),
         ref_prim.push_relax(g, xj, jnp.asarray(frontier), combine=combine,
                             msg_fn=fn)),
        (prim.pull_relax(tg, xt, None, combine=combine, msg_fn=fn),
         ref_prim.pull_relax(g, xj, None, combine=combine, msg_fn=fn)),
        (prim.pull_relax(tg, xt, tt, combine=combine, msg_fn=fn),
         ref_prim.pull_relax(g, xj, jnp.asarray(touched), combine=combine,
                             msg_fn=fn)),
        (prim.pull_relax_ell(tg, xt, combine=combine, msg_fn=fn),
         ref_prim.pull_relax_ell(g, xj, combine=combine, msg_fn=fn)),
        (prim.k_filter(ft, cm.Cost.zeros()),
         ref_prim.k_filter(jnp.asarray(frontier), ref_cm.Cost())),
    ]
    for (out, cost), (ref_out, ref_cost) in pairs:
        same(out, ref_out, float_sum=combine == "sum")
        assert cost.as_dict() == ref_cost.as_dict()


def stats_pair(**kw):
    """Equal StepStats for both packages (int64 counters)."""
    counters = ("frontier_vertices", "frontier_edges", "pull_edges",
                "pull_vertices", "unvisited_edges", "push_wire_bytes",
                "pull_wire_bytes", "pull_touched_edges")
    mine = {k: (torch.tensor(v, dtype=torch.int64) if k in counters else v)
            for k, v in kw.items()}
    ref = {k: (jnp.asarray(v, jnp.int64) if k in counters else v)
           for k, v in kw.items()}
    return cm.StepStats(**mine), ref_cm.StepStats(**ref)


BIG = (1 << 40) + 7


@pytest.mark.parametrize("float_data", (True, False))
@pytest.mark.parametrize("kfp", (True, False))
@pytest.mark.parametrize("width", (1, 4))
def test_cost_predictor_matches(float_data, kfp, width):
    mine, ref = stats_pair(frontier_vertices=BIG // 3, frontier_edges=BIG,
                           pull_edges=BIG + 11, pull_vertices=12345,
                           unvisited_edges=BIG, step=3, prev_push=True,
                           float_data=float_data, k_filter_push=kfp,
                           width=width, push_wire_bytes=0,
                           pull_wire_bytes=0, pull_touched_edges=BIG)
    p, rp = cm.CostPredictor(), ref_cm.CostPredictor()
    for a, b in ((p.predict_push(mine), rp.predict_push(ref)),
                 (p.predict_pull(mine), rp.predict_pull(ref))):
        assert a.dtype == torch.float64 and float(a) == float(b)
    c = cm.Cost.zeros().charge(reads=BIG, writes=3, atomics=5, locks=7)
    rc = ref_cm.Cost().charge(reads=BIG, writes=3, atomics=5, locks=7)
    assert float(c.weighted_total()) == float(rc.weighted_total())


def one_hub_graphs(out_deg0: int, m: int):
    """Two-vertex graphs whose vertex 0 has out-degree ``out_deg0``: the
    policies read only degrees, so no edge list is needed."""
    arrays = {f: np.zeros(1 if f.startswith(("coo", "push")) else 3,
                          np.int32) for f in GRAPH_ARRAYS}
    arrays.update(coo_w=np.zeros(1, np.float32),
                  push_w=np.zeros(1, np.float32),
                  ell_idx=np.zeros((2, 8), np.int32),
                  ell_w=np.zeros((2, 8), np.float32),
                  in_deg=np.zeros(2, np.int32),
                  out_deg=np.array([out_deg0, 0], np.int32))
    tg = graph_from_arrays(arrays, n=2, m=m, d_ell=8, device="cpu")
    g = RefGraph(**{f: jnp.asarray(a) for f, a in arrays.items()}, n=2, m=m,
                 d_ell=8)
    return tg, g


@pytest.mark.parametrize("unvisited_delta", (-1, 0, 1))
def test_generic_switch_decides_in_float64(unvisited_delta):
    """mf·alpha against the unvisited count at mf = 2**24 + 1, where a
    float32 product would round and flip the decision."""
    mf = (1 << 24) + 1
    tg, g = one_hub_graphs(mf, m=10)
    unv = 14 * mf + unvisited_delta
    frontier = np.array([True, False])
    for policy, ref_policy in ((dr.GenericSwitch(), ref_dir.GenericSwitch()),
                               (dr.GreedySwitch(), ref_dir.GreedySwitch())):
        got = policy.decide_push(tg, torch.from_numpy(frontier),
                                 torch.tensor(unv, dtype=torch.int64))
        want = ref_policy.decide_push(g, jnp.asarray(frontier),
                                      jnp.asarray(unv, jnp.int64))
        assert bool(got) == bool(want) == (unvisited_delta > 0)


@pytest.mark.parametrize("prev_push", (True, False))
@pytest.mark.parametrize("step", (0, 5))
@pytest.mark.parametrize("ratio", (0.95, 1.05, 1.2))
def test_auto_switch_hysteresis_matches(prev_push, step, ratio):
    k = 1_000_003
    pull_edges = int(k * 6 * ratio)       # push price is 6k (float data)
    mine, ref = stats_pair(frontier_vertices=10, frontier_edges=k,
                           pull_edges=pull_edges, pull_vertices=0,
                           unvisited_edges=0, step=step,
                           prev_push=prev_push, float_data=True)
    tg, g = one_hub_graphs(1, m=10)
    got = dr.AutoSwitch().decide(tg, None, mine)
    want = ref_dir.AutoSwitch().decide(g, None, ref)
    assert bool(got) == bool(want)


def test_classify_msg_fn_matches():
    for fn in (None, lambda x, w: x * w, lambda x, w: w * x,
               lambda x, w: x + w, lambda x, w: x, lambda x, w: x * w * 2,
               lambda x, w: x - w, lambda x, w: x * 0 + 1):
        assert classify_msg_fn(fn) == ref_classify(fn)
    clamp_t = lambda x, w: torch.clamp(x + w, max=3.0)     # noqa: E731
    clamp_j = lambda x, w: jnp.minimum(x + w, 3.0)         # noqa: E731
    assert classify_msg_fn(clamp_t) is None is ref_classify(clamp_j)
