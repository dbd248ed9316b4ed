"""The port's ``solve`` against the JAX package's ``repro.api.solve``.

BFS, PageRank and Δ-stepping SSSP under every policy, with the port's
backends paired to the reference's: dense↔dense, ell↔ell and
cuda↔pallas (on the CPU the port's CUDA backend runs each kernel's plain
version; the reference's Pallas backend runs its kernels in interpret
mode). The port's graph carries the reference graph's arrays across.

Integer and min/max state must match bit for bit, float sums to
rtol = atol = 1e-5; the §4 Cost counters, steps, push steps, epochs,
the converged flag and every StepTrace row must be exactly equal.
"""

import jax
import numpy as np
import pytest
import torch

from repro import api as ref_api
from repro.core import PallasBackend
from repro.graphs import erdos_renyi as ref_erdos_renyi
from repro_torch import api
from repro_torch.core import CudaBackend
from repro_torch.graphs import GRAPH_ARRAYS, graph_from_arrays
from repro_torch.kernels import tune

ALGS = {"bfs": {"root": 3}, "pagerank": {"iters": 6},
        "sssp_delta": {"source": 3, "delta": 2.5}}
POLICIES = ("push", "pull", "gs", "grs", "auto")
BACKENDS = ("dense", "ell", "cuda")
TRACE = 32


@pytest.fixture(scope="module")
def pair():
    g = ref_erdos_renyi(160, 4.0, seed=11, weighted=True)
    tg = graph_from_arrays({f: np.asarray(getattr(g, f))
                            for f in GRAPH_ARRAYS},
                           n=g.n, m=g.m, d_ell=g.d_ell, device="cpu")
    return g, tg


def ref_backend(name: str):
    if name != "cuda":
        return name
    # pinned blocks: no tuner probe, no tuner cache file
    return PallasBackend(autotune=False, block_n=64, block_e=128,
                         push_block_n=64, push_strategy="scan")


def port_cuda_backend() -> CudaBackend:
    """The port's side pinned the same way (no probe, no cache file)."""
    return CudaBackend(autotune=False, block_n=64, block_e=128,
                       push_block_n=64, push_strategy="scan")


def assert_states(got, want):
    want_leaves = jax.tree_util.tree_leaves(want)
    got_leaves = ([got[k] for k in sorted(got)] if isinstance(got, dict)
                  else [got])
    assert len(got_leaves) == len(want_leaves)
    for a, b in zip(got_leaves, want_leaves):
        a, b = a.numpy(), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("alg", sorted(ALGS))
def test_solve_matches_reference(pair, alg, policy, backend):
    g, tg = pair
    kw = ALGS[alg]
    want = ref_api.solve(g, alg, policy=policy,
                         backend=ref_backend(backend), trace=TRACE, **kw)
    port_backend = port_cuda_backend() if backend == "cuda" else backend
    got = api.solve(tg, alg, policy=policy, backend=port_backend,
                    trace=TRACE, **kw)
    assert_states(got.state, want.state)
    assert got.cost.as_dict() == want.cost.as_dict()
    assert (got.steps, got.push_steps, got.epochs, got.converged) == (
        int(want.steps), int(want.push_steps), int(want.epochs),
        bool(want.converged))
    steps = int(want.steps)
    assert got.trace.as_dict(steps) == want.trace.as_dict(steps)
    if backend == "cuda":
        s = port_backend.stats
        assert s["fallback_pull"] == s["fallback_push"] == 0
        assert s["kernel_pull"] + s["kernel_pull_frontier"] \
            + s["kernel_push"] > 0


def test_cuda_backend_reaches_all_three_kernel_paths(pair):
    """Over the slice, the CUDA backend dispatches the full scan, the
    frontier pull, the binned push and the empty-set skip."""
    _, tg = pair
    be = port_cuda_backend()
    for alg, kw in ALGS.items():
        for policy in ("push", "pull"):
            api.solve(tg, alg, policy=policy, backend=be, **kw)
    s = be.stats
    assert s["kernel_pull"] > 0 and s["kernel_pull_frontier"] > 0
    assert s["kernel_push"] > 0
    assert s["fallback_pull"] == s["fallback_push"] == 0


def test_unsupported_cells_fall_back_and_are_counted(pair):
    """A msg_fn outside copy/mul/add runs the plain ELL-backend path (the
    reference's coverage fallback), with its result, and is counted."""
    _, tg = pair
    be, ell = port_cuda_backend(), api.EllBackend()
    values = torch.linspace(0.0, 1.0, tg.n)
    frontier = torch.ones(tg.n, dtype=torch.bool)
    for direction, fn in ((api.Direction.PULL, lambda x, w: x * w * 2),
                          (api.Direction.PUSH,
                           lambda x, w: torch.clamp(x + w, max=3.0))):
        got, _ = be.relax(tg, values, frontier, direction=direction,
                          combine="sum", msg_fn=fn)
        want, _ = ell.relax(tg, values, frontier, direction=direction,
                            combine="sum", msg_fn=fn)
        torch.testing.assert_close(got, want)
    assert be.stats["fallback_pull"] == be.stats["fallback_push"] == 1
    assert be.stats["kernel_pull"] == be.stats["kernel_push"] == 0


def test_solve_rejects_bad_inputs(pair):
    _, tg = pair
    with pytest.raises(ValueError, match="out of range"):
        api.solve(tg, "bfs", root=tg.n)
    with pytest.raises(ValueError, match="unknown backend"):
        api.solve(tg, "bfs", root=0, backend="pallas")
    with pytest.raises(ValueError, match="unknown policy"):
        api.solve(tg, "bfs", root=0, policy="sideways")
    with pytest.raises(KeyError, match="unknown algorithm"):
        api.solve(tg, "not_an_algorithm")


CAPS = (8, 72)     # below and above default_pull_cap (40 on this graph)


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("policy", ("pull", "auto"))
@pytest.mark.parametrize("alg", ("bfs", "sssp_delta"))
def test_pinned_pull_frontier_cap_matches_reference(pair, alg, policy, cap):
    """A pinned frontier-pull capacity decides which pulls take the
    frontier kernel and what they charge, in both packages alike: state,
    Cost, steps and every StepTrace row exactly equal."""
    g, tg = pair
    kw = ALGS[alg]
    want = ref_api.solve(g, alg, policy=policy, backend=PallasBackend(
        autotune=False, block_n=64, block_e=128, push_block_n=64,
        push_strategy="scan", pull_frontier_cap=cap), trace=TRACE, **kw)
    be = CudaBackend(autotune=False, block_n=64, block_e=128,
                     push_block_n=64, push_strategy="scan",
                     pull_frontier_cap=cap)
    got = api.solve(tg, alg, policy=policy, backend=be, trace=TRACE, **kw)
    assert_states(got.state, want.state)
    assert got.cost.as_dict() == want.cost.as_dict()
    assert (got.steps, got.push_steps, got.epochs, got.converged) == (
        int(want.steps), int(want.push_steps), int(want.epochs),
        bool(want.converged))
    steps = int(want.steps)
    assert got.trace.as_dict(steps) == want.trace.as_dict(steps)


@pytest.mark.parametrize("policy", ("pull", "auto"))
def test_pull_frontier_cap_moves_the_charge(pair, policy):
    """The pin is read: SSSP's touched sets of 9 to 40 rows take the
    frontier kernel under the default cap (40) and the full scan under a
    cap of 8, which charges more reads."""
    _, tg = pair
    reads, frontier = [], []
    for cap in (CAPS[0], None):
        be = CudaBackend(autotune=False, block_n=64, block_e=128,
                         push_block_n=64, push_strategy="scan",
                         pull_frontier_cap=cap)
        r = api.solve(tg, "sssp_delta", policy=policy, backend=be,
                      **ALGS["sssp_delta"])
        reads.append(int(r.cost.reads))
        frontier.append(be.stats["kernel_pull_frontier"])
    assert reads[0] > reads[1] and frontier[0] < frontier[1]


def test_tuned_mxu_float_sums_run_the_one_hot_push(pair, monkeypatch):
    """The tuner's pick runs as tuned for every payload, float sums
    included, as ``PallasBackend`` runs it: a tuned "mxu" float sum runs
    the one-hot push. A pinned strategy overrides the tuned one, and a
    pinned "mxu" runs as pinned."""
    _, tg = pair
    asked = []

    def fake_tune_push(n, m, width, dtype, combine, msg, device):
        asked.append((dtype, combine, msg))
        return 256, 64, "mxu"
    monkeypatch.setattr(tune, "tune_push", fake_tune_push)
    be = CudaBackend()
    f32 = torch.zeros(tg.n, dtype=torch.float32)
    i32 = torch.zeros(tg.n, dtype=torch.int32)
    assert be.push_blocks(tg, f32, "sum", "copy") == (256, 64, "mxu")
    assert be.push_blocks(tg, f32.double(), "sum", "mul") == (256, 64,
                                                              "mxu")
    assert be.push_blocks(tg, f32, "min", "add") == (256, 64, "mxu")
    assert be.push_blocks(tg, i32, "sum", "copy") == (256, 64, "mxu")
    assert be.push_blocks(tg, f32, "sum", "copy") == (256, 64, "mxu")
    assert asked == [(torch.float32, "sum", "copy"),
                     (torch.float64, "sum", "mul"),
                     (torch.float32, "min", "add"),
                     (torch.int32, "sum", "copy")]
    assert CudaBackend(push_strategy="scan").push_blocks(
        tg, f32, "sum", "copy") == (256, 64, "scan")
    assert CudaBackend(push_strategy="mxu").push_blocks(
        tg, f32, "sum", "copy") == (256, 64, "mxu")
