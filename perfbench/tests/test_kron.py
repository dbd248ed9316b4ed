"""GAP's Kronecker graph (``generators/kron.py``) and its configuration.

CPU tests, run from the repository root with the harness's:

    python -m pytest -q perfbench/tests

The generator's contract, its skew, the tiny stand-in's layout (the row
layout: no dense ELL), and PPR on it against the plain reference. The
test marked ``cuda`` holds the configuration's ``measured`` sizes to the
card's generator.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench import harness

CONFIG = harness.load_json("configs", "gap-kron-s21")


def _kron(**args):
    return harness.load_module("generators", "kron").generate(**args)


def test_kron_is_seeded_symmetric_sorted_and_simple():
    e = _kron(scale=9, degree=16, seed=3)
    n, src, dst = e["n"], e["src"], e["dst"]
    assert n == 512 and e["w"] is None
    assert (src != dst).all()
    key = dst * n + src
    assert (np.diff(key) > 0).all()          # sorted, no duplicate pair
    assert np.array_equal(np.sort(src * n + dst), key)   # symmetric
    assert 0 < len(src) <= 2 * 16 * n
    again = _kron(scale=9, degree=16, seed=3)
    assert np.array_equal(again["src"], src)
    assert np.array_equal(again["dst"], dst)
    other = _kron(scale=9, degree=16, seed=4)
    assert not np.array_equal(other["src"][:100], src[:100])


def test_kron_is_skewed():
    e = _kron(scale=12, degree=16, seed=0)
    deg = np.bincount(e["dst"], minlength=e["n"])
    assert deg.max() > 20 * deg.mean()
    uniform = harness.load_module("generators", "urand").generate(
        scale=12, degree=16, seed=0)
    assert deg.max() > 10 * np.bincount(uniform["dst"]).max()


def test_the_tiny_stand_in_gets_the_row_layout():
    from repro_torch.graphs import build_graph
    tiny = CONFIG["tiny"]
    e = harness.load_module("generators", tiny["generator"]).generate(
        **tiny["generator_args"])
    g = build_graph(e["src"], e["dst"], n=e["n"], weights=e["w"],
                    device="cpu")
    assert g.pull_layout == "rows" and not g._dense
    assert "d_ell" not in CONFIG


@pytest.mark.parametrize("backend", ("dense", "cuda"))
def test_ppr_on_kron_matches_the_reference(backend):
    from repro_torch import api
    from repro_torch.graphs import build_graph
    e = _kron(scale=9, degree=16, seed=1)
    g = build_graph(e["src"], e["dst"], n=e["n"], weights=e["w"],
                    device="cpu")
    assert g.pull_layout == "rows"
    params = {"damp": 0.85, "tol": 1e-6, "iters": 100}
    src = [int(s) for s in np.unique(e["src"])[[0, 7, 33, 101]]]
    ref = harness.load_module("reference", "ppr")
    truth = ref.solve(harness.reference_edges(e, torch.device("cpu")), src,
                      params)
    br = api.solve_batch(g, "ppr", sources=src, backend=backend, **params)
    got = [s["ranks"] for s in br.states]
    assert ref.readings(got, truth)["rank_gap"] < 1e-5
    assert not g._dense or backend == "dense"


def _run(**kw) -> harness.Run:
    return harness.Run(workload="w", config={}, traffic={"width": 256},
                       seed=0, seconds=1.0, n=1000, m=30000, **kw)


def test_the_counter_shares_read_none_without_their_counters():
    rows = harness.load_module("metrics", "backend.row_layout_share.kron")
    hubs = harness.load_module("metrics", "backend.hub_slot_share.kron")
    # a program without the counters, as the parent is
    assert rows.read(_run(backend_stats={"kernel_pull": 8})) is None
    assert hubs.read(_run(backend_stats={"pull_edges": 80})) is None
    assert rows.read(_run(backend_stats={"kernel_pull": 6,
                                         "kernel_pull_frontier": 2,
                                         "row_layout_pulls": 8})) == 100.0
    assert hubs.read(_run(backend_stats={"pull_edges": 80,
                                         "hub_slots": 20})) == 25.0


def test_the_roofline_reads_only_the_full_width_pulls():
    """The fused narrow steps' launches (``PprStep``) are left out: the
    share prices each launch it counts at the traffic's width."""
    from perfbench import yardstick
    from perfbench.spans import TraceSummary
    read = harness.load_module("metrics",
                               "kernel.ell_spmv_roofline.kron").read
    assert read(_run()) is None
    name = "rk::ell_spmv_kernel<float, float, float, 0, 0, rk::{}, true>"
    wide, fused = name.format("StoreRows"), name.format("PprStep")

    def trace(kernels):
        return TraceSummary(window_s=1.0, busy_s=0.5, kernels=kernels,
                            device_ops=[], idle_gaps=[])
    assert read(_run(trace=trace({fused: [0.5, 40]}))) is None
    got = read(_run(trace=trace({wide: [0.25, 10], fused: [0.5, 40]})))
    want = yardstick.bytes_share(
        10 * yardstick.ell_spmv_min_bytes(1000, 30000, 256), 0.25)
    assert got == pytest.approx(want)


@pytest.mark.cuda
def test_measured_sizes_are_the_cards():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    e = harness.load_module("generators", CONFIG["generator"]).generate(
        **CONFIG["generator_args"], device="cuda")
    n = e["n"]
    assert n == CONFIG["n"]
    indeg = np.bincount(e["dst"], minlength=n)
    outdeg = np.bincount(e["src"], minlength=n)
    m = int(indeg.sum())
    got = {"directed_edges": m, "max_in_degree": int(indeg.max()),
           "isolated_vertices": int(((indeg == 0) & (outdeg == 0)).sum()),
           "slot_share_rows_over_32": round(
               float(indeg[indeg > 32].sum() / m), 4),
           "d_ell": -(-int(indeg.max()) // 8) * 8}
    assert got == CONFIG["measured"]
