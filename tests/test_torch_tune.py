"""The port's autotuner against the JAX package's ``kernels/tune.py``.

  * the three candidate functions return the reference's tuples over a
    grid of (n, m, rows, width);
  * the disk cache (``$REPRO_CACHE_DIR/tune_torch.json``, keys
    ``cpu|...`` for CPU tensors) round-trips, a poisoned entry is
    re-probed, and a garbage file degrades to the memory tier;
  * push group pruning and the pull ladder's stop, on injected timings;
  * the CUDA backend takes its blocks from the tuner, probed on the
    graph's own layout, and a partial pin overrides only its own part.

Every test points ``$REPRO_CACHE_DIR`` at ``tmp_path``.
"""

import json

import pytest
import torch

from repro.kernels import tune as ref_tune
from repro_torch import api
from repro_torch.core import CudaBackend
from repro_torch.graphs import erdos_renyi
from repro_torch.kernels import tune

SHAPES = [(n, m) for n in (1, 8, 100, 1000, 1 << 16, 1_960_000)
          for m in (0, 7, 400, 1_818_572, 8_030_000)]


@pytest.fixture
def cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))
    tune.clear_memory_cache()
    tune.clear_stats()
    yield tmp_path
    tune.clear_memory_cache()


@pytest.mark.parametrize("n,m", SHAPES)
def test_candidates_match_reference(n, m):
    assert tune.push_candidates(n, m) == ref_tune.push_candidates(n, m)
    for width in (None, 1, 3):
        assert tune.pull_candidates(n, width) == \
            ref_tune.pull_candidates(n, width)
    for rows in (1, 8, 64, 1000, 524_288):
        assert tune.pull_frontier_candidates(n, rows) == \
            ref_tune.pull_frontier_candidates(n, rows)


def test_cache_round_trip(cache):
    best = tune.tune_push(150, 600, 3, torch.float32, "sum", "copy", "cpu")
    assert best in tune.push_candidates(150, 600)
    disk = json.loads((cache / "tune_torch.json").read_text())
    assert disk == {"cpu|push.r4|150x600|w3|float32|sum|copy": list(best)}
    blk = tune.tune_pull(300, 6, 4, torch.int32, "min", "copy", "cpu")
    assert blk in tune.pull_candidates(300, 4)
    assert tune.tune_stats()["probes"] == 2
    tune.clear_memory_cache()            # a new process: disk tier only
    assert tune.tune_push(150, 600, 3, torch.float32, "sum", "copy",
                          "cpu") == best
    assert tune.tune_pull(300, 6, 4, torch.int32, "min", "copy",
                          "cpu") == blk
    st = tune.tune_stats()
    assert st["probes"] == 2 and st["disk_hits"] == 2
    assert tune.tune_pull(300, 6, 4, torch.int32, "min", "copy",
                          "cpu") == blk
    assert tune.tune_stats()["mem_hits"] == 1


def test_poisoned_entry_is_reprobed(cache):
    key = (f"cpu|pullf.r{tune.KERNEL_REVISIONS['pullf']}|300x6x512|w1|"
           "float32|sum|copy")
    (cache / "tune_torch.json").write_text(json.dumps({key: "garbage"}))
    blk = tune.tune_pull_frontier(300, 6, 512, 1, torch.float32, "sum",
                                  "copy", "cpu")
    assert blk in tune.pull_frontier_candidates(300, 512)
    assert tune.tune_stats()["probes"] == 1
    assert json.loads((cache / "tune_torch.json").read_text())[key] == blk


def test_garbage_cache_file_degrades_to_memory(cache):
    (cache / "tune_torch.json").write_text("{not json")
    best = tune.tune_push(120, 300, 1, torch.int32, "min", "copy", "cpu")
    assert json.loads((cache / "tune_torch.json").read_text()) == {
        "cpu|push.r4|120x300|w1|int32|min|copy": list(best)}


def test_push_group_pruning(cache, monkeypatch):
    """A group whose first rung is ≥ 2× behind the incumbent is dropped
    untimed; the others are timed in full."""
    cands = tune.push_candidates(200, 5000)
    slow = {c for c in cands if c[1] == 200}     # the whole-range bins
    timed = []

    def fake_time(fn, device):
        fn()
        return 10.0 if timed[-1] in slow else 1.0 + 0.001 * len(timed)

    real_push = tune.coo_push

    def spy(*a, **kw):
        plan = kw["plan"]
        timed.append((kw["block_e"], plan.bin_n, kw["strategy"]))
        return real_push(*a, **kw)

    monkeypatch.setattr(tune, "_time", fake_time)
    monkeypatch.setattr(tune, "coo_push", spy)
    best = tune.tune_push(200, 5000, 1, torch.float32, "sum", "copy", "cpu")
    assert best == cands[0]
    groups = {(s, b) for _, b, s in slow}
    # one rung of each slow group was timed, none of the rest
    assert sorted(t for t in timed if t in slow) == sorted(
        min((c for c in cands if (c[2], c[1]) == gr), key=cands.index)
        for gr in groups)
    assert set(cands) - slow <= set(timed)
    rec = tune.probe_records()[-1]
    assert rec["pruned"] == len(groups) and rec["timed"] == len(timed)


def test_pull_ladder_stops_at_a_slow_rung(cache, monkeypatch):
    times = iter([1.0, 0.5, 0.9, 9.0, 0.1, 0.1])
    monkeypatch.setattr(tune, "_time", lambda fn, device: next(times))
    cands = tune.pull_candidates(5000, 2)
    assert tune.tune_pull(5000, 4, 2, torch.float32, "sum", "copy",
                          "cpu") == cands[1]
    rec = tune.probe_records()[-1]
    assert rec["timed"] == 4 and rec["pruned"] == len(cands) - 4


def test_pulls_are_probed_on_the_graphs_own_layout(cache, monkeypatch):
    """On a random layout of the graph's shape the pull's rungs can tie
    where the graph's own rows set them apart, so the backend probes
    both pulls on the graph's layout and in-degrees."""
    g = erdos_renyi(600, 4.0, seed=4, device="cpu")
    seen = []
    for name in ("ell_spmv", "ell_pull_frontier"):
        real = getattr(tune, name)

        def record(x, idx, *a, _real=real, _name=name, **k):
            seen.append((_name, idx is g.ell_idx))
            return _real(x, idx, *a, **k)
        monkeypatch.setattr(tune, name, record)
    be = CudaBackend(pull_frontier_cap=1 << 20)
    api.solve_batch(g, "ppr", sources=[0, 5], backend=be)
    api.solve(g, "bfs", root=1, policy="pull", backend=be)
    assert {k[0] for k in be._tuned} >= {"pull", "pullf"}
    assert ("ell_spmv", True) in seen and ("ell_spmv", False) not in seen
    assert ("ell_pull_frontier", True) in seen
    # without a layout the probe still times a random one of the shape
    seen.clear()
    tune.tune_pull(300, 6, 4, torch.float32, "sum", "copy", "cpu")
    assert seen and not any(own for _, own in seen)


def test_backend_takes_the_tuner_and_partial_pins(cache):
    g = erdos_renyi(140, 4.0, seed=2, weighted=True, device="cpu")
    be = CudaBackend(push_strategy="mxu")
    api.solve(g, "sssp_delta", source=1, policy="push", backend=be)
    api.solve(g, "bfs", root=1, policy="pull", backend=be)
    assert {k[0] for k in be._tuned} >= {"push", "pull", "pullf"}
    x = torch.zeros((g.n,), dtype=torch.float32)
    be_e, bn, strat = be.push_blocks(g, x, "min", "add")
    tuned = be._tuned[("push", g.n, g.m, 1, torch.float32, "min", "add")]
    assert (be_e, bn, strat) == (tuned[0], tuned[1], "mxu")
    pinned = CudaBackend(autotune=False, block_e=64)
    assert pinned.push_blocks(g, x, "min", "add") == (
        64,) + tune.push_candidates(g.n, g.m)[0][1:]
    probes = tune.tune_stats()["probes"]
    disk = json.loads((cache / "tune_torch.json").read_text())
    assert len(disk) == probes >= 1
    assert all(k.startswith("cpu|") for k in disk)


def test_cuda_keys_name_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_capability",
                        lambda device=None: (9, 0))
    key = tune._cache_key("push", torch.device("cuda"), (5, 7), 16,
                          torch.float32, "sum", "copy")
    assert key == "cuda-sm90|push.r4|5x7|w16|float32|sum|copy"
    assert tune._cache_key("pull", torch.device("cpu"), (1,), 1,
                           torch.int64, "min", "add") == \
        "cpu|pull.r2|1|w1|int64|min|add"


@pytest.mark.parametrize("kernel", ("pull", "push", "pullf"))
def test_redesigned_kernels_do_not_reuse_old_winners(cache, kernel):
    """A winner cached under an earlier kernel revision's key (no
    revision tag) is not read: the probe runs again and writes the new
    revision's key beside it."""
    shape = {"pull": "300x6", "push": "300x900", "pullf": "300x6x512"}
    old = f"cpu|{kernel}|{shape[kernel]}|w1|float32|sum|copy"
    stale = [16384, 300, "mxu"] if kernel == "push" else 4096
    (cache / "tune_torch.json").write_text(json.dumps({old: stale}))
    if kernel == "pull":
        got = tune.tune_pull(300, 6, 1, torch.float32, "sum", "copy", "cpu")
    elif kernel == "pullf":
        got = tune.tune_pull_frontier(300, 6, 512, 1, torch.float32, "sum",
                                      "copy", "cpu")
    else:
        got = tune.tune_push(300, 900, 1, torch.float32, "sum", "copy",
                             "cpu")
    assert tune.tune_stats()["probes"] == 1
    disk = json.loads((cache / "tune_torch.json").read_text())
    new = old.replace(f"|{kernel}|",
                      f"|{kernel}.r{tune.KERNEL_REVISIONS[kernel]}|")
    assert disk[old] == stale and new in disk
    assert disk[new] == (list(got) if kernel == "push" else got)
