"""CPU tests of what the benchmark reads of the program's own records
(``perfbench/ranges.py``): the reduction of a profile by the program's
``repro.*`` ranges on fake traces, the counter readers, and whole traced
runs of the cells at a small size that report the new counters.

    python -m pytest -q perfbench/tests
"""

from __future__ import annotations

import math

import pytest

from perfbench import harness, ranges, spans
from perfbench.tests.test_benchmark_harness import (BENCH, CELLS, TINY,
                                                    _Ev, _OldEv, _Prof,
                                                    _tiny_traffic)

MS = 1_000_000


def _trace(Ev) -> list:
    """A solve_batch span over the batch layer's range, an engine run of
    two steps, a pull inside the first (the program's ranges are host
    operations, as ``obs.trace.region`` records them); two kernels, a
    copy and the benchmark span's device-side mirror on the device."""
    return [
        Ev("user_annotation", "perfbench.window", 0, 100 * MS),
        Ev("user_annotation", "perfbench.solve_batch", 0, 90 * MS),
        Ev("cpu_op", "repro.batch.solve_batch", 0, 90 * MS),
        Ev("cpu_op", "repro.engine.run", 5 * MS, 75 * MS),
        Ev("cpu_op", "repro.engine.step", 5 * MS, 35 * MS),
        Ev("cpu_op", "repro.backend.pull", 10 * MS, 20 * MS),
        Ev("cpu_op", "aten::item", 32 * MS, 6 * MS),
        Ev("cpu_op", "repro.engine.step", 40 * MS, 40 * MS),
        Ev("kernel", "void ell_spmv_kernel<float, 3>(float*, int)",
           0, 10 * MS),
        Ev("kernel", "void ell_spmv_kernel<float, 3>(float*, int)",
           45 * MS, 15 * MS),
        Ev("gpu_memcpy", "Memcpy DtoH", 85 * MS, 3 * MS),
        Ev("gpu_user_annotation", "perfbench.solve_batch", 0, 90 * MS),
    ]


@pytest.mark.parametrize("Ev", [_Ev, _OldEv], ids=["activity", "device"])
def test_idle_goes_to_the_innermost_program_range(Ev):
    got = ranges.program_ranges(_Prof(_trace(Ev)))
    assert got["window_s"] == pytest.approx(0.1)
    assert got["busy_s"] == pytest.approx((10 + 15 + 3) * 1e-3)
    idle = got["idle"]
    assert set(idle) == {"solve_batch", "window"}
    assert idle["solve_batch"] == {
        "repro.backend.pull": pytest.approx(0.035),   # gap 10-45 ms
        "repro.engine.step": pytest.approx(0.025)}    # gap 60-85 ms
    assert idle["window"] == {"": pytest.approx(0.012)}   # gap 88-100 ms
    total = sum(s for per in idle.values() for s in per.values())
    assert total == pytest.approx(got["window_s"] - got["busy_s"])
    assert got["spans"]["repro.engine.step"] == [2, pytest.approx(0.075)]
    assert got["spans"]["repro.batch.solve_batch"][0] == 1
    layers = ranges.layer_idle(got)
    assert layers["engine_step_idle_ms"] == pytest.approx(30.0)
    assert layers["batch_idle_ms"] == 0.0
    assert layers["service_idle_share"] == 0.0
    assert layers["outside_share"] == {"solve_batch": 0.0, "window": 1.0}


@pytest.mark.parametrize("Ev", [_Ev, _OldEv], ids=["activity", "device"])
def test_a_trace_with_program_ranges_keeps_the_summarys_fields(Ev):
    """The ranges change nothing ``spans.summarize`` reads but the host
    operation an idle gap is named by."""
    s = spans.summarize(_Prof(_trace(Ev)))
    assert s.window_s == pytest.approx(0.1)
    assert s.busy_s == pytest.approx(0.028)
    assert set(s.kernels) == {"ell_spmv_kernel<float, 3>", "Memcpy DtoH"}
    assert s.kernel("ell_spmv_kernel") == (pytest.approx(0.025), 2)
    assert dict(s.idle_gaps) == {
        "solve_batch/repro.backend.pull": pytest.approx(0.035),
        "solve_batch/repro.engine.step": pytest.approx(0.025),
        "window/python": pytest.approx(0.012)}


def test_no_window_no_reduction():
    evs = [_Ev("user_annotation", "repro.engine.step", 0, MS)]
    assert ranges.program_ranges(_Prof(evs)) is None


def _run(**kw) -> harness.Run:
    return harness.Run(workload="w", config={}, traffic={}, seed=0,
                       seconds=1.0, **kw)


def test_counter_readers_return_none_without_a_count():
    read = {name: harness.load_module("metrics", name).read for name in (
        "backend.pull_edges_per_query.ppr",
        "backend.pull_edges_per_query.serve",
        "service.queue_wait_p95_ms.serve", "service.in_slot_p95_ms.serve")}
    # a program without the counters, as the parent is
    parent = _run(completed=64, backend_stats={"kernel_pull": 8},
                  service={"stats": {"submitted": 64}})
    assert all(r(parent) is None for r in read.values())
    # no query completed: no counter to divide, no wait kept
    idle = _run(backend_stats={"pull_edges": 0},
                service={"stats": {"waits": {"count": 0}}})
    assert all(r(idle) is None for r in read.values())
    run = _run(completed=64, backend_stats={"pull_edges": 640},
               service={"stats": {"waits": {
                   "count": 3, "queue_p95_ms": 7.5,
                   "in_slot_p95_ms": 12.0}}})
    assert read["backend.pull_edges_per_query.ppr"](run) == 10.0
    assert read["service.queue_wait_p95_ms.serve"](run) == 7.5
    assert read["service.in_slot_p95_ms.serve"](run) == 12.0


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_cpu_run_reports_the_programs_counters(cell, tmp_path,
                                                        monkeypatch):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))
    found = {}

    def both(prof, _summarize=harness.summarize):
        found["ranges"] = ranges.program_ranges(prof)
        return _summarize(prof)
    monkeypatch.setattr(harness, "summarize", both)
    c = harness.cell_plan(BENCH, cell)["cell"]
    traffic = _tiny_traffic(c)
    result, _ = harness.run_cell(cell, 2**31 + 7, 0.3, True, device="cpu",
                                 bench=BENCH, config=TINY[c["config"]],
                                 traffic=traffic)
    assert result["correct"] is True
    metrics = {k: v["value"] for k, v in result["metrics"].items()}
    mine = [m["name"] for m in BENCH["per_layer"]
            if m["source"] == "program_counter" and cell in m["workloads"]
            and m["name"].split(".")[1] in ("pull_edges_per_query",
                                            "queue_wait_p95_ms",
                                            "in_slot_p95_ms")]
    assert mine and all(math.isfinite(metrics[m]) for m in mine)
    got = found["ranges"]
    assert got["spans"]["repro.engine.step"][0] > 0
    total = sum(s for per in got["idle"].values() for s in per.values())
    assert total == pytest.approx(got["window_s"] - got["busy_s"])
    if traffic["mode"] == "closed":
        # every step of a PPR batch is one full scan of the m in-edges
        cfg = TINY[c["config"]]
        m = len(harness.load_module("generators", cfg["generator"])
                .generate(**cfg["generator_args"])["src"])
        assert metrics["backend.pull_edges_per_query.ppr"] == \
            pytest.approx(metrics["batch.steps.ppr"] * m / traffic["width"])
