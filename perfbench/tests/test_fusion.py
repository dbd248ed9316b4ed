"""CPU tests of the fused-step counter's reader (``perfbench/fusion.py``)
and of a traced run of each cell reporting it.

    python -m pytest -q perfbench/tests
"""

from __future__ import annotations

import pytest

from perfbench import harness
from perfbench.tests.test_benchmark_harness import (BENCH, CELLS, TINY,
                                                    _tiny_traffic)

SHARES = ("backend.fused_pull_share.ppr", "backend.fused_pull_share.serve")


def _run(**kw) -> harness.Run:
    return harness.Run(workload="w", config={}, traffic={}, seed=0,
                       seconds=1.0, **kw)


@pytest.mark.parametrize("name", SHARES)
def test_the_share_reads_none_without_the_counter(name):
    read = harness.load_module("metrics", name).read
    # a program without the counter, as the parent is
    assert read(_run(backend_stats={"kernel_pull": 8})) is None
    # a window with no kernel pull
    assert read(_run(backend_stats={"kernel_pull": 0,
                                    "fused_pull_update": 0})) is None
    assert read(_run(backend_stats={"kernel_pull": 8,
                                    "fused_pull_update": 6})) == 75.0


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_cpu_run_fuses_every_ppr_pull(cell, tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))
    c = harness.cell_plan(BENCH, cell)["cell"]
    result, _ = harness.run_cell(cell, 2**31 + 11, 0.3, True, device="cpu",
                                 bench=BENCH, config=TINY[c["config"]],
                                 traffic=_tiny_traffic(c))
    assert result["correct"] is True
    mine = [m["name"] for m in BENCH["per_layer"]
            if m["name"] in SHARES and cell in m["workloads"]]
    assert len(mine) == 1
    assert result["metrics"][mine[0]]["value"] == 100.0
