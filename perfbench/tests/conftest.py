"""The small stand-ins of configurations that name their own.

``test_benchmark_harness.TINY`` maps each configuration to the small
graph its CPU runs use. A configuration file with a ``tiny`` key brings
its stand-in itself; this fixture sets it into that table for every
test, so the cell-parametrised tests run the configuration's cells too.
"""

from __future__ import annotations

import pytest

from perfbench import harness
from perfbench.tests import test_benchmark_harness


@pytest.fixture(autouse=True)
def tiny_stand_ins(monkeypatch):
    for c in test_benchmark_harness.BENCH["configs"]:
        cfg = harness.load_json("configs", c["name"])
        if "tiny" in cfg:
            monkeypatch.setitem(test_benchmark_harness.TINY, c["name"],
                                cfg["tiny"])
