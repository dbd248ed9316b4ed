"""CPU tests of the benchmark harness (``perfbench/``).

Run from the repository root (``pyproject.toml`` puts ``src`` and the
root on the path):

    python -m pytest -q perfbench/tests

They hold ``BENCHMARK.json`` to the benchmark's contract, load every
file a cell, mix, metric or reference names, check the frozen
generators and the plain references against the program's CPU paths at
small sizes, and drive whole runs on the CPU (the harness's look for a
card skipped) on small stand-ins of the cells: the last line's shape,
the import check, and ``correct`` turning false under each fault a cell
can have. Tests marked ``cuda`` need the card.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import harness, reduce, spans, yardstick

ROOT = Path(__file__).resolve().parents[2]
BENCH = harness.load_benchmark()
CELLS = [c["name"] for c in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")

TINY = {
    "gap-urand-s21": {"name": "tiny-urand", "generator": "urand",
                      "generator_args": {"scale": 9, "degree": 16,
                                         "seed": 0}},
}


def _tiny_traffic(cell: dict) -> dict:
    traffic = harness.load_json("traffic", cell["traffic"])
    if traffic["mode"] == "closed":
        traffic["width"] = 8
    else:
        traffic.update(slots=4, rate_per_s=30.0)
    return traffic


@pytest.fixture
def cpu_run(tmp_path, monkeypatch):
    """Drive a whole run of a cell on the CPU at a small size."""
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))
    from repro_torch.kernels import tune
    tune.clear_memory_cache()

    def go(workload: str, trace: bool = False, seconds: float = 0.3,
           seed: int = 2**31 + 11):
        cell = harness.cell_plan(BENCH, workload)["cell"]
        return harness.run_cell(
            workload, seed, seconds, trace, device="cpu", bench=BENCH,
            config=TINY[cell["config"]], traffic=_tiny_traffic(cell))
    return go


# ---------------------------------------------------------------------
# the contract
def test_benchmark_json_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"][:2] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
        assert (ROOT / c["file"]).is_file()
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        file_cfg = json.loads((ROOT / c["file"]).read_text())
        assert file_cfg["reduced"] == c["reduced"]
        assert file_cfg["source"] == c["source"]
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert NAME.match(w["traffic"])
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(CELLS)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_metrics_meet_the_contract():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["moves"] in e2e
        for w in m.get("workloads", CELLS):
            assert w in e2e[m["moves"]].get("workloads", CELLS), (m, w)
        if m["name"].endswith("roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
    for cell in CELLS:
        plan = harness.cell_plan(BENCH, cell)
        assert any(m["name"] == "setup_s" for m in plan["end_to_end"])
        assert len(plan["end_to_end"]) >= 2 and plan["per_layer"]


def test_every_named_file_loads():
    for c in BENCH["configs"]:
        cfg = harness.load_json("configs", c["name"])
        gen = harness.load_module("generators", cfg["generator"])
        assert callable(gen.generate)
    for w in BENCH["workloads"]:
        traffic = harness.load_json("traffic", w["traffic"])
        ref = harness.load_module("reference", traffic["algorithm"])
        assert callable(ref.solve) and callable(ref.control)
        assert set(traffic["limits"]) <= set(ref.CHECKS)
        assert traffic["mode"] in ("closed", "open")
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)


def test_forbidden_modules_compare_whole_top_level_names():
    names = ["repro_torch.api", "repro", "repro.core.engine", "jaxlib.xla",
             "jaxtyping", "flax.linen", "numpy", "reprox"]
    assert harness.forbidden_modules(names) == ["flax", "jaxlib", "repro"]
    assert harness.forbidden_modules(["repro_torch", "perfbench"]) == []


# ---------------------------------------------------------------------
# the yardstick
def test_urand_is_gaps_uniform_random_graph():
    gen = harness.load_module("generators", "urand")
    e = gen.generate(scale=9, degree=16, seed=3)
    n, src, dst = e["n"], e["src"], e["dst"]
    assert n == 512 and e["w"] is None
    assert (src != dst).all()
    key = dst * n + src
    assert (np.diff(key) > 0).all()          # sorted, no duplicate pair
    assert np.array_equal(np.sort(src * n + dst), key)   # symmetric
    # 16 * 512 drawn pairs, less self loops and repeats, both directions
    assert 0.95 * 2 * 16 * n < len(src) <= 2 * 16 * n
    again = gen.generate(scale=9, degree=16, seed=3)
    assert np.array_equal(again["src"], src)
    assert np.array_equal(again["dst"], dst)
    other = gen.generate(scale=9, degree=16, seed=4)
    assert not np.array_equal(other["src"][:100], src[:100])


def test_configurations_name_their_sizes():
    for c in BENCH["configs"]:
        cfg = harness.load_json("configs", c["name"])
        args = cfg["generator_args"]
        assert cfg["n"] == 1 << args["scale"]
        assert cfg["published"]["degree"] == args["degree"]
        assert set(cfg["reduced"]) <= set(cfg["published"])
        # m and d_ell, where given, are checked at run time by the
        # harness against the built graph


def test_ell_spmv_min_bytes():
    assert yardstick.ell_spmv_min_bytes(10, 30, 2) == 30 * 4 + 40 + 160
    assert yardstick.ell_spmv_min_bytes(10, 30, 1, weighted=True) == \
        30 * 8 + 40 + 80
    assert yardstick.bytes_share(3.35e12, 1.0) == pytest.approx(100.0)


def _graph():
    cfg = TINY["gap-urand-s21"]
    e = harness.load_module("generators", cfg["generator"]).generate(
        **cfg["generator_args"])
    from repro_torch.graphs import build_graph
    g = build_graph(e["src"], e["dst"], n=e["n"], weights=e["w"],
                    device="cpu")
    return g, harness.reference_edges(e, torch.device("cpu"))


@pytest.mark.parametrize("block", [16, 1])
def test_reference_ppr_matches_the_port(block, monkeypatch):
    from repro_torch import api
    g, edges = _graph()
    params = {"damp": 0.85, "tol": 1e-6, "iters": 100}
    src = [0, 7, 33, 101]
    ref = harness.load_module("reference", "ppr")
    if block == 1:     # the column blocks of a graph too large for 16
        monkeypatch.setattr(ref, "BLOCK_ELEMENTS", edges["src"].numel())
    truth = ref.solve(edges, src, params)
    for backend in ("dense", "cuda"):
        br = api.solve_batch(g, "ppr", sources=src, backend=backend,
                             **params)
        got = [s["ranks"] for s in br.states]
        assert ref.readings(got, truth)["rank_gap"] < 1e-5
    one = api.solve(g, "ppr", source=7, **params).state["ranks"]
    assert ref.readings([one], truth[:, 1:2])["rank_gap"] < 1e-5


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_cells_limits(cell):
    traffic = harness.load_json(
        "traffic", harness.cell_plan(BENCH, cell)["cell"]["traffic"])
    config = TINY[harness.cell_plan(BENCH, cell)["cell"]["config"]]
    e = harness.load_module("generators", config["generator"]).generate(
        **config["generator_args"])
    edges = harness.reference_edges(e, torch.device("cpu"))
    items = [(s, None) for s in (0, 3, 40, 77)]
    readings = harness.judge(traffic, edges, items, control=True)
    ok, _ = harness.verdict(readings, traffic["limits"])
    assert not ok, readings


# ---------------------------------------------------------------------
# the generator of traffic
def test_arrivals_send_the_same_gaps_in_another_order():
    a = harness.arrivals(50.0, 4.0, harness.rng(1, 3))
    b = harness.arrivals(50.0, 4.0, harness.rng(2**33 + 1, 3))
    assert len(a) == len(b) == 200
    assert a[0] == 0.0 and (np.diff(a) > 0).all() and a[-1] < 4.0
    assert np.allclose(np.sort(np.diff(np.append(a, 4.0))),
                       np.sort(np.diff(np.append(b, 4.0))))
    assert not np.allclose(a, b)


@pytest.mark.parametrize("spec", [{"kind": "uniform", "distinct": True},
                                  {"kind": "zipf", "s": 1.1,
                                   "distinct": True}])
def test_sources_are_reproducible_and_distinct(spec):
    eligible = np.arange(5, 500, 3)
    one = harness.Sources(spec, eligible, harness.rng(7, 0)).draw(64)
    two = harness.Sources(spec, eligible, harness.rng(7, 0)).draw(64)
    assert (one == two).all() and len(set(one.tolist())) == 64
    assert set(one.tolist()) <= set(eligible.tolist())


def test_sample_is_a_seeded_reservoir():
    def fill(seed):
        s = harness.Sample(5, harness.rng(seed, 2))
        for lo in range(0, 100, 8):
            s.offer(range(lo, min(lo + 8, 100)), lambda j: None)
        return [i for i, _ in s.items]
    assert fill(4) == fill(4) and len(set(fill(4))) == 5
    assert fill(4) != fill(5)


def test_kernel_names_lose_return_type_and_arguments():
    assert spans.short_name("void rk::f<int, 1>(int const*, long)") == \
        "rk::f<int, 1>"
    assert spans.short_name(
        "void at::native::(anonymous namespace)::g<float>(float*)") == \
        "at::native::(anonymous namespace)::g<float>"
    assert spans.short_name("Memcpy DtoH (Device -> Pageable)") == \
        "Memcpy DtoH"
    assert len(spans.short_name("k" * 500)) == spans.NAME_CHARS


def test_roofline_share_counts_the_graph_run():
    trace = spans.TraceSummary(window_s=1.0, busy_s=0.5,
                               kernels={"rk::ell_spmv_kernel<f>": [0.01, 4]},
                               device_ops=[], idle_gaps=[])
    run = harness.Run(workload="w", config={}, traffic={"width": 8},
                      seed=0, seconds=1.0, n=1000, m=5000, trace=trace)
    want = 100 * 4 * yardstick.ell_spmv_min_bytes(1000, 5000, 8) \
        / yardstick.HBM_BYTES_PER_S / 0.01
    assert reduce.ell_spmv_roofline(run) == pytest.approx(want)
    run.trace = None
    assert reduce.ell_spmv_roofline(run) is None


def test_nearest_rank_percentile():
    assert reduce.percentile(list(range(1, 101)), 95) == 95
    assert reduce.percentile([3.0], 95) == 3.0


# ---------------------------------------------------------------------
# the reduction of a trace
class _Event:
    """A profiler event as torch's ``_KinetoEvent`` gives it."""
    def __init__(self, kind, name, start, dur, tid=1):
        self._k, self._n, self._s, self._d, self._t = kind, name, start, \
            dur, tid

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def start_thread_id(self):
        return self._t


class _Ev(_Event):
    """With its activity type, as newer torch releases give it."""
    def activity_type(self):
        return self._k


class _OldEv(_Event):
    """With only its device type, as some torch releases give it."""
    def device_type(self):
        host = self._k in ("cpu_op", "user_annotation")
        return "DeviceType.CPU" if host else "DeviceType.CUDA"


class _Prof:
    def __init__(self, events):
        class K:
            def events(_):
                return events
        self.profiler = type("P", (), {"kineto_results": K()})()


@pytest.mark.parametrize("Ev", [_Ev, _OldEv], ids=["activity", "device"])
def test_trace_summary_busy_gaps_and_names(Ev):
    ms = 1_000_000
    evs = [
        Ev("user_annotation", "perfbench.window", 0, 100 * ms),
        Ev("user_annotation", "perfbench.solve_batch", 0, 90 * ms),
        Ev("cpu_op", "aten::item", 10 * ms, 30 * ms),
        Ev("cpu_op", "aten::where", 70 * ms, 15 * ms),
        Ev("kernel", "void ell_spmv_kernel<float, 3>(float*, int)",
            0, 10 * ms),
        Ev("kernel", "void ell_spmv_kernel<float, 3>(float*, int)",
            5 * ms, 10 * ms),
        Ev("gpu_memcpy", "Memcpy DtoH", 50 * ms, 10 * ms),
        Ev("gpu_user_annotation", "perfbench.solve_batch", 0, 90 * ms),
        Ev("kernel", "other", 95 * ms, 20 * ms),   # cut at the window
        Ev("kernel", "before", -50 * ms, 10 * ms),  # outside it
    ]
    s = spans.summarize(_Prof(evs))
    assert s.window_s == pytest.approx(0.1)
    assert s.busy_s == pytest.approx((15 + 10 + 5) * 1e-3)
    assert s.kernel("ell_spmv_kernel") == (pytest.approx(0.02), 2)
    assert "before" not in s.kernels
    idle = dict(s.idle_gaps)
    assert idle["solve_batch/aten::item"] == pytest.approx(0.035)
    assert idle["solve_batch/aten::where"] == pytest.approx(0.035)
    assert sum(idle.values()) == pytest.approx(0.07)
    assert s.device_ops[0][0] == "ell_spmv_kernel<float, 3>"


# ---------------------------------------------------------------------
# whole runs on the CPU
@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_a_run_prints_the_contracts_line(cpu_run, cell, trace):
    result, lines = cpu_run(cell, trace=trace)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] > 0
    plan = harness.cell_plan(BENCH, cell)
    specs = plan["per_layer" if trace else "end_to_end"]
    assert set(result["metrics"]) <= {m["name"] for m in specs}
    if not trace:
        assert set(result["metrics"]) == {m["name"] for m in specs}
    for m in result["metrics"].values():
        assert math.isfinite(m["value"]) and set(m) == {"value", "unit"}
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    if trace:
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert len(result["breakdown"]["idle_gaps"]) <= 10
    json.loads(json.dumps(result, allow_nan=False))
    assert lines[0].startswith("check ")
    for name, c in result["checks"].items():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


def _stuck(monkeypatch):
    """A step that returns its state unchanged."""
    from repro_torch.core import engine
    orig = engine.PushPullEngine._step

    def step(self, g, ph, st):
        return dataclasses.replace(orig(self, g, ph, st), state=st.state)
    monkeypatch.setattr(engine.PushPullEngine, "_step", step)


def _half(monkeypatch):
    """Half of the batch left out: the upper half of the query columns
    never takes a step's update."""
    from repro_torch.core import engine
    orig = engine.PushPullEngine._step

    def step(self, g, ph, st):
        new = orig(self, g, ph, st)
        width = next(v.shape[-1] for v in st.state.values()
                     if torch.is_tensor(v) and v.ndim == 2)
        keep = width - width // 2

        def mix(a, b):
            if not torch.is_tensor(a) or a.ndim == 0 or a.shape[-1] != width:
                return a
            out = a.clone()
            out[..., keep:] = b[..., keep:]
            return out
        state = {k: mix(v, st.state[k]) for k, v in new.state.items()}
        return dataclasses.replace(new, state=state)
    monkeypatch.setattr(engine.PushPullEngine, "_step", step)


def _altered(monkeypatch):
    """One answer altered where it is produced: the extract of a query's
    state changes its largest rank by 1 %."""
    from repro_torch.service import programs
    for name, spec in list(programs._BATCH_REGISTRY.items()):
        def extract(g, state, i, _orig=spec.extract):
            out = dict(_orig(g, state, i))
            if "ranks" in out:
                v = out["ranks"].clone()
                j = int(v.abs().argmax())
                v[j] = v[j] * 1.01
                out["ranks"] = v
            return out
        monkeypatch.setitem(programs._BATCH_REGISTRY, name,
                            dataclasses.replace(spec, extract=extract))


@pytest.mark.parametrize("fault", [_stuck, _half, _altered],
                         ids=["state_unchanged", "half_batch_left_out",
                              "answer_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(cpu_run, monkeypatch, cell,
                                            fault):
    # one card: no exchange between chips to leave out
    fault(monkeypatch)
    result, lines = cpu_run(cell)
    assert result["correct"] is False, result["checks"]
    assert "correct: False" in lines[-1]


# ---------------------------------------------------------------------
# the command
def _run_py(cwd: Path, *args) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, str(cwd / "perfbench" / "run.py"), *args],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def test_run_py_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = _run_py(ROOT, "--workload", CELLS[0], "--seed", "1", "--seconds",
                "1", "--trace", "0")
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA card" in p.stderr


def test_run_py_fails_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    p = _run_py(tmp_path, "--workload", CELLS[0], "--seed", "1",
                "--seconds", "1", "--trace", "0")
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_a_run_loads_no_jax(tmp_path):
    code = (
        "import sys, torch\n"
        "sys.path[:0] = ['src', '.']\n"
        "from perfbench import harness\n"
        "from perfbench.tests import test_benchmark_harness as t\n"
        "cell = harness.cell_plan(t.BENCH, t.CELLS[0])['cell']\n"
        "harness.run_cell(t.CELLS[0], 3, 0.2, False, device='cpu',\n"
        "                 config=t.TINY[cell['config']],\n"
        "                 traffic=t._tiny_traffic(cell))\n"
        "print(harness.forbidden_modules(sys.modules))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env={**__import__("os").environ,
                            "REPRO_CACHE_DIR": str(tmp_path)})
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.cuda
def test_a_small_cell_runs_on_the_card(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path))
    for cell in CELLS:
        c = harness.cell_plan(BENCH, cell)["cell"]
        result, _ = harness.run_cell(cell, 5, 0.5, True, bench=BENCH,
                                     config=TINY[c["config"]],
                                     traffic=_tiny_traffic(c))
        assert result["correct"] is True
        assert result["device"]["busy_s"] > 0
