"""The port stands alone: no JAX, nothing of ``repro``, and no quiet CPU.

  * a fresh interpreter imports every ``repro_torch`` module and
    ``chip_smoke``, and finds no ``jax*`` and no ``repro``/``repro.*``
    module loaded;
  * an AST scan of ``src/repro_torch/`` and ``chip_smoke.py`` finds no
    ``import jax`` and no import from ``repro``;
  * entry points default to the card, and without CUDA they raise an
    error that names ``device="cpu"``.
"""

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.graphs import build_graph, kronecker, resolve_device

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def port_modules() -> list[str]:
    mods = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_modules_import_without_jax_or_repro():
    # the serving, model, sharded, training, GNN, MoE and cell registry
    # slices' modules are among those checked
    assert {"repro_torch.service.scheduler", "repro_torch.service.batch",
            "repro_torch.service.cache", "repro_torch.service.programs",
            "repro_torch.resilience.errors", "repro_torch.kernels.tune",
            "repro_torch.core.algorithms.ppr",
            "repro_torch.kernels.flash_attention", "repro_torch.kernels.cin",
            "repro_torch.kernels.ops", "repro_torch.models.common",
            "repro_torch.models.attention", "repro_torch.models.transformer",
            "repro_torch.models.recsys", "repro_torch.sparse.embedding",
            "repro_torch.configs.shapes",
            "repro_torch.configs.archs", "repro_torch.obs.trace",
            "repro_torch.obs.metrics", "repro_torch.obs.export",
            "repro_torch.obs.report", "repro_torch.resilience.faults",
            "repro_torch.core.engine", "repro_torch.shard.mesh",
            "repro_torch.shard.topology", "repro_torch.shard.exchange",
            "repro_torch.shard.backend", "repro_torch.dist.collectives",
            "repro_torch.dist.compression", "repro_torch.dist.overlap",
            "repro_torch.train", "repro_torch.train.losses",
            "repro_torch.train.optimizer", "repro_torch.train.checkpoint",
            "repro_torch.train.loop", "repro_torch.data",
            "repro_torch.data.pipeline", "repro_torch.launch",
            "repro_torch.launch.train", "repro_torch.models.gnn",
            "repro_torch.models.moe", "repro_torch.graphs.sampling",
            "repro_torch.dist.sharding",
            "repro_torch.sparse.segment", "repro_torch.configs",
            "repro_torch.configs.steps", "repro_torch.configs.registry",
            "repro_torch.launch.mesh", "repro_torch.launch.dryrun",
            "repro_torch.launch.hillclimb", "repro_torch.roofline",
            "repro_torch.roofline.analysis",
            "repro_torch.service.bench"} <= set(port_modules())
    code = (
        "import importlib, json, sys\n"
        f"for name in {port_modules() + ['chip_smoke']!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'repro' or "
        "m.startswith('repro.'))\n"
        "print(json.dumps(bad))\n")
    env = {"PYTHONPATH": f"{ROOT / 'src'}:{ROOT}", "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize(
    "path", sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax_or_repro(path):
    assert not imported_roots(path) & {"jax", "jaxlib", "repro"}


def test_cuda_sources_have_a_plain_c_interface():
    """The kernels build with nvcc alone: no PyTorch headers."""
    sources = sorted((PKG / "kernels" / "csrc").glob("*.cu*"))
    assert {p.stem for p in sources if p.suffix == ".cu"} == {
        "ell_spmv", "ell_pull_frontier", "coo_push", "coo_push_mxu",
        "flash_attention", "flash_attention_bwd", "cin", "cin_bwd"}
    for p in sources:
        assert "torch/" not in p.read_text() and "ATen" not in p.read_text()


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    src = np.array([0, 1])
    dst = np.array([1, 2])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        build_graph(src, dst, n=3)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        kronecker(4, 2)
    assert build_graph(src, dst, n=3, device="cpu").device.type == "cpu"


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    """Without CUDA the script exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the script would run")
    env = {"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)}
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=240)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
