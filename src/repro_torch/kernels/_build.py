"""Build and load the CUDA kernels; count their launches and their work.

Each ``csrc/<source>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
its own shared library with a plain C interface (no PyTorch headers, so
a build takes seconds) and loaded with ``ctypes``. A kernel's source is
its name, except where ``SOURCES`` puts several kernels (each with its
own entry point and launch count) in one file. Libraries live in
``build/repro_torch/`` at the repository root, named by a hash of the
sources and flags, so an edited source is rebuilt at its next use. All
missing libraries are compiled at once, one ``nvcc`` process each.

Nothing here runs at import: the CPU tests import every module, and
this host may have no ``nvcc``.

The work counter (:func:`count_work`) holds the operations and bytes of
each model kernel where it ran on the card or stood in on ``meta``, for
the dry run: a profiler's operation counter sees the PyTorch operators
around a launch, never the launch. A plain version on the CPU runs
PyTorch operators, and adds nothing here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

__all__ = ["KERNELS", "SOURCES", "BUILD_DIR", "NVCC_FLAGS", "build_all",
           "load",
           "count_launch", "launch_counts", "reset_launch_counts",
           "check_status", "lib_path", "zeroed_counters", "count_work",
           "kernel_work", "reset_kernel_work"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
KERNELS = ("ell_spmv", "ell_spmv_ppr", "ell_pull_frontier", "coo_push",
           "coo_push_mxu", "flash_attention", "flash_attention_bwd", "cin",
           "cin_dw", "cin_dx0")
# kernels that share a source file (the others are built from their name)
SOURCES = {"ell_spmv_ppr": "ell_spmv", "cin_dw": "cin_bwd",
           "cin_dx0": "cin_bwd"}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# argument types of each library's entry point (pointers and the stream
# as c_void_p, so ctypes never cuts a 64-bit address)
_SIGNATURES = {
    "ell_spmv": ("repro_ell_spmv",
                 [_P, _I, _P, _P, _P, _L, _L, _L, _L, _L, _I, _I, _P, _P,
                  _L, _L, _L, _L, _L, _L, _P, _P, _P, _P, _P, _P]),
    "ell_spmv_ppr": ("repro_ell_spmv_ppr",
                     [_P, _P, _P, _L, _L, _L, _L, _P, _P, _L, _L, _L, _L,
                      _L, _L, _P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _F,
                      _F, _P, _P]),
    "ell_pull_frontier": ("repro_ell_pull_frontier",
                          [_P, _I, _P, _P, _P, _P, _P, _L, _L, _L, _L, _L,
                           _L, _I, _I, _I, _I, _L, _L, _P, _P, _P, _P]),
    "coo_push": ("repro_coo_push",
                 [_P, _I, _P, _P, _P, _P, _P, _L, _L, _L, _I, _I, _L, _L,
                  _P, _P, _P, _L, _P, _P, _P, _P, _P]),
    "coo_push_mxu": ("repro_coo_push_mxu",
                     [_P, _I, _P, _P, _P, _P, _P, _P, _L, _L, _L, _L, _I,
                      _I, _L, _P, _P, _P, _P]),
    "flash_attention": ("repro_flash_attention",
                        [_P, _P, _P, _P, _P, _I, _L, _L, _I, _I, _I, _L,
                         _F, _F, _P]),
    "flash_attention_bwd": ("repro_flash_attention_bwd",
                            [_P] * 13 + [_I, _L, _L, _I, _I, _I, _L, _F, _F,
                                         _P]),
    "cin": ("repro_cin_layer", [_P, _P, _P, _P, _I, _L, _I, _I, _I, _I, _I,
                                _I, _I, _P, _P, _P]),
    "cin_dw": ("repro_cin_dw", [_P, _P, _P, _I, _L, _I, _I, _I, _I, _I, _I,
                                _I, _P, _P, _P, _P, _P, _P, _P]),
    "cin_dx0": ("repro_cin_dx0", [_P, _P, _P, _P, _I, _L, _I, _I, _I, _I, _I,
                                  _I, _P, _P, _P, _P]),
}

_LIBS: dict = {}
_LAUNCHES = {name: 0 for name in KERNELS}
_WORK = {name: {"flops": 0, "bytes": 0} for name in KERNELS}
# per (kernel, device): arrival counters of work split across CTAs, zero
# between launches (the last CTA of each split unit resets its own)
_COUNTERS: dict = {}


def zeroed_counters(name: str, device, count: int):
    """Kernel ``name``'s int32 arrival counters on ``device``, at least
    ``count`` of them, all zero (made once, grown when a launch needs
    more; the kernel leaves them zero)."""
    buf = _COUNTERS.get((name, device))
    if buf is None or buf.shape[0] < count:
        buf = _COUNTERS[(name, device)] = torch.zeros(
            max(count, 1024), dtype=torch.int32, device=device)
    return buf


def count_launch(name: str) -> None:
    """Called by a wrapper right after it launched kernel ``name``."""
    _LAUNCHES[name] += 1


def launch_counts() -> dict:
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


def count_work(name: str, flops: int, nbytes: int) -> None:
    """Called by a wrapper where kernel ``name`` launched on the card or
    stood in on ``meta``: its operations and bytes."""
    _WORK[name]["flops"] += int(flops)
    _WORK[name]["bytes"] += int(nbytes)


def kernel_work() -> dict:
    return {name: dict(w) for name, w in _WORK.items()}


def reset_kernel_work() -> None:
    for w in _WORK.values():
        w["flops"] = w["bytes"] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    found = str(cand) if cand.is_file() else shutil.which("nvcc")
    if not found:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built")
    return found


def lib_path(name: str) -> Path:
    """Where kernel ``name``'s library lives (its build log beside it)."""
    source = SOURCES.get(name, name)
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{source}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"lib{source}-{h.hexdigest()[:16]}.so"


def build_all() -> dict:
    """Compile every kernel library that is missing, all in parallel.
    Returns {source: seconds} for the ones compiled; raises with the
    compiler's output if any fails."""
    todo = {SOURCES.get(name, name): lib_path(name) for name in KERNELS
            if not lib_path(name).is_file()}
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name, out in todo.items():
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT),
                       tmp, out)
    seconds, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_bytes(log)
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n"
                          + log.decode(errors="replace"))
            continue
        os.replace(tmp, out)          # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str):
    """The entry point of kernel ``name``'s library (built on first use),
    with its ctypes signature set."""
    hit = _LIBS.get(name)
    if hit is None:
        path = lib_path(name)
        if not path.is_file():
            build_all()
        lib = ctypes.CDLL(str(path))
        symbol, argtypes = _SIGNATURES[name]
        fn = getattr(lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        err = lib.repro_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        hit = _LIBS[name] = (fn, err)
    return hit[0]


def check_status(rc: int, name: str) -> None:
    """Raise if a launch of kernel ``name`` returned a CUDA error; else
    count the launch."""
    if rc != 0:
        err = _LIBS[name][1](rc).decode()
        raise RuntimeError(
            f"{name} kernel launch failed: CUDA error {rc} ({err})")
    count_launch(name)
