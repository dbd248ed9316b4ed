"""Autotuner for the CUDA graph kernels: grid search, disk cache.
PyTorch port of ``repro.kernels.tune``.

The ``CudaBackend`` probes a candidate grid once per (graph shape,
payload shape, device) and caches the winner twice over:

  * **on disk** under ``~/.cache/repro/tune_torch.json`` (override the
    directory with ``$REPRO_CACHE_DIR``), keyed by platform × kernel ×
    shape × dtype × combine × msg, where the platform is the card's
    (``cuda-sm90`` on an H100) or ``cpu`` (CPU tensors, where the plain
    versions are what gets timed);
  * **in memory** (module-level dict), which also serves when the cache
    directory is unwritable.

Search space — pull: ``block_n`` rungs (rows one CTA walks); frontier
pull: ``block_r`` rungs (``block_r // 128`` passes of a CTA over the
units of the compacted row list); push: the
(block_e, block_n = bin width, strategy) grid over both reduce
strategies (``"scan"`` | ``"mxu"``). The candidate functions return the
JAX package's tuples. Probes run inline on synthetic data of the shape
being solved (a seeded ``torch.Generator``; the push uses uniform sorted
destinations; the frontier pull, given the graph's layout, its own rows
and in-degrees), one warm-up and one timed call each, timed with CUDA
events on the card. Push candidates are grouped by (strategy, bin
width): a group whose first rung lands ≥ ``_PRUNE``× behind the
incumbent is abandoned, since its other rungs only move block_e. The
pull ladders ascend in tile size, and a probe stops at the first rung
≥ ``_PRUNE``× behind the incumbent: larger tiles only take parallelism
away (the last rung, one CTA for the whole range, can take seconds at
batch width).

Resilience, as in the JAX package: the ``tune.probe``,
``tune.cache.load`` and ``tune.cache.write`` fault sites; a disk fault
falls back to the memory tier; a probe is retried with backoff
(``$REPRO_TUNE_RETRIES``, default 2) under a wall deadline
(``$REPRO_TUNE_DEADLINE_S``, default 120), and when every attempt
fails the tuner takes the first candidate and does not write it to
disk, so a later healthy run probes again. Two departures from the JAX
package:

  * the deadline is checked between candidates, not by a daemon thread
    the caller abandons: the host cannot abandon a kernel running on the
    card, and a thread left behind would only queue the next launch
    behind it;
  * only ``FaultInjected``, ``ProbeTimeout`` and ``OSError`` are retried
    and fall back. Any other exception, such as a candidate that fails
    to launch, propagates: a broken kernel is never hidden behind a
    default.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time

import numpy as np
import torch

from ..obs.trace import region
from ..resilience import FaultInjected, ProbeTimeout, fault_point, note
from ._build import launch_counts
from .coo_push import build_push_plan, coo_push
from .ell_pull_frontier import ell_pull_frontier
from .ell_spmv import ell_row_plan, ell_spmv

__all__ = ["pull_candidates", "pull_frontier_candidates",
           "push_candidates", "tune_pull", "tune_pull_frontier",
           "tune_push", "tune_stats", "probe_records", "clear_stats",
           "cache_dir", "clear_memory_cache"]

_PULL_LADDER = (128, 256, 512, 1024, 2048, 4096)
_EDGE_LADDER = (1024, 4096, 16384)
_BIN_LADDER = (128, 256, 1024)
_PRUNE = 2.0
# revision of each kernel's design, part of its cache key, so that a
# winner timed on an earlier design is not reused: pull 2 is the
# full-scan pull over real slots with a row plan; pullf 2 the frontier
# pull over real slots with lane groups and row pieces; push 2 the
# edge-parallel scan push, 3 the one-hot push on wgmma over tiles, 4 its
# float sums in four aligned parts
KERNEL_REVISIONS = {"pull": 2, "pullf": 2, "push": 4}


def _round_up(x: int, q: int) -> int:
    return -(-x // q) * q


def pull_candidates(n: int, width: int | None = None) -> tuple[int, ...]:
    """``block_n`` rungs for the ELL pull kernel: the ladder below n
    plus the whole (padded) vertex range, which single-column payloads
    drop whenever sub-n rungs exist."""
    n_pad = _round_up(max(n, 8), 8)
    cands = [c for c in _PULL_LADDER if c < n_pad]
    if not (width == 1 and cands):
        cands.append(n_pad)
    return tuple(cands)


def pull_frontier_candidates(n: int, rows: int) -> tuple[int, ...]:
    """``block_r`` rungs for the frontier pull kernel: the pull ladder
    clipped below the padded row count, plus the whole-list rung."""
    r_pad = _round_up(max(rows, 8), 8)
    cands = [c for c in _PULL_LADDER if c < r_pad]
    cands.append(r_pad)
    return tuple(cands)


def push_candidates(n: int, m: int) -> tuple[tuple[int, int, str], ...]:
    """(block_e, block_n, strategy) grid for the two-phase push: scan
    rungs over the full bin ladder, one-hot rungs over bins of at most
    256 destinations; ordered scan-first so pruning meets the incumbent
    early."""
    n_pad = _round_up(max(n, 8), 8)
    m_pad = _round_up(max(m, 8), 8)
    bins = sorted({min(b, n_pad) for b in _BIN_LADDER} | {n_pad})
    edges = sorted({min(e, m_pad) for e in _EDGE_LADDER} | {m_pad})
    cands = [(e, b, "scan") for b in bins for e in edges]
    cands += [(e, b, "mxu") for b in bins if b <= 256 for e in edges]
    return tuple(cands)


# -- persistent cache ---------------------------------------------------
_MEM_CACHE: dict[str, object] = {}
_DISK: dict | None = None
_LOCK = threading.Lock()
_STATS = {"mem_hits": 0, "disk_hits": 0, "misses": 0, "probes": 0,
          "writes": 0, "write_errors": 0, "probe_retries": 0,
          "probe_timeouts": 0, "probe_failures": 0, "probe_degraded": 0}
# what each probe did: key, candidates timed, groups (push) or rungs
# (pull) pruned, winner, seconds and the kernel launches it made (the
# newest 256)
_PROBES: collections.deque = collections.deque(maxlen=256)


def tune_stats() -> dict[str, int]:
    """Snapshot of the process-wide tuner counters."""
    with _LOCK:
        return dict(_STATS)


def probe_records() -> list[dict]:
    """One record per probe since the last :func:`clear_stats`."""
    with _LOCK:
        return [dict(r) for r in _PROBES]


def clear_stats() -> None:
    with _LOCK:
        for k in _STATS:
            _STATS[k] = 0
        _PROBES.clear()


def cache_dir() -> str:
    return os.environ.get(
        "REPRO_CACHE_DIR",
        os.path.join(os.path.expanduser("~"), ".cache", "repro"))


def _cache_path() -> str:
    return os.path.join(cache_dir(), "tune_torch.json")


def clear_memory_cache() -> None:
    """Drop the in-memory tier (tests re-point $REPRO_CACHE_DIR)."""
    global _DISK
    with _LOCK:
        _MEM_CACHE.clear()
        _DISK = None


def _platform(device: torch.device) -> str:
    if device.type != "cuda":
        return device.type
    major, minor = torch.cuda.get_device_capability(device)
    return f"cuda-sm{major}{minor}"


def _cache_key(kernel: str, device: torch.device, shape: tuple, width: int,
               dtype: torch.dtype, combine: str, msg: str) -> str:
    dims = "x".join(str(s) for s in shape)
    dname = str(dtype).removeprefix("torch.")
    rev = KERNEL_REVISIONS.get(kernel)
    name = kernel if rev is None else f"{kernel}.r{rev}"
    return (f"{_platform(device)}|{name}|{dims}|w{width}|{dname}|"
            f"{combine}|{msg}")


def _load_disk() -> dict:
    """The on-disk tier, or {} for a missing, unreadable, truncated or
    non-dict file, or an injected fault (the next write replaces it
    atomically)."""
    try:
        fault_point("tune.cache.load")
        with open(_cache_path()) as f:
            data = json.load(f)
    except (OSError, ValueError, FaultInjected):
        return {}
    return data if isinstance(data, dict) else {}


def _cache_get(key: str):
    global _DISK
    with _LOCK:
        if key in _MEM_CACHE:
            _STATS["mem_hits"] += 1
            return _MEM_CACHE[key]
        if _DISK is None:
            _DISK = _load_disk()
        hit = _DISK.get(key)
        if hit is not None:
            _STATS["disk_hits"] += 1
            _MEM_CACHE[key] = hit
        else:
            _STATS["misses"] += 1
        return hit


def _cache_put(key: str, value) -> None:
    global _DISK
    with _LOCK:
        _STATS["writes"] += 1
        _MEM_CACHE[key] = value
        if _DISK is None:
            _DISK = {}
        _DISK[key] = list(value) if isinstance(value, tuple) else value
        path = _cache_path()
        try:
            fault_point("tune.cache.write")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                json.dump(_DISK, f, indent=0, sort_keys=True)
            os.replace(tmp, path)
        except (OSError, FaultInjected):
            # unwritable cache directory (or an injected disk fault):
            # the in-memory tier still serves
            _STATS["write_errors"] += 1


def _time(fn, device: torch.device) -> float:
    """Seconds of one call of ``fn`` after one warm-up call: CUDA events
    on the card, the host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def _record(key: str, timed: int, pruned: int, winner, t0: float,
            launches0: dict) -> None:
    now = launch_counts()
    with _LOCK:
        _PROBES.append({"key": key, "timed": timed, "pruned": pruned,
                        "winner": winner,
                        "seconds": time.perf_counter() - t0,
                        "launches": {k: now[k] - launches0[k]
                                     for k in now}})


def _probe_deadline_s() -> float:
    return float(os.environ.get("REPRO_TUNE_DEADLINE_S", "120"))


def _probe_retries() -> int:
    return int(os.environ.get("REPRO_TUNE_RETRIES", "2"))


def _probe_guarded(kernel: str, probe, default):
    """Run ``probe(in_time)`` behind the ``tune.probe`` fault site, with
    bounded retries and backoff; returns ``(winner, probed)``. The probe
    calls ``in_time()`` between candidates, which raises
    :class:`ProbeTimeout` once the attempt has run past the deadline.
    An injected fault, a timeout or an ``OSError`` is retried; when the
    attempts run out the tuner takes ``default`` (``probed=False``: the
    caller must not persist it). Any other exception propagates."""
    deadline, retries = _probe_deadline_s(), _probe_retries()
    for attempt in range(retries + 1):
        start = time.perf_counter()

        def in_time() -> None:
            if time.perf_counter() - start > deadline:
                raise ProbeTimeout(kernel, deadline)

        try:
            fault_point("tune.probe")
            return probe(in_time), True
        except (FaultInjected, ProbeTimeout, OSError) as e:
            timed_out = isinstance(e, ProbeTimeout)
            with _LOCK:
                _STATS["probe_timeouts" if timed_out
                       else "probe_failures"] += 1
            if attempt < retries:
                with _LOCK:
                    _STATS["probe_retries"] += 1
                note("retry.tune.probe", kernel=kernel,
                     attempt=attempt + 1, error=type(e).__name__)
                time.sleep(min(0.02 * (2 ** attempt), 0.5))
    with _LOCK:
        _STATS["probe_degraded"] += 1
    note("degraded.tune.probe", kernel=kernel, default=str(default))
    return default, False


def _ladder(key: str, cands, time_one, in_time, t0: float,
            launches0: dict) -> int:
    """Time ascending tile rungs until one lands ≥ _PRUNE× behind the
    incumbent; returns the winner."""
    best, best_t, timed = None, None, 0
    for c in cands:
        if timed:
            in_time()
        t = time_one(c)
        timed += 1
        if best_t is None or t < best_t:
            best, best_t = c, t
        elif t > _PRUNE * best_t:
            break
    _record(key, timed, len(cands) - timed, best, t0, launches0)
    return best


def _probe_and_keep(key: str, kernel: str, probe, default):
    """Probe under :func:`_probe_guarded`; write a probed winner to the
    cache (a default taken after failed probes stays off disk)."""
    with _LOCK:
        _STATS["probes"] += 1
    with region("tune.probe"):
        best, probed = _probe_guarded(kernel, probe, default)
    if probed:
        _cache_put(key, best)
    return best


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _ones(n: int, width: int, dtype, device) -> torch.Tensor:
    shape = (n,) if width == 1 else (n, width)
    return torch.ones(shape, dtype=dtype, device=device)


def _cached_int(key: str):
    hit = _cache_get(key)
    if hit is not None:
        try:
            return int(hit)
        except (TypeError, ValueError):
            pass        # poisoned cache entry: re-probe
    return None


def _layout_of(layout: tuple | None, n: int, d_ell: int, device,
               gen: torch.Generator) -> tuple:
    """``(idx, w, row_len, row_ptr)`` a pull probe reads: the graph's own
    (``layout``: ``(ell_idx, ell_w, row_len)``, or with the row layout's
    offsets as a fourth), else a random full dense layout of the shape,
    drawn from ``gen``."""
    if layout is not None:
        return tuple(layout) + (None,) * (4 - len(layout))
    idx = torch.randint(0, n + 1, (n, d_ell), generator=gen,
                        dtype=torch.int32, device=device)
    w = torch.ones((n, d_ell), dtype=torch.float32, device=device)
    return idx, w, None, None


def _layout_dims(layout: tuple | None, dims: tuple) -> tuple:
    """The tuner key's shape: the row layout is named in it."""
    rows = layout is not None and len(layout) > 3 and layout[3] is not None
    return dims + ("rows",) if rows else dims


def tune_pull(n: int, d_ell: int, width: int, dtype, combine: str,
              msg: str, device, layout: tuple | None = None) -> int:
    """Best ``block_n`` for an ELL pull of this shape on ``device``
    (shape-and-platform-keyed, persisted). With ``layout = (ell_idx,
    ell_w, row_len)``, the graph's own layout and in-degrees (or
    ``(coo_src, coo_w, row_len, in_ptr)``, its row layout, which the key
    names), the probe pulls it over its real slots, the work the kernel
    does on the path; else a random full layout, on which the rungs can
    tie where the graph's own rows set them apart."""
    device = torch.device(device)
    cands = pull_candidates(n, width)
    if len(cands) == 1:                   # nothing to probe
        return cands[0]
    key = _cache_key("pull", device, _layout_dims(layout, (n, d_ell)),
                     width, dtype, combine, msg)
    hit = _cached_int(key)
    if hit is not None:
        return hit

    def probe(in_time):
        t0, launches0 = time.perf_counter(), launch_counts()
        idx, w, row_len, row_ptr = _layout_of(layout, n, d_ell, device,
                                              _generator(device, 0))
        x = _ones(n + 1, width, dtype, device)
        plan = ell_row_plan(row_len, n, d_ell, width, device)
        return _ladder(key, cands, lambda b: _time(lambda: ell_spmv(
            x, idx, w, combine=combine, msg=msg, block_n=b, plan=plan,
            row_ptr=row_ptr, d_ell=d_ell), device), in_time, t0, launches0)

    return _probe_and_keep(key, "pull", probe, cands[0])


def tune_pull_frontier(n: int, d_ell: int, rows: int, width: int, dtype,
                       combine: str, msg: str, device,
                       layout: tuple | None = None) -> int:
    """Best ``block_r`` for a frontier pull of ``rows`` compacted rows
    (keyed on the row capacity on top of the usual shape key). With
    ``layout`` (as in :func:`tune_pull`), the graph's own layout and
    in-degrees, the probe pulls random rows of it over their real slots,
    the work the kernel does on the path; else a random full layout."""
    device = torch.device(device)
    cands = pull_frontier_candidates(n, rows)
    if len(cands) == 1:
        return cands[0]
    key = _cache_key("pullf", device, _layout_dims(layout, (n, d_ell, rows)),
                     width, dtype, combine, msg)
    hit = _cached_int(key)
    if hit is not None:
        return hit

    def probe(in_time):
        t0, launches0 = time.perf_counter(), launch_counts()
        gen = _generator(device, 2)
        idx, w, row_len, row_ptr = _layout_of(layout, n, d_ell, device, gen)
        x = _ones(n + 1, width, dtype, device)
        rids = torch.randperm(n, generator=gen, device=device)[:rows]
        rids = torch.cat([rids, rids.new_full((max(0, rows - n),), n)])
        rids = rids.to(torch.int32)
        return _ladder(key, cands, lambda b: _time(
            lambda: ell_pull_frontier(x, idx, w, rids, combine=combine,
                                      msg=msg, block_r=b, row_len=row_len,
                                      row_ptr=row_ptr, d_ell=d_ell),
            device), in_time, t0, launches0)

    return _probe_and_keep(key, "pullf", probe, cands[0])


def tune_push(n: int, m: int, width: int, dtype, combine: str, msg: str,
              device) -> tuple[int, int, str]:
    """Best ``(block_e, block_n, strategy)`` for a two-phase push of this
    shape: grid search with group pruning, persisted."""
    device = torch.device(device)
    cands = push_candidates(n, m)
    if len(cands) == 1:
        return cands[0]
    key = _cache_key("push", device, (n, m), width, dtype, combine, msg)
    hit = _cache_get(key)
    if hit is not None:
        try:
            be, bn, strat = hit
            return int(be), int(bn), str(strat)
        except (TypeError, ValueError):
            pass   # poisoned cache entry: fall through and re-probe

    def probe(in_time):
        t0, launches0 = time.perf_counter(), launch_counts()
        gen = _generator(device, 1)
        dst = torch.sort(torch.randint(0, n, (m,), generator=gen,
                                       dtype=torch.int32, device=device))[0]
        src = torch.randint(0, n, (m,), generator=gen, dtype=torch.int32,
                            device=device)
        w = torch.ones((m,), dtype=torch.float32, device=device)
        x = _ones(n, width, dtype, device)
        active = torch.ones((n,), dtype=torch.bool, device=device)
        host = (src.cpu().numpy(), dst.cpu().numpy(),
                np.ones(m, dtype=np.float32))
        plans: dict[int, object] = {}         # one plan per bin width
        best, best_t, timed = None, None, 0
        pruned: set[tuple[str, int]] = set()
        seen: set[tuple[str, int]] = set()
        for block_e, block_n, strategy in cands:
            group = (strategy, block_n)
            if group in pruned:
                continue
            if timed:
                in_time()
            if block_n not in plans:
                plans[block_n] = build_push_plan(*host, n, block_n,
                                                 device=device)
            t = _time(lambda: coo_push(
                x, active, src, dst, w, n, combine=combine, msg=msg,
                plan=plans[block_n], strategy=strategy, block_e=block_e),
                device)
            timed += 1
            first = group not in seen
            seen.add(group)
            if best_t is None or t < best_t:
                best, best_t = (block_e, block_n, strategy), t
            elif first and t > _PRUNE * best_t:
                pruned.add(group)  # the rest of the group only moves block_e
        _record(key, timed, len(pruned), list(best), t0, launches0)
        return best

    return _probe_and_keep(key, "push", probe, cands[0])
