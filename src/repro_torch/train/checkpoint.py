"""Fault-tolerant checkpointing: async, atomic, CRC-checked. PyTorch port
of ``repro.train.checkpoint``.

Format (directory per step):
    ckpt_dir/step_000123.tmp-<nonce>/   (written, fsynced)
        arrays.npz        flattened path->array (host copies)
        manifest.json     {step, time, keys, dtypes, meta, crc, nbytes}
    -> atomic rename to ckpt_dir/step_000123/   (commit point)

* **Crash safety**: readers only ever see fully-committed directories;
  torn writes stay behind the ``.tmp-`` prefix and are
  garbage-collected.
* **Async**: :func:`save_async` copies every tensor to the host
  synchronously and writes in a daemon thread — the train loop never
  blocks on disk.
* **Restore**: arrays are read on the host and placed on the device and
  dtype of the matching leaf of ``like``.

Differences from the reference: the manifest is JSON (the reference's
is msgpack, which the port does not depend on), and it lists the
bfloat16 leaves, which ``arrays.npz`` holds as their int16 bits (numpy
has no bfloat16). A leaf's key is its path as ``jax.tree_util.keystr``
writes it (``['params']['layers'][0]['ln1']``). A full-width LM's state
is tens of GB, so the npz is written straight to its file (not built in
memory first), its CRC-32 is taken over pieces in parallel threads and
combined (the same value as one ``zlib.crc32`` over the whole file),
and :func:`restore`, having checked that CRC, reads each array from its
offset in the file without ``zipfile`` checking it a second time.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import struct
import threading
import time
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Optional

import numpy as np
import torch

__all__ = ["save", "save_async", "restore", "latest_step", "gc_tmp",
           "wait_pending"]

_PENDING: list[threading.Thread] = []
_MANIFEST = "manifest.json"


def _paths(tree: Any, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    """(key, tensor) of every leaf, dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _paths(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, t in enumerate(tree)
                for kv in _paths(t, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _snapshot(tree: Any) -> tuple[dict, dict]:
    """Host numpy copies of the leaves (copies even of CPU tensors: the
    loop goes on updating its tensors in place), and the keys of the
    bfloat16 ones (held as int16 bits)."""
    arrays, dtypes = {}, {}
    for key, leaf in _paths(tree):
        t = torch.as_tensor(leaf).detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
            dtypes[key] = "bfloat16"
        arrays[key] = t.to("cpu", copy=True).numpy()
    return arrays, dtypes


def save(ckpt_dir: str, step: int, tree: Any, meta: Optional[dict] = None
         ) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays, dtypes = _snapshot(tree)
    return _write(ckpt_dir, step, arrays, dtypes, meta or {})


def save_async(ckpt_dir: str, step: int, tree: Any,
               meta: Optional[dict] = None) -> threading.Thread:
    """Snapshot now (host copy), write in the background."""
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays, dtypes = _snapshot(tree)    # synchronous device->host copy
    t = threading.Thread(
        target=_write, args=(ckpt_dir, step, arrays, dtypes, meta or {}),
        daemon=True)
    t.start()
    _PENDING.append(t)
    return t


def wait_pending():
    for t in list(_PENDING):
        t.join()
        _PENDING.remove(t)


# CRC-32 over pieces of a file in parallel threads (zlib.crc32 releases
# the interpreter lock), combined as zlib's crc32_combine does: shifting
# a CRC over n zero bytes is a linear map over GF(2), a 32 x 32 matrix
# (here a list of 32 column bit masks)
_CRC_PIECE = 1 << 24
_CRC_POLY = 0xEDB88320


def _gf2_times(mat: list, vec: int) -> int:
    out, i = 0, 0
    while vec:
        if vec & 1:
            out ^= mat[i]
        vec >>= 1
        i += 1
    return out


def _gf2_mul(a: list, b: list) -> list:
    return [_gf2_times(a, col) for col in b]


def _zeros_op(nbytes: int) -> list:
    """The matrix that carries a CRC over ``nbytes`` zero bytes."""
    one_bit = [_CRC_POLY] + [1 << n for n in range(31)]
    op = one_bit
    for _ in range(3):                       # 8 bits: one zero byte
        op = _gf2_mul(op, op)
    out = [1 << n for n in range(32)]        # identity
    while nbytes:
        if nbytes & 1:
            out = _gf2_mul(op, out)
        op = _gf2_mul(op, op)
        nbytes >>= 1
    return out


def _crc_file(path: str) -> int:
    """``zlib.crc32`` of the file's bytes, its pieces read and summed by
    one thread per core."""
    size = os.path.getsize(path)
    pieces = [(off, min(_CRC_PIECE, size - off))
              for off in range(0, size, _CRC_PIECE)]
    fd = os.open(path, os.O_RDONLY)
    try:
        with ThreadPoolExecutor(os.cpu_count() or 1) as ex:
            crcs = list(ex.map(
                lambda p: zlib.crc32(os.pread(fd, p[1], p[0])), pieces))
    finally:
        os.close(fd)
    ops = {n: _zeros_op(n) for n in {n for _, n in pieces}}
    crc = 0
    for (_, n), c in zip(pieces, crcs):
        crc = _gf2_times(ops[n], crc) ^ c
    return crc & 0xFFFFFFFF


def _write(ckpt_dir: str, step: int, arrays: dict, dtypes: dict,
           meta: dict) -> str:
    nonce = f"{os.getpid()}-{int(time.time() * 1e6) % 10**9}"
    final = os.path.join(ckpt_dir, f"step_{step:09d}")
    tmp = final + f".tmp-{nonce}"
    os.makedirs(tmp, exist_ok=True)
    npz = os.path.join(tmp, "arrays.npz")
    with open(npz, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    manifest = {
        "step": step,
        "time": time.time(),
        "keys": list(arrays.keys()),
        "dtypes": dtypes,
        "meta": meta,
        "crc": _crc_file(npz),
        "nbytes": os.path.getsize(npz),
    }
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.isdir(final):
        shutil.rmtree(final)
    os.rename(tmp, final)            # commit point
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = []
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and _valid(os.path.join(ckpt_dir, name)):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def _manifest(path: str) -> dict:
    with open(os.path.join(path, _MANIFEST)) as f:
        return json.load(f)


def _valid(path: str) -> bool:
    try:
        man = _manifest(path)
        return _crc_file(os.path.join(path, "arrays.npz")) == man["crc"]
    except (OSError, ValueError, KeyError):
        return False


def _read_arrays(npz: str) -> dict:
    """Every array of an npz whose CRC was checked: each read from its
    member's data offset (np.savez stores members uncompressed), so
    ``zipfile`` does not sum the bytes again."""
    out = {}
    with zipfile.ZipFile(npz) as zf, open(npz, "rb") as raw:
        for info in zf.infolist():
            raw.seek(info.header_offset)
            local = raw.read(30)                 # the local file header
            if local[:4] != b"PK\x03\x04" or info.compress_type != \
                    zipfile.ZIP_STORED:
                raise ValueError(f"{npz}: {info.filename} is not a "
                                 "stored npz member")
            name_len, extra_len = struct.unpack("<HH", local[26:30])
            raw.seek(info.header_offset + 30 + name_len + extra_len)
            out[info.filename.removesuffix(".npy")] = \
                np.lib.format.read_array(raw)
    return out


def restore(ckpt_dir: str, step: int, like: Any) -> tuple[Any, dict]:
    """Restore into the structure of ``like``: every leaf a new tensor
    with the device and dtype of ``like``'s leaf. Returns (tree, meta)."""
    path = os.path.join(ckpt_dir, f"step_{step:09d}")
    if not _valid(path):
        raise IOError(f"checkpoint {path} missing or corrupt")
    man = _manifest(path)
    bf16 = man.get("dtypes", {})
    data = _read_arrays(os.path.join(path, "arrays.npz"))
    leaves = {}
    for key, leaf in _paths(like):
        if key not in data:
            raise KeyError(f"checkpoint missing leaf {key}")
        t = torch.from_numpy(data.pop(key))
        if bf16.get(key) == "bfloat16":
            t = t.view(torch.bfloat16)
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(
                f"{key}: checkpoint shape {tuple(t.shape)} != "
                f"{tuple(leaf.shape)}")
        leaves[key] = t.to(device=leaf.device, dtype=leaf.dtype)
    return _fill(like, leaves), man["meta"]


def _fill(tree: Any, leaves: dict, prefix: str = "") -> Any:
    if isinstance(tree, dict):
        return {k: _fill(v, leaves, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_fill(t, leaves, f"{prefix}[{i}]")
                          for i, t in enumerate(tree))
    return leaves[prefix]


def gc_tmp(ckpt_dir: str, keep_last: int = 3):
    """Remove torn writes and old steps beyond ``keep_last``."""
    if not os.path.isdir(ckpt_dir):
        return
    for name in os.listdir(ckpt_dir):
        if ".tmp-" in name:
            shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)
    steps = sorted(
        int(m.group(1)) for m in
        (re.fullmatch(r"step_(\d+)", n) for n in os.listdir(ckpt_dir)) if m)
    for s in steps[:-keep_last]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:09d}"),
                      ignore_errors=True)
