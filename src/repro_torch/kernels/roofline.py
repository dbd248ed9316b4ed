"""The H100's peak rates, the least time a kernel's work could take on
it, the work each model kernel does (which the dry run counts where a
launch would be), and the CUDA-event timer that the kernel tables are
measured with.

``chip_smoke.py`` imports this module by name; ``profile_kernels.py``
loads it by its path, so that the tree it times (``--src``, perhaps an
earlier commit without this file) is held to the same bounds. It
imports nothing of the package; :func:`time_ms` needs a CUDA device
when it is called, nothing else does.
"""

from __future__ import annotations

import statistics

import torch

# H100 SXM data-sheet peaks (dense, at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
BF16_OPS_PER_S = 989e12
# NVLink 4 per card and direction (18 links of 25 GB/s)
NVLINK_BYTES_PER_S = 450e9
# device memory ("80 GB"; CUDA reports ~85.0e9 bytes usable) and SMs
HBM_CAPACITY_BYTES = 80e9
SMS = 132
# destination rows of one tile of the one-hot push's products
ONEHOT_TILE = 64


def bound(nbytes: float, ops: float,
          rate: float = F32_OPS_PER_S) -> tuple[float, str]:
    """The card's least time for the work, in ms: bytes over the memory
    rate or operations over ``rate`` (their type's peak), the larger,
    and which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def push_bytes(m: int, n: int, width: int, nb: int, bin_n: int,
               item: int = 4) -> int:
    """Bytes a push of a copy message must move: the m int32 sources (a
    copy reads no weight), the plan's per-bin pointers, the n active
    flags, and the payload read and the output written once."""
    return m * 4 + nb * (bin_n + 1) * 4 + n + 2 * n * width * item


def onehot_floor_ms(m: int, width: int) -> float:
    """The one-hot push design's own floor: each edge against its
    64-row destination tile, in four TF32 products (its four aligned
    parts), two FLOP each."""
    return 8 * m * ONEHOT_TILE * width / TF32_OPS_PER_S * 1e3


def cin_tf32_floor_ms(B: int, H: int, Hp: int, F: int, D: int) -> float:
    """The CIN kernel's own floor: its 2 * B * H * Hp * F * D FLOP three
    times over (hi * hi, hi * lo and lo * hi TF32 products) at the TF32
    rate."""
    return 3 * 2 * B * H * Hp * F * D / TF32_OPS_PER_S * 1e3


def flash_pairs(T: int, window: int) -> int:
    """(query, key) pairs the causal window keeps over T positions."""
    w = min(window, T)
    return w * (w + 1) // 2 + (T - w) * w


def flash_work(B: int, T: int, H: int, Hk: int, d: int, window: int,
               item: int) -> tuple[int, int]:
    """(bytes, operations) of causal attention: q and the output once,
    each KV head's K and V once; two products over the kept pairs."""
    nbytes = (2 * B * T * H * d + 2 * B * T * Hk * d) * item
    return nbytes, 4 * d * B * H * flash_pairs(T, window)


def flash_bwd_work(B: int, T: int, H: int, Hk: int, d: int, window: int,
                   item: int) -> tuple[int, int]:
    """(bytes, operations) of causal attention's gradient: q, out, dout
    read and dq written once, each KV head's K, V read and dK, dV written
    once, plus the f32 row logsumexp and D = rowsum(dO ∘ out); five
    products over the kept pairs (S, dP, dV, dK, dQ), whatever a design
    recomputes."""
    nbytes = ((4 * B * T * H * d + 4 * B * T * Hk * d) * item
              + 2 * B * H * T * 4)
    return nbytes, 10 * d * B * H * flash_pairs(T, window)


def cin_work(B: int, H: int, Hp: int, F: int, D: int,
             item: int) -> tuple[int, int]:
    """(bytes, operations) of one CIN layer: xk, x0 and w read once, the
    output written once; a multiply and an add per (b, h, i, j, d)."""
    return ((B * Hp * D + B * F * D + H * Hp * F + B * H * D) * item,
            2 * B * H * Hp * F * D)


def cin_bwd_work(which: str, B: int, H: int, Hp: int, F: int, D: int,
                 item: int) -> tuple[int, int]:
    """(bytes, operations) of one of a CIN layer's backward kernels, a
    multiply and an add per (b, h, i, j, d) each: ``"dw"`` reads g, xk
    and x0 once and writes dw [H, Hp, F] in f32 once; ``"dx0"`` reads g,
    xk and w once and writes dx0 [B, F, D] once."""
    ops = 2 * B * H * Hp * F * D
    if which == "dw":
        return (B * H * D + B * Hp * D + B * F * D) * item + H * Hp * F * 4, ops
    if which == "dx0":
        return (B * H * D + B * Hp * D + H * Hp * F + B * F * D) * item, ops
    raise ValueError(f"cin_bwd_work: which is 'dw' or 'dx0', not {which!r}")


def time_ms(fn, reps: int, flush: torch.Tensor | None = None) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` launches, each after
    a 256 MB write that evicts the 50 MB L2 cache (``flush``, or a buffer
    made for this call)."""
    if flush is None:
        flush = torch.empty(1 << 28, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)
