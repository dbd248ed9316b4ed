"""The benchmark's own arithmetic of peaks and minimal bytes.

Frozen copies, so that a later change to the program cannot move the
yardstick: the H100 SXM data-sheet peaks (dense rates, at the full 700 W
power limit; the values of ``repro_torch.kernels.roofline``) and the
least bytes a kernel's work needs, counted from the problem's sizes
(each input byte read once, each output byte written once), whatever
layout or kernel carries the work.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
BF16_OPS_PER_S = 989e12


def ell_spmv_min_bytes(n: int, m: int, width: int, item: int = 4,
                       weighted: bool = False) -> int:
    """Least bytes of one full-scan pull ``y[v] = combine over in-edges
    (u, v) of x[u]`` at ``width`` payload columns: each of the m real
    in-edge slots' source index (and its weight, for a message that
    reads one) once, the n row lengths once, the payload x [n, width]
    read once and y [n, width] written once."""
    per_slot = 4 + (4 if weighted else 0)
    return m * per_slot + n * 4 + 2 * n * width * item


def bytes_share(nbytes: float, seconds: float) -> float:
    """Percent of the HBM roofline that moving ``nbytes`` in ``seconds``
    reaches."""
    return 100.0 * nbytes / HBM_BYTES_PER_S / seconds
