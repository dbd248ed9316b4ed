"""Three-term roofline of a dry run, priced on one NVIDIA H100. PyTorch
port of ``repro.roofline.analysis``.

    compute term    = FLOPs / 989e12 FLOP/s (bf16 tensor cores)
    memory term     = bytes accessed / 3.35e12 B/s (HBM3)
    collective term = wire bytes / 450e9 B/s (NVLink, one direction)

The reference prices a compiled XLA program per partition on a TPU: its
``cost_analysis()`` FLOPs and bytes, and collective bytes parsed from the
HLO (``collective_bytes_from_hlo``, which has no counterpart here). A
PyTorch program has no compiled artifact: the port's dry run
(``launch.dryrun``) counts the FLOPs, bytes and collectives of the
whole program as one controller runs it, and the three terms price that
whole program on one card. The peaks are ``kernels.roofline``'s, the one
source of the H100's rates.
"""

from __future__ import annotations

from ..kernels.roofline import (BF16_OPS_PER_S, F32_OPS_PER_S,
                                HBM_BYTES_PER_S, NVLINK_BYTES_PER_S)

__all__ = ["HW", "roofline_report", "model_flops", "kernel_roofline"]

HW = {
    "peak_flops": BF16_OPS_PER_S,     # bf16 dense, tensor cores
    "f32_flops": F32_OPS_PER_S,       # f32 on the CUDA cores
    "hbm_bw": HBM_BYTES_PER_S,        # bytes/s
    "link_bw": NVLINK_BYTES_PER_S,    # bytes/s per direction
}


def model_flops(kind: str, **kw) -> float:
    """Useful-work estimate: 6·N·D for dense LM training (fwd+bwd),
    2·N·D for inference; N = params touched per token (active for MoE)."""
    n_active = kw["n_active_params"]
    tokens = kw["tokens"]
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_active * tokens


def kernel_roofline(direction: str, *, n: int, d_ell: int = 0,
                    batch: int = 1, itemsize: int = 4, nb: int = 1,
                    cap: int = 0, bin_n: int = 0,
                    measured_us: float = 0.0) -> dict:
    """Analytic roofline bound for one graph-kernel launch.

    Counts the bytes the kernel's tiling *must* move (graph structure +
    payload gathers + destination writes, assuming perfect reuse of
    on-chip blocks) and the combine FLOPs, prices them on the card (the
    graph payloads are f32: the f32 rate), and reports ``pct_roofline =
    bound_us / measured_us`` — the fraction of the hardware bound
    actually achieved. ``pull`` is the ELL gather (``n × d_ell``
    rectangular layout); ``pullf`` the frontier-restricted gather over
    ``rows`` compacted destinations (pass the padded row capacity as
    ``n`` — only those ELL rows are read and written); ``push`` is the
    two-phase bin reduce (``nb × cap`` padded edge bins + per-bin run
    pointers + ``nb × bin_n`` accumulators). The ratio is clamped to
    the schema's 1.5 ceiling — anything past ~1.0 means timing noise,
    not physics.
    """
    if direction in ("pull", "pullf"):
        bytes_moved = (n * d_ell * (4 + 4)              # ELL idx + w
                       + n * d_ell * batch * itemsize   # payload gather
                       + n * batch * itemsize)          # dst writes
        flops = n * d_ell * batch
        if direction == "pullf":
            bytes_moved += n * 4                        # compacted row ids
    else:
        bytes_moved = (nb * cap * (4 + 4 + 4)           # src / dst / w
                       + nb * cap * batch * itemsize    # payload gather
                       + nb * (bin_n + 1) * 4           # run pointers
                       + nb * bin_n * batch * itemsize)  # accumulators
        flops = nb * cap * batch
    bound_us = 1e6 * max(flops / HW["f32_flops"],
                         bytes_moved / HW["hbm_bw"])
    return {"bytes_moved": int(bytes_moved), "flops": int(flops),
            "bound_us": bound_us,
            "pct_roofline": min(bound_us / max(measured_us, 1e-9), 1.5)}


def roofline_report(result: dict, loop_factor: int = 1) -> dict:
    """Attach the three terms (seconds) + dominant bottleneck to a dry-run
    result dict.

    loop_factor: the reference multiplies by its scan's trip count,
    since XLA counts a while-loop body once. The port's layer loop runs
    in Python, so the dry run sees every layer: its callers pass 1.
    """
    flops = (result["cost"]["flops"] or 0.0) * loop_factor
    bytes_acc = (result["cost"]["bytes_accessed"] or 0.0) * loop_factor
    coll_bytes = result["collectives"]["total_bytes"] * loop_factor
    t_compute = flops / HW["peak_flops"]
    t_memory = bytes_acc / HW["hbm_bw"]
    t_coll = coll_bytes / HW["link_bw"]
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll}
    dominant = max(terms, key=lambda k: terms[k])
    bound = max(terms.values())
    total = max(1e-30, bound)
    return {
        **terms,
        "loop_factor": loop_factor,
        "dominant": dominant.replace("_s", ""),
        "bound_s": bound,
        "compute_fraction_of_bound": t_compute / total,
    }
