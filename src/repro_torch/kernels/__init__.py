"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version. Importing this package builds nothing: a kernel's
library is compiled at its first launch (or by ``_build.build_all``)."""

from ._build import (KERNELS, build_all, launch_counts,
                     reset_launch_counts)
from .coo_push import PushBinPlan, build_push_plan, coo_push
from .ell_pull_frontier import (default_pull_cap, ell_pull_frontier,
                                ell_pull_frontier_full, frontier_rows)
from .ell_spmv import ell_spmv
from .layout import DualEllLayout, build_dual_ell, touched_out_mask
from .ops import cin_layer, flash_attention

__all__ = ["KERNELS", "build_all", "launch_counts", "reset_launch_counts",
           "PushBinPlan", "build_push_plan", "coo_push", "default_pull_cap",
           "ell_pull_frontier", "ell_pull_frontier_full", "frontier_rows",
           "ell_spmv", "DualEllLayout", "build_dual_ell",
           "touched_out_mask", "flash_attention", "cin_layer"]
