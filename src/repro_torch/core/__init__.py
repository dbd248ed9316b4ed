from .backend import (CudaBackend, DenseBackend, EllBackend,
                      ExchangeBackend, classify_msg_fn, require_backend)
from .cost_model import (DEFAULT_WEIGHTS, Cost, CostPredictor, CostWeights,
                         StepStats, StepTrace, counter, zero_cost)
from .direction import (AutoSwitch, Direction, DirectionPolicy, Fixed,
                        GenericSwitch, GreedySwitch)
from .engine import (EngineResult, Phase, PhaseProgram, PushPullEngine,
                     VertexProgram)
from .linalg import (MIN_PLUS, OR_AND, PLUS_TIMES, Semiring, spmspv_push,
                     spmv_pull)
from .primitives import (combine_identity, frontier_in_edges,
                         frontier_out_edges, k_filter, mask_untouched,
                         pull_relax, pull_relax_ell, push_relax)

__all__ = [
    "CudaBackend", "DenseBackend", "EllBackend", "ExchangeBackend",
    "classify_msg_fn", "require_backend", "Cost", "CostPredictor",
    "CostWeights", "DEFAULT_WEIGHTS", "StepStats", "StepTrace", "counter", "zero_cost",
    "AutoSwitch", "Direction", "DirectionPolicy", "Fixed", "GenericSwitch",
    "GreedySwitch", "EngineResult", "Phase", "PhaseProgram",
    "PushPullEngine", "VertexProgram", "Semiring", "PLUS_TIMES",
    "MIN_PLUS", "OR_AND", "spmv_pull", "spmspv_push", "combine_identity",
    "frontier_in_edges", "frontier_out_edges", "k_filter",
    "mask_untouched", "pull_relax", "pull_relax_ell", "push_relax",
]
