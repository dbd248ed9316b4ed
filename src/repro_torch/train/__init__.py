"""Training (port of ``repro.train``): losses, AdamW and SGD on
parameter trees, checkpoints, and the training loop."""

from .optimizer import (OptConfig, OptState, apply_updates, init_opt,
                        opt_state_from_arrays, warmup_cosine)
from .loop import LoopConfig, TrainLoop, Watchdog
from .losses import bce_with_logits, mse, softmax_xent_dense
from . import checkpoint

__all__ = [
    "OptConfig", "OptState", "init_opt", "apply_updates", "warmup_cosine",
    "opt_state_from_arrays",
    "LoopConfig", "TrainLoop", "Watchdog",
    "bce_with_logits", "mse", "softmax_xent_dense",
    "checkpoint",
]
