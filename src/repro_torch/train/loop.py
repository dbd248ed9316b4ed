"""Training loop: checkpoint/restart, straggler watchdog, compressed DP.
PyTorch port of ``repro.train.loop``.

`TrainLoop`:

  * owns a copy of the parameters (leaves that require grad), updated
    in place by :func:`~repro_torch.train.optimizer.apply_updates`;
  * resumes from the latest valid checkpoint automatically (crash =
    restart the launcher, nothing else);
  * async checkpoints every `ckpt_every` steps + terminal sync save;
  * a step-time watchdog maintains a robust running median and flags
    stragglers (steps > `straggler_factor` x median);
  * optional gradient compression with error feedback (dist.compression);
  * microbatch gradient accumulation (dist.overlap).

Each batch (host tensors, as ``data.pipeline`` makes them) is moved to
the parameters' device before its step's clock starts; a step's ``dt``
ends in a synchronize on the loss's device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Optional

import torch

from ..dist.compression import (CompressionConfig, compress_tree,
                                init_error_state)
from ..dist.overlap import microbatch_grads, value_and_grad
from ..models.common import tree_leaves, tree_map
from . import checkpoint as ckpt
from .optimizer import OptConfig, OptState, apply_updates, init_opt

__all__ = ["LoopConfig", "Watchdog", "TrainLoop"]


@dataclasses.dataclass
class LoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    log_every: int = 10
    num_micro: int = 1
    straggler_factor: float = 3.0
    compression: CompressionConfig = dataclasses.field(
        default_factory=CompressionConfig)


class Watchdog:
    """Robust step-time tracker; flags straggler steps."""

    def __init__(self, factor: float = 3.0, window: int = 64):
        self.factor = factor
        self.window = window
        self.times: list[float] = []
        self.stragglers: list[tuple[int, float]] = []

    def observe(self, step: int, dt: float) -> bool:
        hist = self.times[-self.window:]
        is_straggler = False
        if len(hist) >= 8:
            med = sorted(hist)[len(hist) // 2]
            is_straggler = dt > self.factor * med
        if is_straggler:
            self.stragglers.append((step, dt))
        self.times.append(dt)
        return is_straggler

    @property
    def median(self) -> float:
        if not self.times:
            return 0.0
        s = sorted(self.times[-self.window:])
        return s[len(s) // 2]


def _trainable(t: torch.Tensor) -> torch.Tensor:
    return t.requires_grad_() if t.is_floating_point() else t


class TrainLoop:
    """``loss_fn(params, batch)`` -> a scalar loss tensor. ``decay``
    marks the leaves AdamW decays (see ``apply_updates``)."""

    def __init__(self, loss_fn: Callable, params: Any, opt_cfg: OptConfig,
                 loop_cfg: LoopConfig, decay: Any = None):
        self.loss_fn = loss_fn
        self.loop_cfg = loop_cfg
        self.opt_cfg = opt_cfg
        self.decay = decay
        # own our copy: the step updates it in place, and the caller's
        # tree must stay usable (e.g. to seed another loop)
        self.params = tree_map(lambda p: _trainable(p.detach().clone()),
                               params)
        self.device = tree_leaves(self.params)[0].device
        self.opt_state = init_opt(self.params, opt_cfg)
        self.err_state = (init_error_state(self.params)
                          if loop_cfg.compression.kind != "none" else None)
        self.start_step = 0
        self.watchdog = Watchdog(loop_cfg.straggler_factor)
        self.history: list[dict] = []
        self._maybe_resume()

    # ------------------------------------------------------------------
    def _step(self, batch) -> torch.Tensor:
        comp = self.loop_cfg.compression
        if self.loop_cfg.num_micro > 1:
            grads, loss = microbatch_grads(self.loss_fn, self.params, batch,
                                           self.loop_cfg.num_micro)
        else:
            loss, grads = value_and_grad(self.loss_fn, self.params, batch)
        if comp.kind != "none":
            grads, self.err_state = compress_tree(grads, self.err_state,
                                                  comp)
        apply_updates(self.params, grads, self.opt_state, self.opt_cfg,
                      self.decay)
        return loss

    # ------------------------------------------------------------------
    def _state_tree(self):
        tree = {"params": self.params, "opt": self.opt_state._asdict()}
        if self.err_state is not None:
            tree["err"] = self.err_state
        return tree

    def _maybe_resume(self):
        cfg = self.loop_cfg
        if cfg.ckpt_dir is None:
            return
        step = ckpt.latest_step(cfg.ckpt_dir)
        if step is None:
            return
        restored, meta = ckpt.restore(cfg.ckpt_dir, step,
                                      self._state_tree())
        self.params = tree_map(_trainable, restored["params"])
        self.opt_state = OptState(**restored["opt"])
        if self.err_state is not None:
            self.err_state = restored["err"]
        self.start_step = int(meta.get("next_step", step))

    # ------------------------------------------------------------------
    def run(self, batch_iter, steps: Optional[int] = None) -> dict:
        cfg = self.loop_cfg
        total = steps if steps is not None else cfg.total_steps
        step = self.start_step
        last_loss = None
        while step < total:
            batch = tree_map(lambda t: torch.as_tensor(t).to(self.device),
                             next(batch_iter))
            t0 = time.perf_counter()
            loss = self._step(batch)
            if loss.device.type == "cuda":
                torch.cuda.synchronize(loss.device)
            dt = time.perf_counter() - t0
            step += 1
            straggler = self.watchdog.observe(step, dt)
            last_loss = float(loss)
            if step % cfg.log_every == 0 or straggler:
                self.history.append(
                    {"step": step, "loss": last_loss, "dt": dt,
                     "straggler": straggler})
            if cfg.ckpt_dir and step % cfg.ckpt_every == 0:
                ckpt.save_async(cfg.ckpt_dir, step, self._state_tree(),
                                meta={"next_step": step})
        if cfg.ckpt_dir:
            ckpt.wait_pending()      # async writers finish before GC/final
            ckpt.save(cfg.ckpt_dir, step, self._state_tree(),
                      meta={"next_step": step})
            ckpt.gc_tmp(cfg.ckpt_dir)
        return {"final_step": step, "final_loss": last_loss,
                "stragglers": self.watchdog.stragglers,
                "median_dt": self.watchdog.median,
                "history": self.history}
