"""Optimizers on parameter trees (port of ``repro.train.optimizer``):
AdamW and SGD with momentum, global-norm clipping and a warmup-cosine
schedule.

State is a tree shaped like the parameters (dicts and lists of
tensors, as ``models.common`` builds them). Differences from the
reference, none of which changes a result:

  * :func:`apply_updates` writes the new parameters and moments into
    the tensors it is given (``copy_``, ``mul_``, ``add_``) and returns
    the same objects. An in-place write moves a tensor's version
    counter, which is what the CIN kernel's weight-packing cache keys on
    (``kernels.cin.packed_weights``); ``p.data = ...`` would not move it
    and the kernel would go on with the old weights;
  * the step counter is a 0-dim int32 tensor on the parameters' device,
    and the learning rate stays on the device: a step reads nothing back
    to the host;
  * which leaves AdamW decays is a tree of bools (``decay``), by default
    the reference's rule, ndim >= 2. The reference applies that rule to
    its transformer's layers stacked on a leading [L] axis, so it decays
    their norm scales and biases too; the port's layers are a list, and
    ``models.transformer.decay_mask`` says the same thing for them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from ..graphs.structure import resolve_device
from ..models.common import tree_from_arrays, tree_leaves, tree_map

__all__ = ["OptConfig", "OptState", "init_opt", "apply_updates",
           "warmup_cosine", "global_norm", "opt_state_from_arrays"]


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    momentum: float = 0.9       # sgd


class OptState(NamedTuple):
    step: torch.Tensor
    mu: Any
    nu: Any


def _device(params: Any) -> torch.device:
    leaves = tree_leaves(params)
    return leaves[0].device if leaves else torch.device("cpu")


def init_opt(params: Any, cfg: OptConfig) -> OptState:
    """Zero moments in f32 shaped like ``params`` (SGD keeps a 0-dim
    ``nu`` per leaf, as the reference does)."""
    mu = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                        device=p.device), params)
    if cfg.kind == "adamw":
        nu = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params)
    else:
        nu = tree_map(lambda p: torch.zeros((), dtype=torch.float32,
                                            device=p.device), params)
    step = torch.zeros((), dtype=torch.int32, device=_device(params))
    return OptState(step=step, mu=mu, nu=nu)


def warmup_cosine(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate after ``step`` steps (a tensor or an int), as
    an f32 tensor on the step's device."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = s / max(1, cfg.warmup_steps)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(1, cfg.total_steps - cfg.warmup_steps),
                       0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, cos)


def global_norm(tree: Any) -> torch.Tensor:
    leaves = tree_leaves(tree)
    sq = torch.zeros((), dtype=torch.float32, device=_device(tree))
    for x in leaves:
        sq = sq + torch.sum(torch.square(x.float()))
    return torch.sqrt(sq)


@torch.no_grad()
def apply_updates(params: Any, grads: Any, state: OptState,
                  cfg: OptConfig, decay: Any = None
                  ) -> tuple[Any, OptState]:
    """One optimizer step, written in place into ``params`` and
    ``state`` (both returned). ``grads`` has the structure of
    ``params``; AdamW decays the leaves that ``decay`` (a tree of bools
    shaped like ``params``) marks, by default the matrices (ndim >= 2)."""
    state.step.add_(1)
    lr = warmup_cosine(cfg, state.step)
    gn = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-12),
                        max=1.0)
    ps, gs = tree_leaves(params), tree_leaves(grads)
    ms, vs = tree_leaves(state.mu), tree_leaves(state.nu)
    if not len(ps) == len(gs) == len(ms) == len(vs):
        raise ValueError(f"trees differ: {len(ps)} parameters, {len(gs)} "
                         f"gradients, {len(ms)} and {len(vs)} moments")
    if cfg.kind == "adamw":
        decays = ([p.ndim >= 2 for p in ps] if decay is None
                  else _bool_leaves(decay))
        t = state.step.to(torch.float32)
        bc1 = 1.0 - cfg.b1 ** t
        bc2 = 1.0 - cfg.b2 ** t
        for p, g, m, v, dec in zip(ps, gs, ms, vs, decays):
            g = g.float() * scale
            m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
            v.mul_(cfg.b2).add_(g.mul(1 - cfg.b2).mul_(g))
            delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            if cfg.weight_decay and dec:
                delta = delta + cfg.weight_decay * p.float()
            p.copy_(p.float() - lr * delta)
        return params, state
    if cfg.kind != "sgd":
        raise ValueError(f"unknown optimizer kind {cfg.kind!r}")
    for p, g, m in zip(ps, gs, ms):          # sgd + momentum
        m.mul_(cfg.momentum).add_(g.float() * scale)
        p.copy_(p.float() - lr * m)
    return params, state


def opt_state_from_arrays(step, mu: Any, nu: Any, device=None,
                          convert: Optional[Callable] = None) -> OptState:
    """The reference's ``OptState`` (its ``step``, ``mu`` and ``nu`` as
    numpy arrays) as this module's state on ``device``. ``convert``
    carries a moment tree across as the model's ``params_from_arrays``
    carries its weights (default: leaf for leaf,
    ``models.common.tree_from_arrays``); it is called as ``convert(tree,
    device)``. SGD's ``nu`` (a 0-dim zero per reference leaf, unused)
    becomes a 0-dim zero per leaf of the converted ``mu``."""
    dev = resolve_device(device)
    convert = convert or tree_from_arrays
    mu_t = convert(mu, dev)
    if all(np.asarray(a).ndim == 0 for a in _leaves(nu)):
        nu_t = tree_map(lambda m: torch.zeros((), dtype=torch.float32,
                                              device=m.device), mu_t)
    else:
        nu_t = convert(nu, dev)
    st = torch.tensor(np.asarray(step), dtype=torch.int32, device=dev)
    return OptState(step=st.reshape(()), mu=mu_t, nu=nu_t)


def _leaves(tree: Any) -> list:
    """The leaves of a nested dict / list / tuple (any type), in the
    order of ``models.common.tree_leaves``."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _bool_leaves(tree: Any) -> list[bool]:
    return [bool(x) for x in _leaves(tree)]
