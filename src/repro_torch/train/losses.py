"""Task losses shared by the launcher and the tests (port of
``repro.train.losses``): each a mean over the batch, in f32."""

from __future__ import annotations

import torch

__all__ = ["bce_with_logits", "mse", "softmax_xent_dense"]


def bce_with_logits(logits: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """Numerically stable sigmoid cross-entropy, mean over batch."""
    z = logits.float()
    y = labels.float()
    return torch.mean(torch.maximum(z, torch.zeros_like(z)) - z * y
                      + torch.log1p(torch.exp(-torch.abs(z))))


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    d = pred.float() - target.float()
    return torch.mean(d * d)


def softmax_xent_dense(logits: torch.Tensor,
                       labels: torch.Tensor) -> torch.Tensor:
    """Plain CE for small-vocab heads (GNN node classification)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    picked = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - picked)
