"""Training losses: the reconstruction losses that fine-tune the
InpaintGenerator (port of the JAX package's `training/losses.py`).

`masked_l1` divides a sum by a sum plus 1e-8, added once after both sums.
Under data parallelism the sums are the global ones: `total` adds a
scalar over the data ranks (`parallel/sharding.py::reduce_from`, whose
backward is the identity), so every rank's loss is the global loss and
its gradient is the rank's share of the global gradient.
"""

from __future__ import annotations

import torch


def l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def masked_l1(pred, target, mask, total=None) -> torch.Tensor:
    """sum |pred - target| * mask / (sum mask * channels + 1e-8); total:
    the sum over the data ranks (None: one rank)."""
    num = torch.sum(torch.abs(pred - target) * mask)
    den = torch.sum(mask) * pred.shape[-1]
    if total is not None:
        num, den = total(num), total(den)
    return num / (den + 1e-8)


def reconstruction_loss(
    pred: torch.Tensor,
    target: torch.Tensor,
    mask: torch.Tensor,
    hole_weight: float = 1.0,
    valid_weight: float = 1.0,
    total=None,
) -> torch.Tensor:
    """Hole/valid-weighted L1 on [B, T, H, W, 3] frames in [-1, 1]."""
    hole = masked_l1(pred, target, mask, total)
    valid = masked_l1(pred, target, 1.0 - mask, total)
    return hole_weight * hole + valid_weight * valid
