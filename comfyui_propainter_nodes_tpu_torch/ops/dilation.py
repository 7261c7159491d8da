"""Binary mask morphology on the device.

scipy's `binary_dilation` with its default structuring element (the
4-connected cross) for k iterations is k rounds of a cross-shaped max
(reference utils/image_utils.py:156-165), batched over all frames.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _cross_dilate(m: torch.Tensor) -> torch.Tensor:
    """One 4-connected dilation step. m: [..., H, W] float {0, 1}."""
    up = F.pad(m[..., 1:, :], (0, 0, 0, 1))
    down = F.pad(m[..., :-1, :], (0, 0, 1, 0))
    left = F.pad(m[..., :, 1:], (0, 1))
    right = F.pad(m[..., :, :-1], (1, 0))
    return torch.maximum(m, torch.maximum(torch.maximum(up, down), torch.maximum(left, right)))


def binary_dilation(mask: torch.Tensor, iterations: int) -> torch.Tensor:
    """Iterated 4-connected dilation of a {0,1} mask [..., H, W]."""
    m = (mask > 0).to(mask.dtype)
    for _ in range(iterations):
        m = _cross_dilate(m)
    return m


def binarize(mask: torch.Tensor, threshold: float = 0.1) -> torch.Tensor:
    """Threshold binarization (reference utils/image_utils.py:119-123)."""
    return (mask > threshold).to(mask.dtype)
