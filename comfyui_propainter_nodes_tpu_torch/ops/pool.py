"""Pooling on [..., H, W, C] tensors."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _as_nchw(x: torch.Tensor):
    lead = x.shape[:-3]
    h, w, c = x.shape[-3:]
    return x.reshape(-1, h, w, c).permute(0, 3, 1, 2), lead


def max_pool2d(
    x: torch.Tensor,
    kernel_size: tuple[int, int],
    stride: tuple[int, int],
    padding: tuple[int, int] = (0, 0),
) -> torch.Tensor:
    """torch.nn.MaxPool2d (ceil_mode=False, -inf padding) on [..., H, W, C]."""
    xc, lead = _as_nchw(x)
    y = F.max_pool2d(xc, kernel_size, stride, padding).permute(0, 2, 3, 1)
    return y.reshape(lead + y.shape[1:])


def avg_pool2d(
    x: torch.Tensor, kernel_size: tuple[int, int], stride: tuple[int, int]
) -> torch.Tensor:
    """F.avg_pool2d (no padding, floor) on [..., H, W, C]."""
    xc, lead = _as_nchw(x)
    y = F.avg_pool2d(xc, kernel_size, stride).permute(0, 2, 3, 1)
    return y.reshape(lead + y.shape[1:])
