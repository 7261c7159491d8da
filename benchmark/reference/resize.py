"""Pillow's bicubic resize of 8-bit images, written out.

ProPainter's own preparation resizes each frame and mask with PIL
(`Image.resize((w, h))`, bicubic). This is Pillow's `Resample.c` for 8
bits a channel: Keys' cubic with a = -0.5, support 2 widened by the
downscale ratio, each output's weights normalised to sum 1 and stored
as integers of 22 fractional bits (rounded half away from zero); a
horizontal pass, stored as bytes (+ half, shift, clip), then a vertical
pass over those bytes. A pass whose size does not change is skipped.
The sums are exact in float64 (bytes times 23-bit weights over a few
dozen taps), so the products run as float64 matrices on any device.
"""

from __future__ import annotations

import math

import torch

PRECISION_BITS = 22


def _cubic(x: float, a: float = -0.5) -> float:
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0
    if x < 2.0:
        return (((x - 5.0) * x + 8.0) * x - 4.0) * a
    return 0.0


def weights(in_size: int, out_size: int) -> torch.Tensor:
    """[out_size, in_size] float64 matrix of Pillow's integer weights."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    mat = torch.zeros((out_size, in_size), dtype=torch.float64)
    for i in range(out_size):
        center = (i + 0.5) * scale
        xmin = max(0, int(center - support + 0.5))
        xmax = min(in_size, int(center + support + 0.5))
        k = [_cubic((x - center + 0.5) / filterscale) for x in range(xmin, xmax)]
        total = sum(k)
        for j, v in enumerate(k):
            v = v / total if total else v
            f = v * (1 << PRECISION_BITS)
            mat[i, xmin + j] = math.trunc(f - 0.5) if v < 0 else math.trunc(f + 0.5)
    return mat


def _store(acc: torch.Tensor) -> torch.Tensor:
    """Pillow's clip8: (half + sum) >> bits, clipped to a byte."""
    return torch.clamp(torch.floor((acc + float(1 << (PRECISION_BITS - 1))) / float(1 << PRECISION_BITS)), 0, 255)


def resize(stack: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """[T, H, W] or [T, H, W, C] bytes (any dtype holding 0..255) ->
    [T, out_h, out_w(, C)] bytes as float32, as PIL resizes each frame."""
    t, h, w = stack.shape[:3]
    x = stack.to(torch.float64)
    squeeze = x.ndim == 3
    if squeeze:
        x = x[..., None]
    if w != out_w:
        x = _store(torch.einsum("thwc,ow->thoc", x, weights(w, out_w).to(x.device)))
    if h != out_h:
        x = _store(torch.einsum("thwc,oh->towc", x, weights(h, out_h).to(x.device)))
    x = x.to(torch.float32)
    return x[..., 0] if squeeze else x
