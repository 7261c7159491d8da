"""Overlapping-patch unfold / fold on NHWC tensors.

unfold returns [N, oh, ow, kh, kw, C] (the JAX package's ordering, not
torch's channel-major one); fold is its adjoint (overlap-add).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _out_size(size: int, k: int, s: int, p: int) -> int:
    return (size + 2 * p - (k - 1) - 1) // s + 1


def unfold(
    x: torch.Tensor,
    kernel_size: tuple[int, int],
    stride: tuple[int, int],
    padding: tuple[int, int],
) -> torch.Tensor:
    """[N, H, W, C] -> [N, oh, ow, kh, kw, C]."""
    n, h, w, c = x.shape
    (kh, kw), (sh, sw), (ph, pw) = kernel_size, stride, padding
    oh = _out_size(h, kh, sh, ph)
    ow = _out_size(w, kw, sw, pw)
    xp = F.pad(x, (0, 0, pw, pw, ph, ph))
    rows = []
    for ki in range(kh):
        cols = [
            xp[:, ki : ki + sh * (oh - 1) + 1 : sh, kj : kj + sw * (ow - 1) + 1 : sw, :]
            for kj in range(kw)
        ]
        rows.append(torch.stack(cols, dim=3))
    return torch.stack(rows, dim=3)


def fold(
    patches: torch.Tensor,
    output_size: tuple[int, int],
    kernel_size: tuple[int, int],
    stride: tuple[int, int],
    padding: tuple[int, int],
) -> torch.Tensor:
    """Adjoint of `unfold`: [N, oh, ow, kh, kw, C] -> [N, H, W, C]."""
    n, oh, ow, kh, kw, c = patches.shape
    h, w = output_size
    (sh, sw), (ph, pw) = stride, padding
    hp = max(h + 2 * ph, sh * (oh - 1) + kh)
    wp = max(w + 2 * pw, sw * (ow - 1) + kw)
    canvas = patches.new_zeros((n, hp, wp, c))
    for ki in range(kh):
        for kj in range(kw):
            canvas[:, ki : ki + sh * (oh - 1) + 1 : sh, kj : kj + sw * (ow - 1) + 1 : sw] += (
                patches[:, :, :, ki, kj]
            )
    return canvas[:, ph : ph + h, pw : pw + w]


def fold_normalizer(
    n_tokens_hw: tuple[int, int],
    output_size: tuple[int, int],
    kernel_size: tuple[int, int],
    stride: tuple[int, int],
    padding: tuple[int, int],
    dtype=torch.float32,
) -> torch.Tensor:
    """Per-pixel overlap count fold(ones): [H, W, 1]."""
    oh, ow = n_tokens_hw
    kh, kw = kernel_size
    ones = torch.ones((1, oh, ow, kh, kw, 1), dtype=dtype)
    return fold(ones, output_size, kernel_size, stride, padding)[0]
