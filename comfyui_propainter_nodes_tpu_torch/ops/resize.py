"""Exact torch `F.interpolate` semantics on [..., H, W, C] tensors.

Three flavours are used by the models: bilinear align_corners=True
(decoders, upflow8), bilinear align_corners=False (flow downsampling)
and nearest (mask downsampling). Tap tables are built on the host
(numpy, cached) and applied as index gathers along one axis at a time.

Where the JAX package's phase plan is small it sums folded weighted
taps (`w0*v0 + w1*v1`, with both taps folded into one weight when they
hit the same source row); elsewhere it lerps (`v0 + (v1 - v0)*w1`).
The port reproduces that choice per axis, so both packages round alike.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


@functools.lru_cache(maxsize=256)
def _linear_taps(in_size: int, out_size: int, align_corners: bool):
    if align_corners and out_size > 1:
        src = np.arange(out_size, dtype=np.float64) * (in_size - 1) / (out_size - 1)
    else:
        scale = in_size / out_size
        src = np.maximum((np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5, 0.0)
    i0 = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
    i1 = np.minimum(i0 + 1, in_size - 1)
    w1 = (src - i0).astype(np.float32)
    return i0, i1, w1


@functools.lru_cache(maxsize=256)
def _nearest_indices(in_size: int, out_size: int):
    """Torch 'nearest' source indices: floor(i * in/out)."""
    idx = np.floor(np.arange(out_size, dtype=np.float64) * (in_size / out_size))
    return np.clip(idx.astype(np.int64), 0, in_size - 1)


@functools.lru_cache(maxsize=256)
def _plan_is_small(in_size: int, out_size: int, align_corners: bool, terms_per_phase: int) -> bool:
    """Whether the JAX package lowers this bilinear axis as its phase plan
    (folded weighted taps) rather than a lerp (`resize.py:123-136` there)."""
    i0, i1, w1 = _linear_taps(in_size, out_size, align_corners)
    w1 = w1.astype(np.float64)
    w0 = 1.0 - w1
    gcd = math.gcd(in_size, out_size)
    p_n, s, g = out_size // gcd, in_size // gcd, gcd
    n_terms = 0
    deltas = set()
    for p in range(p_n):
        js = np.arange(g) * p_n + p
        ks = np.arange(g)
        contrib: dict = {}
        for idx, wgt in ((i0[js], w0[js]), (i1[js], w1[js])):
            d_all = idx - ks * s
            for d in np.unique(d_all):
                sel = d_all == d
                vec = contrib.setdefault(int(d), np.zeros(g))
                vec[sel] += wgt[sel]
        for d, vec in contrib.items():
            if np.any(vec):
                n_terms += 1
                deltas.add(d)
    if n_terms > terms_per_phase * p_n:
        return False
    return p_n <= 32 and len(deltas) <= 16


@functools.lru_cache(maxsize=256)
def _folded_taps(in_size: int, out_size: int, align_corners: bool):
    """(i0, i1, w0, w1) with w0 + w1 folded onto i0 where i0 == i1."""
    i0, i1, w1 = _linear_taps(in_size, out_size, align_corners)
    w1_64 = w1.astype(np.float64)
    w0_64 = 1.0 - w1_64
    same = i0 == i1
    w0 = np.where(same, w0_64 + w1_64, w0_64).astype(np.float32)
    w1f = np.where(same, 0.0, w1_64).astype(np.float32)
    return i0, i1, w0, w1f


def _axis_bilinear(v: torch.Tensor, size_in: int, size_out: int, axis: int, align_corners: bool):
    shape = [1] * v.ndim
    shape[axis] = size_out
    dev = v.device
    if _plan_is_small(size_in, size_out, align_corners, 4):
        i0, i1, w0, w1 = _folded_taps(size_in, size_out, align_corners)
        v0 = v.index_select(axis, torch.from_numpy(i0).to(dev))
        v1 = v.index_select(axis, torch.from_numpy(i1).to(dev))
        wt0 = torch.from_numpy(w0).to(dev, v.dtype).reshape(shape)
        wt1 = torch.from_numpy(w1).to(dev, v.dtype).reshape(shape)
        return v0 * wt0 + v1 * wt1
    i0, i1, w1 = _linear_taps(size_in, size_out, align_corners)
    v0 = v.index_select(axis, torch.from_numpy(i0).to(dev))
    v1 = v.index_select(axis, torch.from_numpy(i1).to(dev))
    wt = torch.from_numpy(w1).to(dev, v.dtype).reshape(shape)
    return v0 + (v1 - v0) * wt


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int, align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of [..., H, W, C] to [..., out_h, out_w, C]."""
    h, w = x.shape[-3], x.shape[-2]
    if (h, w) == (out_h, out_w):
        return x
    x = _axis_bilinear(x, h, out_h, x.ndim - 3, align_corners)
    return _axis_bilinear(x, w, out_w, x.ndim - 2, align_corners)


def _axis_2x_window(v: torch.Tensor, axis: int, k0: int, full: int, align_corners: bool):
    """Output rows [2*k0, 2*(k0 + n)) of the full 2x resize along `axis`
    from the block v of input rows [k0, k0 + n): the full image's taps,
    taken relative to the block; a tap outside the block reads 0, as the
    JAX package's zero-padded window does. Folded weighted taps, as its
    phase plan sums them."""
    n = v.shape[axis]
    i0, i1, w0, w1 = _folded_taps(full, 2 * full, align_corners)
    rows = slice(2 * k0, 2 * (k0 + n))
    r0, r1 = i0[rows] - k0, i1[rows] - k0
    lo = max(0, -int(min(r0.min(), r1.min())))
    hi = max(0, int(max(r0.max(), r1.max())) - (n - 1))
    if lo or hi:
        pad = [0, 0] * (v.ndim - 1 - axis) + [lo, hi]
        v = torch.nn.functional.pad(v, pad)
    dev = v.device
    shape = [1] * v.ndim
    shape[axis] = 2 * n
    v0 = v.index_select(axis, torch.from_numpy(r0 + lo).to(dev))
    v1 = v.index_select(axis, torch.from_numpy(r1 + lo).to(dev))
    wt0 = torch.from_numpy(w0[rows]).to(dev, v.dtype).reshape(shape)
    wt1 = torch.from_numpy(w1[rows]).to(dev, v.dtype).reshape(shape)
    return v0 * wt0 + v1 * wt1


def resize_2x_window(x: torch.Tensor, y0k: int, x0k: int, full_h: int, full_w: int, align_corners: bool = True):
    """2x bilinear upsample of the block x [..., n_h, n_w, C] that holds
    rows [y0k, y0k + n_h) and columns [x0k, x0k + n_w) of a full
    [full_h, full_w] image, sampled on the full image's grid. Output
    rows and columns inside the block's reach equal the full resize's;
    the edge ones, whose taps leave the block, are for the caller's halo
    to trim."""
    x = _axis_2x_window(x, x.ndim - 3, y0k, full_h, align_corners)
    return _axis_2x_window(x, x.ndim - 2, x0k, full_w, align_corners)


def resize_nearest(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Nearest-neighbour resize of [..., H, W, C] (torch 'nearest')."""
    h, w = x.shape[-3], x.shape[-2]
    if (h, w) == (out_h, out_w):
        return x
    dev = x.device
    x = x.index_select(x.ndim - 3, torch.from_numpy(_nearest_indices(h, out_h)).to(dev))
    return x.index_select(x.ndim - 2, torch.from_numpy(_nearest_indices(w, out_w)).to(dev))


def upflow8(flow: torch.Tensor) -> torch.Tensor:
    """[N, H, W, 2] -> [N, 8H, 8W, 2], bilinear align_corners=True, x8."""
    n, h, w, _ = flow.shape
    return 8.0 * resize_bilinear(flow, 8 * h, 8 * w, align_corners=True)
