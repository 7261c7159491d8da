"""On-device image preprocessing: PIL-equivalent bicubic resize, byte
quantization, mask dilation and [-1, 1] normalization, batched over the
whole [T, H, W, C] stack; the outpaint canvas and its ring masks."""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.dilation import binary_dilation


@functools.lru_cache(maxsize=64)
def _pil_bicubic_weights(in_size: int, out_size: int) -> np.ndarray:
    """[out_size, in_size] matrix reproducing PIL's bicubic resampling
    (Keys a=-0.5, support 2 scaled by the downscale ratio, per-row
    normalization — Pillow's precompute_coeffs)."""

    def filt(x):
        x = np.abs(x)
        a = -0.5
        return np.where(
            x < 1.0,
            ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
            np.where(x < 2.0, (((x - 5.0) * x + 8.0) * x - 4.0) * a, 0.0),
        )

    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    mat = np.zeros((out_size, in_size), np.float64)
    for i in range(out_size):
        center = (i + 0.5) * scale
        xmin = max(0, int(center - support + 0.5))
        xmax = min(in_size, int(center + support + 0.5))
        xs = np.arange(xmin, xmax)
        w = filt((xs - center + 0.5) / filterscale)
        mat[i, xmin:xmax] = w / w.sum()
    return mat.astype(np.float32)


def _round8(x: torch.Tensor) -> torch.Tensor:
    """PIL's 8-bit store: +0.5 round, clip."""
    return torch.clamp(torch.floor(x + 0.5), 0.0, 255.0)


def resize_frames(byte_frames: torch.Tensor, out_w: int, out_h: int) -> torch.Tensor:
    """PIL-equivalent bicubic resize of [T, H, W, C] uint8-valued floats:
    horizontal pass, uint8 store, vertical pass, uint8 store."""
    t, h, w, c = byte_frames.shape
    if (h, w) == (out_h, out_w):
        return byte_frames
    dev = byte_frames.device
    wh = torch.from_numpy(_pil_bicubic_weights(w, out_w)).to(dev)
    wv = torch.from_numpy(_pil_bicubic_weights(h, out_h)).to(dev)
    x = _round8(torch.einsum("thwc,ow->thoc", byte_frames.float(), wh))
    return _round8(torch.einsum("thwc,oh->towc", x, wv))


def prepare_frames(frames: torch.Tensor, out_w: int, out_h: int):
    """frames [T, H, W, 3] in [0, 1] -> (normalized [-1, 1], bytes 0..255)."""
    byte0 = torch.floor(torch.clamp(frames.float() * 255.0, 0.0, 255.0))
    byte = resize_frames(byte0, out_w, out_h)
    return (byte / 255.0) * 2.0 - 1.0, byte


def prepare_masks(masks: torch.Tensor, out_w: int, out_h: int, flow_dilates: int, mask_dilates: int):
    """masks [T, H, W] in [0, 1] -> (flow_masks, masks_dilated), each
    [T, out_h, out_w, 1] binary."""
    byte0 = torch.floor(torch.clamp(masks.float()[..., None] * 255.0, 0.0, 255.0))
    base = (resize_frames(byte0, out_w, out_h)[..., 0] > 0.5).float()
    flow_masks = binary_dilation(base, flow_dilates) if flow_dilates > 0 else base
    masks_dilated = binary_dilation(base, mask_dilates) if mask_dilates > 0 else base
    return flow_masks[..., None], masks_dilated[..., None]


def ring_masks(frame_hw, canvas_hw, device=None):
    """The outpaint canvas's (flow_mask, mask_dilated) [canvas_h, canvas_w]
    (utils/image_utils.py:237-252): 1 outside the centred frame, 0 inside;
    the flow mask's hole is inset by 4 px on an axis whose margin is
    above 10 px."""
    out_h, out_w = frame_hw
    canvas_h, canvas_w = canvas_hw
    h_start = (canvas_h - out_h) // 2
    w_start = (canvas_w - out_w) // 2
    dil_h = 4 if h_start > 10 else 0
    dil_w = 4 if w_start > 10 else 0
    flow_mask = torch.ones((canvas_h, canvas_w), device=device)
    flow_mask[h_start + dil_h : h_start + out_h - dil_h, w_start + dil_w : w_start + out_w - dil_w] = 0.0
    mask_dilated = torch.ones((canvas_h, canvas_w), device=device)
    mask_dilated[h_start : h_start + out_h, w_start : w_start + out_w] = 0.0
    return flow_mask, mask_dilated


def outpaint_canvas(byte: torch.Tensor, canvas_hw):
    """The outpaint canvas (utils/image_utils.py:200-252): the frames'
    bytes byte [T, H, W, 3] centred on a zero canvas [T, canvas_h,
    canvas_w, 3], and its ring masks (flow_masks, masks_dilated)
    [T, canvas_h, canvas_w, 1] (`ring_masks`)."""
    t, h, w, c = byte.shape
    canvas_h, canvas_w = canvas_hw
    h_start = (canvas_h - h) // 2
    w_start = (canvas_w - w) // 2
    canvas = byte.new_zeros((t, canvas_h, canvas_w, c))
    canvas[:, h_start : h_start + h, w_start : w_start + w] = byte
    shape = (t, canvas_h, canvas_w, 1)
    masks = ring_masks((h, w), canvas_hw, byte.device)
    return (canvas, *(m[None, :, :, None].expand(shape).contiguous() for m in masks))
