"""Backward warping / grid sampling on NHWC tensors.

Sampling coordinates are pixel coordinates (x right, y down): the
reference's align_corners=True normalize/denormalize round trip is the
identity. Out-of-bounds taps contribute zero ("zeros" padding). The
arithmetic follows the JAX package's tap-by-tap form.
"""

from __future__ import annotations

import torch


def _gather_2d(img: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor) -> torch.Tensor:
    """img[n, iy, ix, :] for in-bounds integer indices [N, P] -> [N, P, C]."""
    n, h, w, c = img.shape
    idx = (iy * w + ix).long()
    return torch.gather(img.reshape(n, h * w, c), 1, idx[:, :, None].expand(-1, -1, c))


def grid_sample(img: torch.Tensor, coords: torch.Tensor, mode: str = "bilinear") -> torch.Tensor:
    """img [N, H, W, C], coords [N, P, 2] as (x, y) -> [N, P, C]."""
    n, h, w, c = img.shape
    x = coords[..., 0]
    y = coords[..., 1]

    if mode == "nearest":
        # torch.round is half-to-even, like grid_sample's nearbyint
        ix = torch.round(x).long()
        iy = torch.round(y).long()
        valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        out = _gather_2d(img, iy.clamp(0, h - 1), ix.clamp(0, w - 1))
        return out * valid[..., None].to(img.dtype)

    if mode != "bilinear":
        raise ValueError(f"unsupported mode: {mode}")

    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx1 = (x - x0).to(img.dtype)
    wy1 = (y - y0).to(img.dtype)
    wx0 = 1.0 - wx1
    wy0 = 1.0 - wy1
    ix0 = x0.long()
    iy0 = y0.long()
    ix1 = ix0 + 1
    iy1 = iy0 + 1

    def tap(iy, ix, wgt):
        valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        v = _gather_2d(img, iy.clamp(0, h - 1), ix.clamp(0, w - 1))
        return v * (wgt * valid.to(img.dtype))[..., None]

    return (
        tap(iy0, ix0, wy0 * wx0)
        + tap(iy0, ix1, wy0 * wx1)
        + tap(iy1, ix0, wy1 * wx0)
        + tap(iy1, ix1, wy1 * wx1)
    )


def coords_grid(batch: int, h: int, w: int, dtype=torch.float32, device=None, row0: int = 0) -> torch.Tensor:
    """[N, H, W, 2] pixel coordinate grid, last dim = (x, y); rows from row0."""
    gy, gx = torch.meshgrid(
        torch.arange(row0, row0 + h, dtype=dtype, device=device),
        torch.arange(w, dtype=dtype, device=device),
        indexing="ij",
    )
    return torch.stack([gx, gy], dim=-1)[None].expand(batch, h, w, 2)


def flow_warp(x: torch.Tensor, flow: torch.Tensor, interpolation: str = "bilinear", row0: int = 0) -> torch.Tensor:
    """Backward-warp x [N, H, W, C] by flow [N, Ho, W, 2] (dx, dy): output
    row y is x's row row0 + y moved by the flow (Ho = H and row0 = 0: the
    whole image; the H split warps its rows out of the whole map). The
    grid and `grid + flow` are float32 at least, whatever the flow's
    dtype: bf16 holds pixel coordinates exactly only up to 256, so a bf16
    grid would sample 1-4 px off across a 360p-720p frame."""
    n, h, w, _ = flow.shape
    dt = torch.promote_types(flow.dtype, torch.float32)
    grid = coords_grid(1, h, w, dt, flow.device, row0)
    coords = (grid + flow.to(dt)).reshape(n, h * w, 2)
    return grid_sample(x, coords, mode=interpolation).reshape(n, h, w, x.shape[-1])


def fb_consistency_check(
    flow_fw: torch.Tensor, flow_bw: torch.Tensor, alpha1: float = 0.01, alpha2: float = 0.5
) -> torch.Tensor:
    """Forward-backward flow consistency gate -> [N, H, W, 1] in {0, 1}."""
    flow_bw_warped = flow_warp(flow_bw, flow_fw)
    flow_diff_fw = flow_fw + flow_bw_warped

    def length_sq(v):
        return torch.sum(v * v, dim=-1, keepdim=True)

    mag_sq_fw = length_sq(flow_fw) + length_sq(flow_bw_warped)
    occ_thresh_fw = alpha1 * mag_sq_fw + alpha2
    return (length_sq(flow_diff_fw) < occ_thresh_fw).to(flow_fw.dtype)
