"""RAFT correlation window lookup: CUDA kernel (csrc/corr_lookup.cu) + plain version.

`corr_lookup(pyramid, coords, pyramid_b=None)` takes the pixel-major
4-level pyramid (level l: [P, H_l, W_l], fp32 or bf16) and coords
[IM, H8, W8, 2] fp32 as (x, y) 1/8-res pixel coordinates, and returns
[IM, H8, W8, 324] in the reference's (level, dx, dy) channel order and
the maps' dtype: the fp32 lookup rounded once. With `pyramid_b` (the
backward pyramid of RAFT's second direction, levels of the same sizes)
the first P pixels of coords read `pyramid` and the rest read
`pyramid_b`, in one launch. CPU tensors take the plain version; CUDA
tensors take the kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

RADIUS = 4
WIN = 2 * RADIUS + 1
LEVELS = 4
launches = 0  # kernel launches since the last reset


def _lookup_fp32(pyramid: list[torch.Tensor], flat: torch.Tensor) -> torch.Tensor:
    """Zero-padded 10x10 window gather + shared bilinear weights, fp32
    (the JAX package's slice-window lookup, `raft.py:329-349` there).
    flat [M, 2] -> [M, 324]."""
    m_all = flat.shape[0]
    ar = torch.arange(m_all, device=flat.device)
    taps = torch.arange(WIN + 1, device=flat.device)
    pad = WIN + 1
    outs = []
    for lvl, corr in enumerate(pyramid):
        mp = F.pad(corr.float(), (pad, pad, pad, pad))
        c = flat / (2**lvl)
        x0 = torch.floor(c[:, 0])
        y0 = torch.floor(c[:, 1])
        fx = (c[:, 0] - x0)[:, None, None]
        fy = (c[:, 1] - y0)[:, None, None]
        sy = (y0.clamp(-1e6, 1e6).long() - RADIUS + pad).clamp(0, mp.shape[1] - pad)
        sx = (x0.clamp(-1e6, 1e6).long() - RADIUS + pad).clamp(0, mp.shape[2] - pad)
        rows = sy[:, None] + taps
        cols = sx[:, None] + taps
        win = mp[ar[:, None, None], rows[:, :, None], cols[:, None, :]]  # [M, 10, 10]
        vy = win[:, :WIN, :] * (1 - fy) + win[:, 1:, :] * fy
        std = vy[:, :, :WIN] * (1 - fx) + vy[:, :, 1:] * fx  # [M, 9(dy), 9(dx)]
        outs.append(std.transpose(1, 2).reshape(m_all, WIN * WIN))  # (dx, dy)
    return torch.cat(outs, dim=1)


def corr_lookup_plain(pyramid: list[torch.Tensor], coords: torch.Tensor, pyramid_b=None) -> torch.Tensor:
    """The lookup in fp32, rounded once to the maps' dtype."""
    im, h8, w8, _ = coords.shape
    flat = coords.reshape(im * h8 * w8, 2).float()
    if pyramid_b is None:
        out = _lookup_fp32(pyramid, flat)
    else:
        n_fwd = pyramid[0].shape[0]
        out = torch.cat([_lookup_fp32(pyramid, flat[:n_fwd]), _lookup_fp32(pyramid_b, flat[n_fwd:])])
    return out.reshape(im, h8, w8, LEVELS * WIN * WIN).to(pyramid[0].dtype)


def _check(pyramids, coords):
    if coords.dtype != torch.float32 or coords.dim() != 4 or coords.shape[-1] != 2:
        raise ValueError(f"coords must be float32 [IM, H8, W8, 2], got {coords.dtype} {tuple(coords.shape)}")
    if not coords.is_contiguous():
        raise ValueError("coords must be contiguous")
    im, h8, w8, _ = coords.shape
    dt = pyramids[0][0].dtype
    for pyramid in pyramids:
        if len(pyramid) != LEVELS:
            raise ValueError(f"corr_lookup needs {LEVELS} pyramid levels, got {len(pyramid)}")
        for lvl, m in enumerate(pyramid):
            if m.device != coords.device:
                raise ValueError("pyramid and coords must be on one device")
            if m.dtype not in (torch.float32, torch.bfloat16) or m.dtype != dt:
                raise ValueError(f"pyramid levels must share fp32 or bf16, got {m.dtype}")
            if m.dim() != 3 or m.shape[0] != pyramid[0].shape[0] or not m.is_contiguous():
                raise ValueError(f"pyramid level must be contiguous [{pyramid[0].shape[0]}, Hl, Wl], got {tuple(m.shape)}")
            if m.shape[1:] != pyramids[0][lvl].shape[1:]:
                raise ValueError("the two pyramids' levels must have the same sizes")
    if sum(p[0].shape[0] for p in pyramids) != im * h8 * w8:
        raise ValueError(f"the pyramids hold {[p[0].shape[0] for p in pyramids]} pixels, coords {im * h8 * w8}")


def corr_lookup(pyramid: list[torch.Tensor], coords: torch.Tensor, pyramid_b=None) -> torch.Tensor:
    global launches
    if coords.device.type == "cpu":
        return corr_lookup_plain(pyramid, coords, pyramid_b)
    if coords.device.type != "cuda":
        raise ValueError(f"corr_lookup: unsupported device {coords.device}")
    _check([pyramid] if pyramid_b is None else [pyramid, pyramid_b], coords)
    im, h8, w8, _ = coords.shape
    out = torch.empty((im, h8, w8, LEVELS * WIN * WIN), device=coords.device, dtype=pyramid[0].dtype)
    backward = pyramid if pyramid_b is None else pyramid_b
    dims = []
    for m in pyramid:
        dims += [m.shape[1], m.shape[2]]
    lib = _build.library()
    status = lib.propainter_corr_lookup(
        *[m.data_ptr() for m in pyramid],
        *[m.data_ptr() for m in backward],
        *dims,
        coords.data_ptr(),
        out.data_ptr(),
        pyramid[0].shape[0],
        im * h8 * w8,
        int(pyramid[0].dtype == torch.bfloat16),
        torch.cuda.current_stream(coords.device).cuda_stream,
    )
    _build.check(status, "corr_lookup")
    launches += 1
    return out
