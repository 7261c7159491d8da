"""RAFT correlation window lookup: CUDA kernel (csrc/corr_lookup.cu) + plain versions.

`corr_lookup(pyramid, coords, pyramid_b=None, blend="lanes")` takes the
pixel-major 4-level pyramid (level l: [P, H_l, W_l], fp32 or bf16) and
coords [IM, H8, W8, 2] fp32 as (x, y) 1/8-res pixel coordinates, and
returns [IM, H8, W8, 324] in the reference's (level, dx, dy) channel
order and the maps' dtype. With `pyramid_b` (the backward pyramid of
RAFT's second direction, levels of the same sizes) the first P pixels of
coords read `pyramid` and the rest read `pyramid_b`, in one launch.

Two blends, the two lookups of the JAX package's RAFT dispatcher:
  "lanes"  fp32 fractions, the blend in fp32, one rounding to the maps'
           dtype (the lanes kernel, `ops/pallas/corr_lanes.py` there);
  "map"    fractions rounded to the maps' dtype and every product and
           sum of the blend rounded to it (`lookup_corr`, `raft.py:249`
           there). In fp32 the two are the same arithmetic.
CPU tensors take the plain version; CUDA tensors take the kernel, which
has no backward: under grad mode with an input that requires grad it
raises (RAFT is not trained, in this package or the JAX one).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...utils.profiling import kernel
from . import _build
from ._grad import forward_only

RADIUS = 4
WIN = 2 * RADIUS + 1
LEVELS = 4
BLENDS = ("lanes", "map")


def _lookup(pyramid: list[torch.Tensor], flat: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """Zero-padded 10x10 window gather + shared bilinear weights, with
    the fractions and every product and sum in `dt` (the JAX package's
    slice-window lookup, `raft.py:329-349` there). flat [M, 2] -> [M, 324]."""
    m_all = flat.shape[0]
    ar = torch.arange(m_all, device=flat.device)
    taps = torch.arange(WIN + 1, device=flat.device)
    pad = WIN + 1
    outs = []
    for lvl, corr in enumerate(pyramid):
        mp = F.pad(corr.to(dt), (pad, pad, pad, pad))
        c = flat / (2**lvl)
        x0 = torch.floor(c[:, 0])
        y0 = torch.floor(c[:, 1])
        fx = (c[:, 0] - x0).to(dt)[:, None, None]
        fy = (c[:, 1] - y0).to(dt)[:, None, None]
        sy = (y0.clamp(-1e6, 1e6).long() - RADIUS + pad).clamp(0, mp.shape[1] - pad)
        sx = (x0.clamp(-1e6, 1e6).long() - RADIUS + pad).clamp(0, mp.shape[2] - pad)
        rows = sy[:, None] + taps
        cols = sx[:, None] + taps
        win = mp[ar[:, None, None], rows[:, :, None], cols[:, None, :]]  # [M, 10, 10]
        vy = win[:, :WIN, :] * (1 - fy) + win[:, 1:, :] * fy
        std = vy[:, :, :WIN] * (1 - fx) + vy[:, :, 1:] * fx  # [M, 9(dy), 9(dx)]
        outs.append(std.transpose(1, 2).reshape(m_all, WIN * WIN))  # (dx, dy)
    return torch.cat(outs, dim=1)


def corr_lookup_plain(pyramid: list[torch.Tensor], coords: torch.Tensor, pyramid_b=None, blend: str = "lanes") -> torch.Tensor:
    """The lookup in fp32 rounded once to the maps' dtype ("lanes"), or
    in the maps' dtype step by step ("map")."""
    if blend not in BLENDS:
        raise ValueError(f"corr_lookup: blend must be one of {BLENDS}, got {blend!r}")
    dt = torch.float32 if blend == "lanes" else pyramid[0].dtype
    im, h8, w8, _ = coords.shape
    flat = coords.reshape(im * h8 * w8, 2).float()
    if pyramid_b is None:
        out = _lookup(pyramid, flat, dt)
    else:
        n_fwd = pyramid[0].shape[0]
        out = torch.cat([_lookup(pyramid, flat[:n_fwd], dt), _lookup(pyramid_b, flat[n_fwd:], dt)])
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


def corr_lookup(pyramid: list[torch.Tensor], coords: torch.Tensor, pyramid_b=None, blend: str = "lanes") -> torch.Tensor:
    if coords.device.type == "cpu":
        return corr_lookup_plain(pyramid, coords, pyramid_b, blend)
    if coords.device.type != "cuda":
        raise ValueError(f"corr_lookup: unsupported device {coords.device}")
    forward_only("corr_lookup", coords, *pyramid, *(pyramid_b or ()))
    if blend not in BLENDS:
        raise ValueError(f"corr_lookup: blend must be one of {BLENDS}, got {blend!r}")
    _check([pyramid] if pyramid_b is None else [pyramid, pyramid_b], coords)
    im, h8, w8, _ = coords.shape
    out = torch.empty((im, h8, w8, LEVELS * WIN * WIN), device=coords.device, dtype=pyramid[0].dtype)
    backward = pyramid if pyramid_b is None else pyramid_b
    dims = []
    for m in pyramid:
        dims += [m.shape[1], m.shape[2]]
    if pyramid[0].dtype == torch.float32:
        mode = 0  # both blends are the fp32 kernel
    else:
        mode = 2 if blend == "map" else 1
    lib = _build.library()
    # counted as "corr_lookup" (`corr_lookup_kernel`: fp32 maps, or bf16
    # maps with the lanes blend) or "corr_lookup_map" (`corr_lookup_map_kernel`)
    with kernel("corr_lookup_map" if mode == 2 else "corr_lookup"):
        status = lib.propainter_corr_lookup(
            *[m.data_ptr() for m in pyramid],
            *[m.data_ptr() for m in backward],
            *dims,
            coords.data_ptr(),
            out.data_ptr(),
            pyramid[0].shape[0],
            im * h8 * w8,
            mode,
            torch.cuda.current_stream(coords.device).cuda_stream,
        )
        _build.check(status, "corr_lookup")
    return out
