"""RAFT window lookup from zero-padded maps: CUDA kernels (csrc/corr_window.cu) + plain versions.

Port of the JAX package's `ops/pallas/corr_lookup.py`, replacing its two
TPU kernels:
  corr_window_lookup(corr_pad, sy, sx, fy, fx)   one level, `_kernel`
      corr_pad [M, Hp, Wp]; sy/sx [M] int32; fy/fx [M] -> [M, 9, 9]
  corr_window_lookup4(pyramid, sy, sx, fy, fx)   four levels, `_kernel4_block`
      pyramid: 4 maps [M, Hp_l, Wp_l]; sy/sx/fy/fx [4, M] -> [M, 4, 9, 9]
Maps are fp32 or bf16 and carry a zero border wide enough that a window
at a clamped start reads zeros; starts are window corners in padded
coordinates, clamped to [0, Hp-10] x [0, Wp-10]. Outputs are fp32 tap
grids in natural (dy, dx) order: the 10x10 window, combined rows first
(by fy), then columns (by fx). The kernels are bytes-bound: each output
is four loads and six flops. Both kernels stage a block's windows in
shared memory, each element loaded once (32 pixels a block for one
level, 24 for four), and write four outputs a thread as one 16-byte
store (csrc/corr_window.cu). CPU tensors take the plain versions; CUDA
tensors take the kernels, which have no backward: under grad mode with
an input that requires grad they raise.
"""

from __future__ import annotations

import torch

from ...utils.profiling import kernel
from . import _build
from ._grad import forward_only

WIN = 10  # window rows/cols fetched per pixel (2 * radius + 2)
TAPS = 9


def corr_window_lookup_plain(corr_pad: torch.Tensor, sy, sx, fy, fx) -> torch.Tensor:
    """Gather each pixel's 10x10 window, then the shared-fraction combine
    in fp32 (rows first, as the TPU kernel): [M, 9, 9] (dy, dx)."""
    m, hp, wp = corr_pad.shape
    dev = corr_pad.device
    taps = torch.arange(WIN, device=dev)
    rows = sy.long().clamp(0, hp - WIN)[:, None] + taps  # [M, 10]
    cols = sx.long().clamp(0, wp - WIN)[:, None] + taps
    base = torch.arange(m, device=dev)[:, None] * hp + rows
    idx = base[:, :, None] * wp + cols[:, None, :]  # [M, 10, 10]
    win = corr_pad.reshape(-1)[idx].float()
    fy = fy.float()[:, None, None]
    fx = fx.float()[:, None, None]
    vy = win[:, : WIN - 1, :] * (1.0 - fy) + win[:, 1:, :] * fy
    return vy[:, :, : WIN - 1] * (1.0 - fx) + vy[:, :, 1:] * fx


def corr_window_lookup4_plain(pyramid, sy, sx, fy, fx) -> torch.Tensor:
    return torch.stack(
        [corr_window_lookup_plain(p, sy[i], sx[i], fy[i], fx[i]) for i, p in enumerate(pyramid)], dim=1
    )


def _check_maps(maps, m: int, dev) -> None:
    dt = maps[0].dtype
    for p in maps:
        if p.dtype not in (torch.float32, torch.bfloat16) or p.dtype != dt:
            raise ValueError(f"corr_window: maps must share fp32 or bf16, got {p.dtype}")
        if p.dim() != 3 or p.shape[0] != m or p.shape[1] < WIN or p.shape[2] < WIN:
            raise ValueError(f"corr_window: a map must be [{m}, >={WIN}, >={WIN}], got {tuple(p.shape)}")
        if p.device != dev or not p.is_contiguous():
            raise ValueError("corr_window: maps must be contiguous on the starts' device")


def _starts_and_fracs(sy, sx, fy, fx, shape):
    out = []
    for name, a, dt in (("sy", sy, torch.int32), ("sx", sx, torch.int32), ("fy", fy, torch.float32), ("fx", fx, torch.float32)):
        if tuple(a.shape) != shape:
            raise ValueError(f"corr_window: {name} must be {list(shape)}, got {tuple(a.shape)}")
        out.append(a.to(dt).contiguous())
    return out


def _device_ok(t: torch.Tensor, name: str) -> bool:
    """True for a CUDA tensor (kernel), False for a CPU one (plain)."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return True


def corr_window_lookup(corr_pad, sy, sx, fy, fx) -> torch.Tensor:
    if not _device_ok(corr_pad, "corr_window_lookup"):
        return corr_window_lookup_plain(corr_pad, sy, sx, fy, fx)
    forward_only("corr_window_lookup", corr_pad, fy, fx)
    m, hp, wp = corr_pad.shape
    _check_maps([corr_pad], m, sy.device)
    sy, sx, fy, fx = _starts_and_fracs(sy, sx, fy, fx, (m,))
    out = torch.empty((m, TAPS, TAPS), device=corr_pad.device, dtype=torch.float32)
    with kernel("corr_window"):
        status = _build.library().propainter_corr_window(
            corr_pad.data_ptr(), sy.data_ptr(), sx.data_ptr(), fy.data_ptr(), fx.data_ptr(),
            out.data_ptr(), m, hp, wp, int(corr_pad.dtype == torch.bfloat16),
            torch.cuda.current_stream(corr_pad.device).cuda_stream,
        )
        _build.check(status, "corr_window_lookup")
    return out


def corr_window_lookup4(pyramid, sy, sx, fy, fx) -> torch.Tensor:
    if len(pyramid) != 4:
        raise ValueError(f"corr_window_lookup4 needs 4 levels, got {len(pyramid)}")
    if not _device_ok(pyramid[0], "corr_window_lookup4"):
        return corr_window_lookup4_plain(pyramid, sy, sx, fy, fx)
    forward_only("corr_window_lookup4", *pyramid, fy, fx)
    m = pyramid[0].shape[0]
    _check_maps(pyramid, m, sy.device)
    sy, sx, fy, fx = _starts_and_fracs(sy, sx, fy, fx, (4, m))
    out = torch.empty((m, 4, TAPS, TAPS), device=sy.device, dtype=torch.float32)
    dims = []
    for p in pyramid:
        dims += [p.shape[1], p.shape[2]]
    with kernel("corr_window4"):
        status = _build.library().propainter_corr_window4(
            *[p.data_ptr() for p in pyramid], *dims,
            sy.data_ptr(), sx.data_ptr(), fy.data_ptr(), fx.data_ptr(), out.data_ptr(),
            m, int(pyramid[0].dtype == torch.bfloat16),
            torch.cuda.current_stream(sy.device).cuda_stream,
        )
        _build.check(status, "corr_window_lookup4")
    return out
