"""Window attention read straight from the token grid (halo form): CUDA kernel
(csrc/window_attention_halo.cu) + plain version.

Port of the JAX package's `ops/pallas/window_attention_halo.py`:
  window_attention_halo(q, k, v, khalo, vhalo, pool_k, pool_v, occ,
                        bias_w, bias_hv, bias_p, *, window_size, n_head)
    q, k, v        [B, T, Hp, Wp, C]   window-padded token grids
    khalo, vhalo   [B, T_sel, Hp+2eh, Wp+2ew, C]   circularly padded K/V
                   grids at the t_ind frames (eh, ew = half the window)
    pool_k/pool_v  [B, head, PL, ch]
    occ            [B, nwh, nww]       window touched by the mask
    bias_w [B, T*wsz], bias_hv [B, T_sel], bias_p [B, PL] fp32 biases
Returns [B, T, Hp, Wp, C] in q's dtype. An occupied window attends over
[its keys | the (wh+2eh) x (ww+2ew) halo around it at each t_ind frame |
pooled keys]; `halo_bias_static` keeps the 148 halo positions that the
four rolled K/V copies bring into the window and masks the rest, so the
halo stands for the rolled keys. Clean windows attend within each frame.
On the H100 the kernel is bound by operations in occupied windows and by
bytes in clean ones; it addresses windows in the grids with strides (no
partition pass, no rolled copies), reads halo rows only for occupied
windows and walks only the survivor positions (`halo_survivors`). bf16
inputs run on the tensor cores (csrc/flash_mma.cuh; head width a
multiple of 16, else ValueError), fp32 inputs on the CUDA cores
(csrc/flash_f32.cuh, B3's and B4's fp32 loop; any head width up to
128). CPU tensors take the plain version; CUDA tensors
take the kernel. Under grad mode, with one of the seven q/k/v, halo and
pooled inputs requiring grad, the fp32 kernel runs inside
`_grad.TwinGrad`: the backward is the plain version's (bf16 raises there).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ...utils.profiling import kernel
from . import _build
from ._grad import twin_grad, wants_grad
from .window_attention import check_mma, window_attention_plain

NEG = -1e9


@functools.lru_cache(maxsize=8)
def halo_bias_static(window_size: tuple[int, int]) -> np.ndarray:
    """[hh*hw] f32: 0 where a halo position is a rolled survivor, -1e9
    elsewhere (the window interior and the bands no roll reaches); the
    JAX package's function of the same name, from the same corner masks
    as ops.attention._valid_rolled_indices."""
    wh, ww = window_size
    eh, ew = (wh + 1) // 2, (ww + 1) // 2
    count = np.zeros((wh + 2 * eh, ww + 2 * ew), np.int64)
    corners = (("tl", (-eh, -ew)), ("tr", (-eh, ew)), ("bl", (eh, -ew)), ("br", (eh, ew)))
    for corner, (sy, sx) in corners:
        m = np.ones((wh, ww), np.bool_)
        hs = slice(None, -eh) if corner in ("tl", "tr") else slice(eh, None)
        ws = slice(None, -ew) if corner in ("tl", "bl") else slice(ew, None)
        m[hs, ws] = False
        rr, cc = np.nonzero(m)
        np.add.at(count, (rr - sy + eh, cc - sx + ew), 1)
    # duplicates would need +ln(count); the (5, 9) and (3, 5) windows have none
    with np.errstate(divide="ignore"):
        bias = np.where(count > 0, np.log(count.astype(np.float64)), NEG)
    return bias.reshape(-1).astype(np.float32)


def halo_survivors(window_size: tuple[int, int]) -> np.ndarray:
    """[n_surv] int32: the halo positions whose static bias is not -1e9,
    the only ones the kernel walks (148 of 209 for a (5, 9) window). A
    skipped position's weight exp(-1e9 + validity - m) is an exact 0 in
    fp32: the survivors of the same frame carry a bias 1e9 larger."""
    return np.flatnonzero(halo_bias_static(tuple(window_size)) > NEG / 2).astype(np.int32)


@functools.lru_cache(maxsize=8)
def _survivors_on(window_size: tuple[int, int], device: torch.device) -> torch.Tensor:
    return torch.from_numpy(halo_survivors(window_size)).to(device)


def _windows(a, window_size, n_head):
    """[B, T, Hp, Wp, C] -> [B*nW, head, T, wh*ww, ch]."""
    b, t, hp, wp, c = a.shape
    wh, ww = window_size
    a = a.reshape(b, t, hp // wh, wh, wp // ww, ww, n_head, c // n_head).permute(0, 2, 4, 6, 1, 3, 5, 7)
    return a.reshape(b * (hp // wh) * (wp // ww), n_head, t, wh * ww, c // n_head)


def _halo_windows(a, window_size, n_head):
    """[B, T_sel, Hp+2eh, Wp+2ew, C] -> [B*nW, head, T_sel*hh*hw, ch]: the
    (hh, hw) halo of every window, a window's stride apart."""
    b, ts, _, _, c = a.shape
    wh, ww = window_size
    hh, hw = wh + 2 * ((wh + 1) // 2), ww + 2 * ((ww + 1) // 2)
    u = a.unfold(2, hh, wh).unfold(3, hw, ww)  # [B, T_sel, nwh, nww, C, hh, hw]
    nwh, nww = u.shape[2], u.shape[3]
    u = u.reshape(b, ts, nwh, nww, n_head, c // n_head, hh, hw).permute(0, 2, 3, 4, 1, 6, 7, 5)
    return u.reshape(b * nwh * nww, n_head, ts * hh * hw, c // n_head)


def _halo_bias(bias_hv, window_size):
    """[B, T_sel] validity -> [B, T_sel, hh*hw] fp32, the static bias added."""
    hb = torch.from_numpy(halo_bias_static(tuple(window_size))).to(bias_hv.device)
    return hb[None, None, :] + bias_hv.float()[:, :, None]


def window_attention_halo_plain(
    q, k, v, khalo, vhalo, pool_k, pool_v, occ, bias_w, bias_hv, bias_p, *, window_size, n_head: int,
):
    """Partition into windows, gather each window's halo, run the plain
    segmented attention (the halo segment in the rolled keys' place),
    write the token grid back; fp32 inside."""
    b, t, hp, wp, c = q.shape
    wh, ww = window_size
    nwh, nww = hp // wh, wp // ww
    out = window_attention_plain(
        _windows(q, window_size, n_head), _windows(k, window_size, n_head), _windows(v, window_size, n_head),
        _halo_windows(khalo, window_size, n_head), _halo_windows(vhalo, window_size, n_head),
        pool_k, pool_v, occ.reshape(-1), bias_w.float(),
        _halo_bias(bias_hv, window_size).reshape(b, -1), bias_p.float(), nwh * nww,
    )
    out = out.reshape(b, nwh, nww, n_head, t, wh, ww, c // n_head).permute(0, 4, 1, 5, 2, 6, 3, 7)
    return out.reshape(b, t, hp, wp, c)


def _check(q, k, v, khalo, vhalo, pool_k, pool_v, occ, bias_w, bias_hv, bias_p, window_size, n_head):
    b, t, hp, wp, c = q.shape
    wh, ww = window_size
    eh, ew = (wh + 1) // 2, (ww + 1) // 2
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"window_attention_halo: inputs must be fp32 or bf16, got {q.dtype}")
    if c % n_head or c // n_head > 128 or hp % wh or wp % ww:
        raise ValueError(f"window_attention_halo takes C/head <= 128 and a window-padded grid, got {tuple(q.shape)}")
    ts, pl_len = khalo.shape[1], pool_k.shape[2]
    shapes = {
        "k": (k, (b, t, hp, wp, c)), "v": (v, (b, t, hp, wp, c)),
        "khalo": (khalo, (b, ts, hp + 2 * eh, wp + 2 * ew, c)), "vhalo": (vhalo, (b, ts, hp + 2 * eh, wp + 2 * ew, c)),
        "pool_k": (pool_k, (b, n_head, pl_len, c // n_head)), "pool_v": (pool_v, (b, n_head, pl_len, c // n_head)),
    }
    for name, (tns, shape) in shapes.items():
        if tuple(tns.shape) != shape or tns.dtype != q.dtype:
            raise ValueError(f"window_attention_halo: {name} must be {q.dtype} {shape}, got {tns.dtype} {tuple(tns.shape)}")
    for name, tns, shape in (("bias_w", bias_w, (b, t * wh * ww)), ("bias_hv", bias_hv, (b, ts)), ("bias_p", bias_p, (b, pl_len))):
        if tuple(tns.shape) != shape:
            raise ValueError(f"window_attention_halo: {name} must be {shape}, got {tuple(tns.shape)}")
    if occ.numel() != b * (hp // wh) * (wp // ww):
        raise ValueError(f"window_attention_halo: occ must be [{b}, {hp // wh}, {wp // ww}], got {tuple(occ.shape)}")
    for tns in (q, k, v, khalo, vhalo, pool_k, pool_v, occ, bias_w, bias_hv, bias_p):
        if tns.device != q.device or not tns.is_contiguous():
            raise ValueError("window_attention_halo: every input must be contiguous on one device")


def window_attention_halo(
    q, k, v, khalo, vhalo, pool_k, pool_v, occ, bias_w, bias_hv, bias_p, *, window_size, n_head: int,
):
    args = (q, k, v, khalo, vhalo, pool_k, pool_v, occ, bias_w, bias_hv, bias_p)
    if q.device.type == "cpu":
        return window_attention_halo_plain(*args, window_size=window_size, n_head=n_head)
    if q.device.type != "cuda":
        raise ValueError(f"window_attention_halo: unsupported device {q.device}")
    if wants_grad(*args[:7]):
        return twin_grad(
            "window_attention_halo", _launch, window_attention_halo_plain, 7, args, window_size=window_size, n_head=n_head
        )
    return _launch(*args, window_size=window_size, n_head=n_head)


def _launch(q, k, v, khalo, vhalo, pool_k, pool_v, occ, bias_w, bias_hv, bias_p, *, window_size, n_head: int):
    args = (q, k, v, khalo, vhalo, pool_k, pool_v, occ, bias_w, bias_hv, bias_p)
    _check(*args, window_size, n_head)
    if q.dtype == torch.bfloat16:
        check_mma("window_attention_halo", q.shape[-1] // n_head, args[:7])
    b, t, hp, wp, c = q.shape
    wh, ww = window_size
    occ_i = occ.to(torch.int32).contiguous()
    bias_w, bias_p = bias_w.float().contiguous(), bias_p.float().contiguous()
    bias_h = _halo_bias(bias_hv, window_size).contiguous()
    surv = _survivors_on(tuple(window_size), q.device)
    out = torch.empty_like(q)
    with kernel("window_attention_halo"):
        status = _build.library().propainter_window_attention_halo(
            *[a.data_ptr() for a in (q, k, v, khalo, vhalo, pool_k, pool_v)],
            occ_i.data_ptr(), bias_w.data_ptr(), bias_h.data_ptr(), bias_p.data_ptr(), surv.data_ptr(),
            out.data_ptr(), b, t, khalo.shape[1], hp, wp, c, n_head, wh, ww, pool_k.shape[2], surv.numel(),
            1.0 / math.sqrt(c // n_head), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
        _build.check(status, "window_attention_halo")
    return out
