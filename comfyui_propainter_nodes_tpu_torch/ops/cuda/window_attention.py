"""Occupancy-sparse window attention: CUDA kernels + plain versions.

Two kernels compute the same function, as in the JAX package:
  * `window_attention` (csrc/window_attention.cu), the single-pass kernel;
  * `window_attention_tiled` (csrc/window_attention_tiled.cu), the
    segment-tiled kernel: rolled and pooled segments padded to SEG_TILE
    multiples with zero keys of bias -1e9; bf16 runs each occupied
    window's keys in one block, fp32 cuts them into splits of SPLIT_KEYS
    keys, one block per split, merged by a combine pass;
and `window_attention_dispatch` picks one by the JAX dispatcher's size
estimate (single pass below 12e6: 640x360; tiled from there: 1280x720).
On the H100 both are bound by operations in occupied windows and by
bytes in clean ones. Both run bf16 inputs on the tensor cores
(csrc/flash_mma.cuh; head width a multiple of 16 and 16-byte aligned
tensors, else ValueError) and fp32 inputs on the CUDA cores
(csrc/flash_f32.cuh; any head width up to 128: 16-byte copies when it is a
multiple of 4 and every tensor starts on a 16-byte boundary, 4-byte
copies otherwise, the launcher's choice); csrc/ has the designs.

Signature (the JAX package's `window_attention_pallas`):
  win_q, win_k, win_v  [W, head, T, wsz, ch]   W = B * n_win_per_b
  rolled_k, rolled_v   [W, head, RL, ch]       t_ind-selected rolled keys
  pool_k, pool_v       [B, head, PL, ch]       t_ind-selected, unbroadcast
  occ                  [W] bool                window touched by the mask
  bias_w [B, T*wsz], bias_r [B, RL], bias_p [B, PL] fp32 additive biases
Returns [W, head, T, wsz, ch] in win_q's dtype. Occupied windows attend
over [window | rolled | pooled] keys; clean windows attend within each
frame's own wsz keys. CPU tensors take the plain version; CUDA tensors
take the kernel. Under grad mode, with one of the seven q/k/v, rolled and
pooled inputs requiring grad, the fp32 kernel runs inside
`_grad.TwinGrad`: the backward is the plain version's (bf16 raises there).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ...utils.profiling import kernel
from . import _build
from ._grad import twin_grad, wants_grad

NEG = -1e9
SEG_TILE = 256  # rolled/pooled keys per segment tile (the TPU kernel's)
# keys per split of an occupied window in the tiled kernel's fp32 loop.
# bf16 runs one split a window, which needs no workspace and no combine
# and ran faster on the H100 than splits of 512, 1024 or 2048 keys. In
# fp32 one split a window was 2-5% faster than 512 keys a split at paths
# A, S, C and MH (the fp32 loop's bring-up, CHANGES.md), but a split's running
# sums add one term a key, and over thousands of keys the terms below
# half an ulp of the sum drop out: with 512-key splits the training
# step's gradients stay within 1e-4 of the plain versions' step, with one
# split or 1024 keys they do not (PERF.md)
SPLIT_KEYS = 2 * SEG_TILE
TILED_ESTIMATE = 12e6  # the JAX dispatcher's threshold
MAX_GRID_Z = 65535


def window_attention_plain(
    win_q, win_k, win_v, rolled_k, rolled_v, pool_k, pool_v, occ,
    bias_w, bias_r, bias_p, n_win_per_b: int,
):
    """Both branches for every window, selected by occupancy (the JAX
    package's XLA form), in fp32 (float64 inputs in float64, as the XLA
    form computes in the inputs' dtype). Windows go in chunks whose scores
    take about 1 GiB, so the 1280x720 shapes fit."""
    nw, nh, t, wsz, ch = win_q.shape
    n_keys = t * wsz + rolled_k.shape[2] + pool_k.shape[2]
    step = max(1, int(2**30 // (nh * t * wsz * n_keys * 4 * 2)))
    args = (win_q, win_k, win_v, rolled_k, rolled_v, pool_k, pool_v, occ, bias_w, bias_r, bias_p)
    outs = [_plain_windows(*args, n_win_per_b, w0, min(nw, w0 + step)) for w0 in range(0, nw, step)]
    return torch.cat(outs).to(win_q.dtype)


def _plain_windows(
    win_q, win_k, win_v, rolled_k, rolled_v, pool_k, pool_v, occ,
    bias_w, bias_r, bias_p, n_win_per_b: int, w0: int, w1: int,
):
    """window_attention_plain for windows [w0, w1), fp32 (or float64)."""
    _, nh, t, wsz, ch = win_q.shape
    nw = w1 - w0
    ft = torch.float64 if win_q.dtype == torch.float64 else torch.float32
    rows = torch.arange(w0, w1, device=win_q.device) // n_win_per_b  # batch row per window
    scale = 1.0 / math.sqrt(ch)
    q = win_q[w0:w1].to(ft)
    k = win_k[w0:w1].to(ft)
    v = win_v[w0:w1].to(ft)
    qa = q.reshape(nw, nh, t * wsz, ch)
    k_all = torch.cat([k.reshape(nw, nh, t * wsz, ch), rolled_k[w0:w1].to(ft), pool_k[rows].to(ft)], dim=2)
    v_all = torch.cat([v.reshape(nw, nh, t * wsz, ch), rolled_v[w0:w1].to(ft), pool_v[rows].to(ft)], dim=2)
    bias = torch.cat([bias_w, bias_r, bias_p], dim=1).to(ft)[rows][:, None, None, :]
    att_a = torch.matmul(qa, k_all.transpose(-1, -2)) * scale + bias
    out_a = torch.matmul(torch.softmax(att_a, dim=-1), v_all).reshape(nw, nh, t, wsz, ch)
    att_b = torch.matmul(q, k.transpose(-1, -2)) * scale
    out_b = torch.matmul(torch.softmax(att_b, dim=-1), v)
    return torch.where(occ[w0:w1].reshape(nw, 1, 1, 1, 1).bool(), out_a, out_b)


def _check(args, n_win_per_b):
    win_q, win_k, win_v, rolled_k, rolled_v, pool_k, pool_v, occ, bias_w, bias_r, bias_p = args
    nw, nh, t, wsz, ch = win_q.shape
    if win_q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"window_attention: inputs must be fp32 or bf16, got {win_q.dtype}")
    if ch > 128 or nw % n_win_per_b:
        raise ValueError(f"window_attention kernel takes ch <= 128 and W % n_win_per_b == 0, got ch={ch}, W={nw}")
    b = nw // n_win_per_b
    rl, pl_len = rolled_k.shape[2], pool_k.shape[2]
    shapes = {
        "win_k": (win_k, (nw, nh, t, wsz, ch)),
        "win_v": (win_v, (nw, nh, t, wsz, ch)),
        "rolled_k": (rolled_k, (nw, nh, rl, ch)),
        "rolled_v": (rolled_v, (nw, nh, rl, ch)),
        "pool_k": (pool_k, (b, nh, pl_len, ch)),
        "pool_v": (pool_v, (b, nh, pl_len, ch)),
    }
    for name, (tns, shape) in shapes.items():
        if tuple(tns.shape) != shape or tns.dtype != win_q.dtype:
            raise ValueError(f"window_attention: {name} must be {win_q.dtype} {shape}, got {tns.dtype} {tuple(tns.shape)}")
    for name, tns, shape in (("bias_w", bias_w, (b, t * wsz)), ("bias_r", bias_r, (b, rl)), ("bias_p", bias_p, (b, pl_len))):
        if tuple(tns.shape) != shape or tns.dtype != torch.float32:
            raise ValueError(f"window_attention: {name} must be float32 {shape}, got {tns.dtype} {tuple(tns.shape)}")
    if tuple(occ.shape) != (nw,):
        raise ValueError(f"window_attention: occ must be [{nw}], got {tuple(occ.shape)}")
    for tns in args:
        if tns.device != win_q.device or not tns.is_contiguous():
            raise ValueError("window_attention: every input must be contiguous on one device")


def check_mma(name: str, ch: int, tensors) -> None:
    """What the tensor-core loop (csrc/flash_mma.cuh) takes from bf16
    inputs: a head width that is a multiple of 16, and rows that its
    16-byte `cp.async` copies can read (16-byte aligned tensors)."""
    if ch % 16:
        raise ValueError(f"{name}: bf16 inputs need a head width that is a multiple of 16, got {ch}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: bf16 inputs must start on 16-byte boundaries")


def window_attention(
    win_q, win_k, win_v, rolled_k, rolled_v, pool_k, pool_v, occ,
    bias_w, bias_r, bias_p, *, n_win_per_b: int,
):
    args = (win_q, win_k, win_v, rolled_k, rolled_v, pool_k, pool_v, occ, bias_w, bias_r, bias_p)
    if win_q.device.type == "cpu":
        return window_attention_plain(*args, n_win_per_b)
    if win_q.device.type != "cuda":
        raise ValueError(f"window_attention: unsupported device {win_q.device}")
    if wants_grad(*args[:7]):
        return twin_grad("window_attention", _launch, window_attention_plain, 7, args, n_win_per_b=n_win_per_b)
    return _launch(*args, n_win_per_b=n_win_per_b)


def _launch(
    win_q, win_k, win_v, rolled_k, rolled_v, pool_k, pool_v, occ,
    bias_w, bias_r, bias_p, *, n_win_per_b: int,
):
    args = (win_q, win_k, win_v, rolled_k, rolled_v, pool_k, pool_v, occ, bias_w, bias_r, bias_p)
    _check(args, n_win_per_b)
    if win_q.dtype == torch.bfloat16:
        check_mma("window_attention", win_q.shape[-1], args[:7])
    nw, nh, t, wsz, ch = win_q.shape
    occ_i = occ.to(torch.int32).contiguous()
    out = torch.empty_like(win_q)
    lib = _build.library()
    with kernel("window_attention"):
        status = lib.propainter_window_attention(
            *[a.data_ptr() for a in (win_q, win_k, win_v, rolled_k, rolled_v, pool_k, pool_v)],
            occ_i.data_ptr(), bias_w.data_ptr(), bias_r.data_ptr(), bias_p.data_ptr(),
            out.data_ptr(), nw, nh, t * wsz, rolled_k.shape[2], pool_k.shape[2], ch,
            n_win_per_b, wsz, 1.0 / math.sqrt(ch), int(win_q.dtype == torch.bfloat16),
            torch.cuda.current_stream(win_q.device).cuda_stream,
        )
        _build.check(status, "window_attention")
    return out


# ------------------------------------------------------------ segment-tiled


def uses_tiled(win_q, rolled_k, pool_k) -> bool:
    """The JAX dispatcher's choice (`window_attention_pallas`): its
    estimate of the single-pass kernel's q/k/v, rolled and pooled blocks
    and fp32 output in bytes, with the element size of the compute dtype,
    against 12e6."""
    _, nh, t, wsz, ch = win_q.shape
    qt = t * wsz
    esz = 2 if win_q.dtype == torch.bfloat16 else 4
    est = (
        (3 * qt + 2 * rolled_k.shape[2]) * nh * ch * esz * 2
        + 2 * pool_k.shape[2] * nh * ch * esz
        + qt * nh * ch * 4
    )
    return est >= TILED_ESTIMATE


def _padded(length: int) -> int:
    return max(1, -(-length // SEG_TILE)) * SEG_TILE


def split_plan(n_keys: int, dtype) -> tuple[int, int]:
    """(splits per occupied window, keys per split) of the tiled kernel
    for a padded key sequence of n_keys: one split for bf16, SPLIT_KEYS
    keys a split for fp32."""
    keys = n_keys if dtype == torch.bfloat16 else SPLIT_KEYS
    return -(-n_keys // keys), keys


def window_attention_tiled_plain(
    win_q, win_k, win_v, rolled_k, rolled_v, pool_k, pool_v, occ,
    bias_w, bias_r, bias_p, n_win_per_b: int,
):
    """The TPU tiled kernel's tiling, then the plain version: rolled and
    pooled segments padded to SEG_TILE multiples with zero keys whose bias
    is -1e9 (`_window_attention_tiled`'s `pad_seg`)."""

    def pad(k, v, bias):
        extra = _padded(k.shape[2]) - k.shape[2]
        return F.pad(k, (0, 0, 0, extra)), F.pad(v, (0, 0, 0, extra)), F.pad(bias.float(), (0, extra), value=NEG)

    rolled_k, rolled_v, bias_r = pad(rolled_k, rolled_v, bias_r)
    pool_k, pool_v, bias_p = pad(pool_k, pool_v, bias_p)
    return window_attention_plain(
        win_q, win_k, win_v, rolled_k, rolled_v, pool_k, pool_v, occ, bias_w, bias_r, bias_p, n_win_per_b
    )


def window_attention_tiled(
    win_q, win_k, win_v, rolled_k, rolled_v, pool_k, pool_v, occ,
    bias_w, bias_r, bias_p, *, n_win_per_b: int,
):
    args = (win_q, win_k, win_v, rolled_k, rolled_v, pool_k, pool_v, occ, bias_w, bias_r, bias_p)
    if win_q.device.type == "cpu":
        return window_attention_tiled_plain(*args, n_win_per_b)
    if win_q.device.type != "cuda":
        raise ValueError(f"window_attention_tiled: unsupported device {win_q.device}")
    if wants_grad(*args[:7]):
        return twin_grad(
            "window_attention_tiled", _launch_tiled, window_attention_tiled_plain, 7, args, n_win_per_b=n_win_per_b
        )
    return _launch_tiled(*args, n_win_per_b=n_win_per_b)


def _launch_tiled(
    win_q, win_k, win_v, rolled_k, rolled_v, pool_k, pool_v, occ,
    bias_w, bias_r, bias_p, *, n_win_per_b: int,
):
    args = (win_q, win_k, win_v, rolled_k, rolled_v, pool_k, pool_v, occ, bias_w, bias_r, bias_p)
    _check(args, n_win_per_b)
    bf16 = win_q.dtype == torch.bfloat16
    if bf16:
        check_mma("window_attention_tiled", win_q.shape[-1], args[:7])
    nw, nh, t, wsz, ch = win_q.shape
    qt, rl, pl_len = t * wsz, rolled_k.shape[2], pool_k.shape[2]
    rlp, plp = _padded(rl), _padded(pl_len)
    n_split, split_keys = split_plan(qt + rlp + plp, win_q.dtype)
    occ_i = occ.to(torch.int32).contiguous()
    # the grid has a block range per occupied window: this count syncs
    occ_list = torch.nonzero(occ_i).flatten().to(torch.int32)
    n_occ = occ_list.numel()
    if nw + n_occ * n_split > MAX_GRID_Z:
        raise ValueError(f"window_attention_tiled: {nw} windows + {n_occ} x {n_split} splits exceed the grid")
    dev = win_q.device
    out = torch.empty_like(win_q)
    # partial (m, l, o) of each fp32 split; bf16 finishes its rows in place
    n_part = 0 if bf16 else n_occ
    part_m = torch.empty((n_part, nh, n_split, qt), device=dev, dtype=torch.float32)
    part_l = torch.empty_like(part_m)
    part_o = torch.empty((n_part, nh, n_split, qt, ch), device=dev, dtype=torch.float32)
    with kernel("window_attention_tiled"):
        status = _build.library().propainter_window_attention_tiled(
            *[a.data_ptr() for a in (win_q, win_k, win_v, rolled_k, rolled_v, pool_k, pool_v)],
            occ_i.data_ptr(), occ_list.data_ptr(), bias_w.data_ptr(), bias_r.data_ptr(), bias_p.data_ptr(),
            out.data_ptr(), part_m.data_ptr(), part_l.data_ptr(), part_o.data_ptr(),
            nw, n_occ, nh, qt, rl, rlp, pl_len, plp, ch, n_win_per_b, wsz, n_split, split_keys,
            1.0 / math.sqrt(ch), int(bf16), torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(status, "window_attention_tiled")
    return out


def window_attention_dispatch(
    win_q, win_k, win_v, rolled_k, rolled_v, pool_k, pool_v, occ,
    bias_w, bias_r, bias_p, *, n_win_per_b: int,
):
    """The JAX package's choice (`window_attention_pallas`): the
    single-pass kernel below the size estimate 12e6, the tiled one from it."""
    fn = window_attention_tiled if uses_tiled(win_q, rolled_k, pool_k) else window_attention
    return fn(
        win_q, win_k, win_v, rolled_k, rolled_v, pool_k, pool_v, occ,
        bias_w, bias_r, bias_p, n_win_per_b=n_win_per_b,
    )
