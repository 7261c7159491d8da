"""Occupancy-sparse window attention: CUDA kernel (csrc/window_attention.cu) + plain version.

Signature (the JAX package's `window_attention_pallas`):
  win_q, win_k, win_v  [W, head, T, wsz, ch]   W = B * n_win_per_b
  rolled_k, rolled_v   [W, head, RL, ch]       t_ind-selected rolled keys
  pool_k, pool_v       [B, head, PL, ch]       t_ind-selected, unbroadcast
  occ                  [W] bool                window touched by the mask
  bias_w [B, T*wsz], bias_r [B, RL], bias_p [B, PL] fp32 additive biases
Returns [W, head, T, wsz, ch] in win_q's dtype. Occupied windows attend
over [window | rolled | pooled] keys; clean windows attend within each
frame's own wsz keys. CPU tensors take the plain version; CUDA tensors
take the kernel.
"""

from __future__ import annotations

import math

import torch

from . import _build

launches = 0  # kernel launches since the last reset


def window_attention_plain(
    win_q, win_k, win_v, rolled_k, rolled_v, pool_k, pool_v, occ,
    bias_w, bias_r, bias_p, n_win_per_b: int,
):
    """Both branches for every window, selected by occupancy (the JAX
    package's XLA form), in fp32."""
    nw, nh, t, wsz, ch = win_q.shape
    b = nw // n_win_per_b
    scale = 1.0 / math.sqrt(ch)
    q = win_q.float()
    k = win_k.float()
    v = win_v.float()

    def per_window(a):  # [B, head, L, ch] -> [W, head, L, ch]
        return a.float()[:, None].expand(b, n_win_per_b, *a.shape[1:]).reshape(nw, *a.shape[1:])

    qa = q.reshape(nw, nh, t * wsz, ch)
    k_all = torch.cat([k.reshape(nw, nh, t * wsz, ch), rolled_k.float(), per_window(pool_k)], dim=2)
    v_all = torch.cat([v.reshape(nw, nh, t * wsz, ch), rolled_v.float(), per_window(pool_v)], dim=2)
    bias = torch.cat([bias_w, bias_r, bias_p], dim=1).float()
    bias = bias.repeat_interleave(n_win_per_b, dim=0)[:, None, None, :]
    att_a = torch.matmul(qa, k_all.transpose(-1, -2)) * scale + bias
    out_a = torch.matmul(torch.softmax(att_a, dim=-1), v_all).reshape(nw, nh, t, wsz, ch)
    att_b = torch.matmul(q, k.transpose(-1, -2)) * scale
    out_b = torch.matmul(torch.softmax(att_b, dim=-1), v)
    out = torch.where(occ.reshape(nw, 1, 1, 1, 1).bool(), out_a, out_b)
    return out.to(win_q.dtype)


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


def window_attention(
    win_q, win_k, win_v, rolled_k, rolled_v, pool_k, pool_v, occ,
    bias_w, bias_r, bias_p, *, n_win_per_b: int,
):
    global launches
    args = (win_q, win_k, win_v, rolled_k, rolled_v, pool_k, pool_v, occ, bias_w, bias_r, bias_p)
    if win_q.device.type == "cpu":
        return window_attention_plain(*args, n_win_per_b)
    if win_q.device.type != "cuda":
        raise ValueError(f"window_attention: unsupported device {win_q.device}")
    _check(args, n_win_per_b)
    nw, nh, t, wsz, ch = win_q.shape
    occ_i = occ.to(torch.int32).contiguous()
    out = torch.empty_like(win_q)
    lib = _build.library()
    status = lib.propainter_window_attention(
        *[a.data_ptr() for a in (win_q, win_k, win_v, rolled_k, rolled_v, pool_k, pool_v)],
        occ_i.data_ptr(), bias_w.data_ptr(), bias_r.data_ptr(), bias_p.data_ptr(),
        out.data_ptr(), nw, nh, t * wsz, rolled_k.shape[2], pool_k.shape[2], ch,
        n_win_per_b, wsz, 1.0 / math.sqrt(ch), int(win_q.dtype == torch.bfloat16),
        torch.cuda.current_stream(win_q.device).cuda_stream,
    )
    _build.check(status, "window_attention")
    launches += 1
    return out
