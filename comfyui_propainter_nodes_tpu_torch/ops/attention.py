"""Temporal sparse window attention, token (de)composition, transformer.

Port of the JAX package's `ops/attention.py` (segmented path). Window
geometry: (5, 9) windows over the token grid, 4 rolled K/V copies kept
at their 148 out-of-window survivors, and a 4x4 depthwise-pooled global
token grid. Occupied windows attend over [window | rolled | pooled]
keys, clean windows within each frame: both through the window-attention
kernels (ops/cuda/window_attention.py, single-pass or segment-tiled by
the JAX package's size estimate), which read the three key segments as
they are (pooled keys unbroadcast, per batch row). With
PROPAINTER_TPU_ATTN=halo (read at call time) the layer takes the halo
kernel instead (ops/cuda/window_attention_halo.py): it reads windows from
the token grids and a halo of the circularly padded K/V in place of the
rolled copies. Under sequence parallelism (`seq`, parallel/sequence.py)
the layer takes no kernel, as in the JAX package: each rank's queries
attend over K/V segments all-gathered across the ranks, in stock torch
ops (`_gathered_kv_attention`). Under the spatial H split (`split`, a
`parallel/spatial.py::Partition`) each rank runs its own windows, its
token rows of everything else, and fetches from the other ranks the
rows its ops read past its edges: the rolled K/V's (circular), the
pooled tokens (gathered), and those of the soft split's, soft comp's
and the FFN's patches. Without it the same bodies run on one rank's
whole grids (`Partition(None, None, fh)`, `RowSplit.whole`). Under
tensor parallelism (`tp`, the training step's: parallel/sharding.py)
each rank runs its heads of q/k/v and its share of the FFN's hidden
channels on `shard_params` shards; the attention's proj and the FFN's
fc2 sum the ranks' partial products (`reduce_from`) and add their whole
bias after, and `copy_to` stands in front of q/k/v, the pooled tokens'
key/value and fc1.

SoftSplit is one strided conv; SoftComp and FusionFeedForward run in
stride-phase space (fold/unfold composed with the linear layers become
3x3 convs over the token grid), exactly as in the JAX package.
"""

from __future__ import annotations

import functools
import math
import os
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.sharding import copy_to, reduce_from
from ..parallel.spatial import Partition, RowSplit, token_rows
from .conv import conv2d, layer_norm, linear
from .cuda.window_attention import window_attention_dispatch
from .cuda.window_attention_halo import window_attention_halo
from .pool import max_pool2d

Params = Mapping[str, torch.Tensor]

_T2T = {"kernel": (7, 7), "stride": (3, 3), "padding": (3, 3)}
NEG = -1e9


# ------------------------------------------------------- token (de)compose


def _phase_kernel(wmat: torch.Tensor, bias: torch.Tensor, c_out: int, flip: bool) -> torch.Tensor:
    """[in, c_out*49] linear weight -> OIHW [9*c_out, in+1, dh, dw] conv
    kernel over the token grid; the +1 input channel carries the bias."""
    (kh, kw), (sh, sw) = _T2T["kernel"], _T2T["stride"]
    dh, dw = -(-kh // sh), -(-kw // sw)
    cin = wmat.shape[0]
    k = wmat.reshape(cin, c_out, kh, kw)
    k = torch.cat([k, bias.reshape(1, c_out, kh, kw)], dim=0)
    k = F.pad(k, (0, sw * dw - kw, 0, sh * dh - kh))
    k = k.reshape(cin + 1, c_out, dh, sh, dw, sw).permute(2, 4, 0, 3, 5, 1)  # [d1,d2,in+1,a,b,c]
    if flip:  # fold direction: phase[q] += token[q - d]
        k = k.flip(0, 1)
    k = k.reshape(dh, dw, cin + 1, sh * sw * c_out)
    return k.permute(3, 2, 0, 1)


def _phase_fold_conv(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Token grid [N, fh, fw, in] -> phase canvases [N, qh, qw, 9*c_out]."""
    dh, dw = kernel.shape[2], kernel.shape[3]
    ones = x.new_ones(x.shape[:-1] + (1,))
    return conv2d(torch.cat([x, ones], dim=-1), kernel, padding=(dh - 1, dw - 1))


def _interleave_phases(ph_canvas: torch.Tensor, c_out: int, w: int, r0: int, r1: int) -> torch.Tensor:
    """[N, qh, qw, 9*c_out] -> the pixel canvas's rows [r0, r1) (row ph is
    the output's first), cropped to the output's w columns: [N, r1 - r0,
    w, c_out]."""
    (sh, sw), (_, pw) = _T2T["stride"], _T2T["padding"]
    n, qh, qw, _ = ph_canvas.shape
    out = ph_canvas.reshape(n, qh, qw, sh, sw, c_out).permute(0, 1, 3, 2, 4, 5)
    out = out.reshape(n, qh * sh, qw * sw, c_out)
    pad_h = max(0, r1 - qh * sh)
    pad_w = max(0, pw + w - qw * sw)
    if pad_h or pad_w:
        out = F.pad(out, (0, 0, 0, pad_w, 0, pad_h))
    return out[:, r0:r1, pw : pw + w, :]


@functools.lru_cache(maxsize=32)
def _phase_mult(fh: int, fw: int, h: int, w: int) -> np.ndarray:
    """Per-phase multiplier [qh, qw, 9]: 1/overlap-count inside the
    cropped canvas, 0 outside."""
    (kh, kw), (sh, sw), (ph, pw) = _T2T["kernel"], _T2T["stride"], _T2T["padding"]

    def axis(f, size, k, s, pad):
        d_n = -(-k // s)
        q = f - 1 + d_n
        count = np.zeros((q, s))
        for a in range(s):
            for d in range(d_n):
                if a + s * d >= k:
                    continue
                qs = np.arange(q)
                count[(qs - d >= 0) & (qs - d < f), a] += 1
        pix = np.arange(q)[:, None] * s + np.arange(s)[None]
        mask = (pix >= pad) & (pix < pad + size)
        return mask / np.maximum(count, 1)

    my = axis(fh, h, kh, sh, ph)
    mx = axis(fw, w, kw, sw, pw)
    m = my[:, None, :, None] * mx[None, :, None, :]
    return m.reshape(m.shape[0], m.shape[1], sh * sw).astype(np.float32)


def soft_split(p: Params, pre: str, x: torch.Tensor, rows=None) -> torch.Tensor:
    """SoftSplit: [N, H, W, C] -> [N, f_h, f_w, hidden] (linear∘unfold as one
    7x7 stride-3 conv; torch's (C, kh, kw)-major unfold order is OIHW).
    rows = (feature, token `RowSplit`s) under the H split, the whole grids
    by default: x holds the rank's feature rows, the result is its token
    rows (token row r reads feature rows [3r - 3, 3r + 4), zero outside
    the image)."""
    w = p[pre + ".embedding.weight"]  # (hidden, C*49)
    c = w.shape[1] // 49
    kernel = w.reshape(w.shape[0], c, 7, 7)
    bias = p[pre + ".embedding.bias"]
    if rows is None:
        rows = RowSplit.whole(x.shape[1]), RowSplit.whole(token_rows(x.shape[1]))
    feat, tok = rows
    (kh, _), (sh, _), (ph, pw) = _T2T["kernel"], _T2T["stride"], _T2T["padding"]
    ext, start = feat.halo(x, ph, kh - sh - ph, 1)
    if tok.lo == tok.hi:
        return x.new_zeros((x.shape[0], 0, (x.shape[2] - 1) // sh + 1, w.shape[0]))
    lo, hi = sh * tok.lo - ph, sh * (tok.hi - 1) + kh - ph  # the feature rows the rank's tokens read
    a, b = max(lo, start), min(hi, start + ext.shape[1])
    v = F.pad(ext[:, a - start : b - start], (0, 0, 0, 0, a - lo, hi - b))
    return conv2d(v, kernel, bias, stride=_T2T["stride"], padding=(0, pw))


def soft_comp(p: Params, pre: str, tokens: torch.Tensor, output_size, rows=None) -> torch.Tensor:
    """SoftComp: [N, f_h, f_w, hidden] -> [N, H, W, C] (+ 3x3 bias conv).
    rows = (token, feature `RowSplit`s) under the H split, the whole grids
    by default: tokens holds the rank's token rows, the result is its
    feature rows; a feature row's phase reads 3 token rows, and the bias
    conv one feature row each side."""
    w = p[pre + ".embedding.weight"]  # (C*49, hidden)
    b = p[pre + ".embedding.bias"]
    c = b.shape[0] // 49
    kernel = _phase_kernel(w.t(), b, c, flip=True)
    if rows is None:
        rows = RowSplit.whole(tokens.shape[1]), RowSplit.whole(output_size[0])
    tok, feat = rows
    ext, a = tok.halo(tokens, 2, 2, 1)
    if feat.lo == feat.hi:
        return tokens.new_zeros((tokens.shape[0], 0, output_size[1], c))
    sh, ph = _T2T["stride"][0], _T2T["padding"][0]
    # the canvas's feature rows [c0, c1) the bias conv reads; canvas row
    # k of the phases of token rows [a, ..) is feature row sh * a + k - ph
    c0, c1 = max(0, feat.lo - 1), min(feat.total, feat.hi + 1)
    canvas = _interleave_phases(_phase_fold_conv(ext, kernel), c, output_size[1], c0 + ph - sh * a, c1 + ph - sh * a)
    out = conv2d(canvas, p[pre + ".bias_conv.weight"], p[pre + ".bias_conv.bias"], padding=(1, 1))
    return out[:, feat.lo - c0 : feat.hi - c0]


def fusion_feed_forward(p: Params, pre: str, x: torch.Tensor, output_size, rows=None, tp=None) -> torch.Tensor:
    """FusionFeedForward in phase space: fold∘fc1 as a 3x3 token-grid conv,
    the fold normalisation as a static per-phase multiplier, exact GELU,
    fc2∘unfold as a 3x3 VALID conv. x: [N, f_h, f_w, dim]. rows (the H
    split's token `RowSplit`, the whole grid by default): x holds the
    rank's token rows; an output row reads the 2 token rows each side of
    it, and the multiplier is the whole grid's at the rows computed.
    tp = (mesh, axis): fc1 column parallel, fc2 row parallel (the hidden
    channels are whole 49-position groups, so the fold is rank-local)."""
    if rows is None:
        rows = RowSplit.whole(x.shape[1])
    if tp is not None:
        x = copy_to(x, *tp)
    ext, q0 = rows.halo(x, 2, 2, 1)
    if rows.lo == rows.hi:  # a rank without rows only takes part in the exchange
        return x
    x = ext
    n, _, fw, _ = x.shape
    b1 = p[pre + ".fc1.0.bias"]
    c_mid = b1.shape[0] // 49
    k1 = _phase_kernel(p[pre + ".fc1.0.weight"].t(), b1, c_mid, flip=True)
    y = _phase_fold_conv(x, k1)
    qh, qw = y.shape[1], y.shape[2]
    mult = torch.from_numpy(_phase_mult(rows.total, fw, *output_size)[q0 : q0 + qh]).to(y.device, y.dtype)
    y = y.reshape(n, qh, qw, 9, c_mid) * mult[..., None]
    y = F.gelu(y.reshape(n, qh, qw, 9 * c_mid))

    (kh, kw), (sh, sw) = _T2T["kernel"], _T2T["stride"]
    dh, dw = -(-kh // sh), -(-kw // sw)
    w2 = p[pre + ".fc2.1.weight"]  # (dim, c_mid*49)
    dim = w2.shape[0]
    k2 = w2.t().reshape(c_mid, kh, kw, dim)
    k2 = F.pad(k2, (0, 0, 0, sw * dw - kw, 0, sh * dh - kh))
    k2 = k2.reshape(c_mid, dh, sh, dw, sw, dim).permute(1, 3, 2, 4, 0, 5)
    k2 = k2.reshape(dh, dw, sh * sw * c_mid, dim).permute(3, 2, 0, 1)
    b2 = p[pre + ".fc2.1.bias"]
    out = conv2d(y, k2, None if tp is not None else b2)[:, rows.lo - q0 : rows.hi - q0]
    if tp is not None:
        out = reduce_from(out, *tp) + b2.to(out.dtype)
    return out


# ----------------------------------------------------------- window helpers


@functools.lru_cache(maxsize=8)
def _valid_rolled_indices(window_size: tuple[int, int]) -> np.ndarray:
    """Static survivors of the 4 rolled K/V copies (positions outside the
    un-rolled window), concatenated over (tl, tr, bl, br)."""
    wh, ww = window_size
    eh, ew = (wh + 1) // 2, (ww + 1) // 2
    masks = []
    for corner in ("tl", "tr", "bl", "br"):
        m = np.ones((wh, ww), np.bool_)
        hs = slice(None, -eh) if corner in ("tl", "tr") else slice(eh, None)
        ws = slice(None, -ew) if corner in ("tl", "bl") else slice(ew, None)
        m[hs, ws] = False
        masks.append(m)
    return np.nonzero(np.stack(masks, 0).reshape(-1))[0]


def _window_partition(x: torch.Tensor, window, n_head: int) -> torch.Tensor:
    """[B, T, H, W, C] -> [B, nW, head, T, wh*ww, C/head]."""
    b, t, h, w, c = x.shape
    wh, ww = window
    nh, nw = h // wh, w // ww
    x = x.reshape(b, t, nh, wh, nw, ww, n_head, c // n_head)
    x = x.permute(0, 2, 4, 6, 1, 3, 5, 7)
    return x.reshape(b, nh * nw, n_head, t, wh * ww, c // n_head)


def _build_rolled(ap: torch.Tensor, window, n_head: int) -> torch.Tensor:
    """The 4 diagonally rolled copies of a [B, T, H, W, C] key grid,
    window-partitioned and kept at their out-of-window survivors:
    [B, nW, head, T, 148, ch]. Partition of each roll == a shifted-origin
    partition of ONE circularly padded tensor. ap: the grid with its
    circular rows, (wh + 1) // 2 each side of H."""
    wh, ww = window
    eh, ew = (wh + 1) // 2, (ww + 1) // 2
    h, w = ap.shape[2] - 2 * eh, ap.shape[3]
    ap = torch.cat([ap[:, :, :, -ew:], ap, ap[:, :, :, :ew]], dim=3)
    parts = []
    for s_y, s_x in [(-eh, -ew), (-eh, ew), (eh, -ew), (eh, ew)]:
        oy, ox = eh - s_y, ew - s_x
        parts.append(_window_partition(ap[:, :, oy : oy + h, ox : ox + w], window, n_head))
    idx = torch.as_tensor(_valid_rolled_indices(tuple(window)), device=ap.device)
    return torch.cat(parts, dim=4).index_select(4, idx)


LOGITS_BYTES = 1.2e9  # past this the gathered-KV logits run in window chunks of about half of it


def _gathered_kv_attention(q, k, v, pool_k, pool_v, occ, ti, tv, seq, window, n_head: int):
    """The attention of one rank's T share over key segments gathered
    from every share (the JAX package's XLA branch under `axis_name`,
    ops/attention.py:314-320 and 444-533 there), in stock torch ops: K, V
    and the pooled K/V are all-gathered over the axis, and the window and
    rolled segments are built from the gathered K/V at the global t_ind
    frames (JAX gathers the two segments, which are index maps of the
    same frames: 4.3 times the bytes, 45 + 148 keys a window position);
    occupied windows attend over them with the global validity tv as an
    additive -1e9 key bias, in chunks of windows past LOGITS_BYTES of
    fp32 logits; clean windows attend within each local frame.
    q/k/v [B, T, H', W', C] (window-padded grid, this rank's frames);
    pool_k/pool_v [B, T, ph, pw, C]; occ [B, nW] bool; ti global frame
    indices; tv [B, T_glob] bool. Returns [B, T, H', W', C]."""
    mesh, axis = seq
    b, t, new_h, new_w, c = q.shape
    wh, ww = window
    ch = c // n_head
    n_wh, n_ww = new_h // wh, new_w // ww
    n_win = n_wh * n_ww
    dev = q.device

    win_q = _window_partition(q, window, n_head)  # [B, nW, hd, T, 45, ch]
    win_k = _window_partition(k, window, n_head)
    win_v = _window_partition(v, window, n_head)
    ti_t = torch.as_tensor(np.asarray(ti), device=dev)

    def global_sel(a):  # [B, T, ...] -> [B, t_sel, ...] at the global t_ind frames
        return mesh.all_gather(a, axis, dim=1).index_select(1, ti_t)

    k_sel, v_sel = global_sel(k), global_sel(v)
    wk_s, wv_s = _window_partition(k_sel, window, n_head), _window_partition(v_sel, window, n_head)
    eh = (wh + 1) // 2
    rk_s, rv_s = (_build_rolled(RowSplit.whole(new_h).halo(a, eh, eh, 2, circular=True)[0], window, n_head)
                  for a in (k_sel, v_sel))
    t_sel = len(ti)
    p_len = pool_k.shape[2] * pool_k.shape[3]

    def heads_of(a):  # [B, t_sel, ph, pw, C] -> [B, head, t_sel, ph*pw, ch]
        return a.reshape(b, t_sel, p_len, n_head, ch).permute(0, 3, 1, 2, 4)

    pk_s, pv_s = heads_of(global_sel(pool_k)), heads_of(global_sel(pool_v))
    k_per_t = wh * ww + rk_s.shape[4] + p_len
    key_bias = torch.where(tv.index_select(1, ti_t), 0.0, NEG).repeat_interleave(k_per_t, dim=1)
    scale = 1.0 / math.sqrt(ch)

    def occupied(lo: int, hi: int):
        cw = hi - lo
        pk_b = pk_s[:, None].expand(b, cw, n_head, t_sel, p_len, ch)
        pv_b = pv_s[:, None].expand(b, cw, n_head, t_sel, p_len, ch)
        ka = torch.cat([wk_s[:, lo:hi], rk_s[:, lo:hi], pk_b], dim=4).reshape(b, cw, n_head, t_sel * k_per_t, ch)
        va = torch.cat([wv_s[:, lo:hi], rv_s[:, lo:hi], pv_b], dim=4).reshape(b, cw, n_head, t_sel * k_per_t, ch)
        qa = win_q[:, lo:hi].reshape(b, cw, n_head, t * wh * ww, ch)
        att = torch.einsum("bwhqc,bwhkc->bwhqk", qa, ka) * scale
        att = torch.softmax(att + key_bias[:, None, None, None, :].to(att.dtype), dim=-1)
        return torch.einsum("bwhqk,bwhkc->bwhqc", att, va).reshape(b, cw, n_head, t, wh * ww, ch)

    logits_bytes = b * n_win * n_head * (t * wh * ww) * (t_sel * k_per_t) * 4
    step = n_win if logits_bytes <= LOGITS_BYTES else max(1, int(6e8 // (logits_bytes // n_win)))
    out_a = torch.cat([occupied(lo, min(n_win, lo + step)) for lo in range(0, n_win, step)], dim=1)

    att_b = torch.softmax(torch.einsum("bwhtqc,bwhtkc->bwhtqk", win_q, win_k) * scale, dim=-1)
    out_b = torch.einsum("bwhtqk,bwhtkc->bwhtqc", att_b, win_v)
    out = torch.where(occ[:, :, None, None, None, None], out_a, out_b)
    out = out.reshape(b, n_wh, n_ww, n_head, t, wh, ww, ch)
    return out.permute(0, 4, 1, 5, 2, 6, 3, 7).reshape(b, t, new_h, new_w, c)


def _pooled_rows(x, pool_w, grid, pool, pool_size) -> torch.Tensor:
    """The H split's pooled tokens [B*T, p_h, p_w, C], whole on every rank:
    each rank pools the pool rows that start in its rows of the
    window-padded token grid `grid` (the next 3 token rows from its
    neighbour), and the rows are gathered (`pool`: the pool rows' split)."""
    b, t, _, w, c = x.shape
    ext, start = grid.halo(x, 0, pool_size[0] - 1, 2)
    r0, r1 = pool_size[0] * pool.lo - start, pool_size[0] * pool.hi - start
    mine = x.new_zeros((b * t, 0, w // pool_size[1], c))
    if r0 < r1:  # the rows past r1 are fewer than a pool row: the conv drops them
        mine = conv2d(ext[:, :, r0:].reshape(b * t, ext.shape[2] - r0, w, c), *pool_w, stride=pool_size, groups=c)
    return pool.gather(mine, 1)


def _proj(p: Params, name: str, x: torch.Tensor, tp) -> torch.Tensor:
    """The output projection; row parallel under tp: the rank's partial
    product summed over the ranks, then the whole bias."""
    if tp is None:
        return linear(p, name, x)
    y = reduce_from(F.linear(x, p[name + ".weight"].to(x.dtype)), *tp)
    return y + p[name + ".bias"].to(x.dtype)


def sparse_window_attention(
    p: Params,
    pre: str,
    x: torch.Tensor,
    mask: torch.Tensor,
    t_ind,
    n_head: int = 4,
    window_size: tuple[int, int] = (5, 9),
    pool_size: tuple[int, int] = (4, 4),
    t_valid_mask: torch.Tensor | None = None,
    seq=None,
    split=None,
    tp=None,
) -> torch.Tensor:
    """SparseWindowAttention.forward.

    x: [B, T, H, W, C] tokens (post-LN); mask: [B, l_t, H, W, 1] local
    sparsity mask; t_ind: frame subset for the occupied branch (temporal
    dilation) or None; t_valid_mask: [T] or [B, T] bool, keys of padded
    frames are masked out of the occupied branch.

    seq = (mesh, axis): sequence parallelism (parallel/sequence.py). x is
    this rank's contiguous share of T; the occupied branch attends over
    key segments all-gathered across the axis (`_gathered_kv_attention`).
    mask, t_ind and t_valid_mask are then the whole clip's (global T).

    split (a `Partition`): the H split, the whole grid by default. x and
    mask hold the rank's token rows; it attends its own windows (the last
    window row's padding is the rank's), takes the circular rows of the
    rolled K/V from its neighbours and the pooled tokens from every rank
    (`_pooled_rows`).

    tp = (mesh, axis): tensor parallelism (the training step's), on the
    whole grid: q/k/v hold the rank's heads (n_head is the whole count;
    the rank runs n_head * its q channels / C of them), the pooled
    tokens are whole, proj is row parallel."""
    b, t, h, w, c = x.shape
    dev = x.device
    wh, ww = window_size
    ch = c // n_head
    if split is None:
        split = Partition(None, None, h)
    grid = split.padded_tokens()
    n_wh, n_ww = grid.rows // wh, -(-w // ww)
    new_h, new_w = n_wh * wh, n_ww * ww
    if new_h != h or new_w != w:
        x = F.pad(x, (0, 0, 0, new_w - w, 0, new_h - h))
        mask = F.pad(mask, (0, 0, 0, new_w - w, 0, new_h - h))
    n_win = n_wh * n_ww

    xq = x if tp is None else copy_to(x, *tp)
    q = linear(p, pre + ".query", xq)
    k = linear(p, pre + ".key", xq)
    v = linear(p, pre + ".value", xq)
    cq = q.shape[-1]  # the rank's channels of q/k/v: C, or its heads' under tp
    heads = n_head * cq // c

    # pooled global tokens: depthwise 4x4 stride-4 conv, then key/value
    pool_w = p[pre + ".pool_layer.weight"], p[pre + ".pool_layer.bias"]
    pool_x = _pooled_rows(x, pool_w, grid, split.pool_rows(grid.total // pool_size[0]), pool_size)
    p_h, p_w = pool_x.shape[1], pool_x.shape[2]
    pool_x = pool_x.reshape(b, t, p_h, p_w, c)
    if tp is not None:
        pool_x = copy_to(pool_x, *tp)

    # occupancy: a window is occupied if the mask touches it in any local frame
    l_t = mask.shape[1]
    occ = torch.zeros((b, 0), dtype=torch.bool, device=dev)  # a rank of the H split without rows has no window
    if n_win:
        occ = max_pool2d(mask.reshape(b * l_t, new_h, new_w, 1), window_size, window_size)
        occ = occ.reshape(b, l_t, n_win).sum(dim=1) > 0

    if seq is not None:
        t_glob = t * seq[0].shape[seq[1]]
        ti = np.arange(t_glob) if t_ind is None else np.asarray(t_ind)
        tv = torch.ones((b, t_glob), dtype=torch.bool, device=dev)
        if t_valid_mask is not None:
            tv = t_valid_mask.to(dev).reshape(-1, t_glob).expand(b, t_glob)
        out = _gathered_kv_attention(
            q, k, v, linear(p, pre + ".key", pool_x), linear(p, pre + ".value", pool_x), occ, ti, tv, seq,
            window_size, heads,
        )
        return _proj(p, pre + ".proj", out[:, :, :h, :w], tp)

    ti = np.arange(t) if t_ind is None else np.asarray(t_ind)
    ti_t = torch.as_tensor(ti, device=dev)
    t_sel = len(ti)
    eh, ew = (wh + 1) // 2, (ww + 1) // 2

    def heads_of(a):  # [B, T, ph, pw, C] -> [B, head, T_sel*ph*pw, ch]
        a = a.reshape(b, t, p_h * p_w, heads, ch).permute(0, 3, 1, 2, 4)
        return a.index_select(2, ti_t).reshape(b, heads, t_sel * p_h * p_w, ch).contiguous()

    pk = heads_of(linear(p, pre + ".key", pool_x))
    pv = heads_of(linear(p, pre + ".value", pool_x))

    if t_valid_mask is None:
        tv = torch.ones((b, t), dtype=torch.bool, device=dev)
    else:
        tv = t_valid_mask.to(dev).reshape(-1, t).expand(b, t)
    in_tind = torch.zeros(t, dtype=torch.bool, device=dev)
    in_tind[ti_t] = True
    zero = torch.zeros((), device=dev)
    neg = torch.full((), NEG, device=dev)
    bias_w = torch.where(in_tind[None] & tv, zero, neg).repeat_interleave(wh * ww, dim=1).float().contiguous()
    bias_sel = torch.where(tv.index_select(1, ti_t), zero, neg).float()
    bias_p = bias_sel.repeat_interleave(p_h * p_w, dim=1).contiguous()

    # K and V at the t_ind frames with eh circular rows each side of H (the
    # rolled copies' rows, and the halo kernel's): under the split, the
    # rows past the rank's edges from its neighbours, K and V in one exchange
    kv = grid.halo(torch.cat([k, v], dim=-1).index_select(1, ti_t), eh, eh, 2, circular=True)[0]
    k_h, v_h = kv[..., :cq], kv[..., cq:]
    if n_win == 0:
        return x[:, :, :h, :w]

    # read at call time, as the JAX package does; like it, the halo form
    # takes every size (its blocks do not grow with the token grid)
    if os.environ.get("PROPAINTER_TPU_ATTN", "segmented") == "halo":

        def cpad(a):  # circular pad of the window-padded grid at the t_ind frames
            return torch.cat([a[:, :, :, -ew:], a, a[:, :, :, :ew]], dim=3).contiguous()

        out = window_attention_halo(
            q.contiguous(), k.contiguous(), v.contiguous(), cpad(k_h), cpad(v_h), pk, pv,
            occ.reshape(b, n_wh, n_ww).contiguous(), bias_w, bias_sel.contiguous(), bias_p,
            window_size=window_size, n_head=heads,
        )
        return _proj(p, pre + ".proj", out[:, :, :h, :w], tp)

    win_q = _window_partition(q, window_size, heads)
    win_k = _window_partition(k, window_size, heads)
    win_v = _window_partition(v, window_size, heads)
    # rolled keys at the t_ind frames only
    rk = _build_rolled(k_h, window_size, heads)
    rv = _build_rolled(v_h, window_size, heads)
    n_rolled = rk.shape[4]
    bias_r = bias_sel.repeat_interleave(n_rolled, dim=1).contiguous()

    out = window_attention_dispatch(
        win_q.reshape(b * n_win, heads, t, wh * ww, ch).contiguous(),
        win_k.reshape(b * n_win, heads, t, wh * ww, ch).contiguous(),
        win_v.reshape(b * n_win, heads, t, wh * ww, ch).contiguous(),
        rk.reshape(b * n_win, heads, t_sel * n_rolled, ch).contiguous(),
        rv.reshape(b * n_win, heads, t_sel * n_rolled, ch).contiguous(),
        pk, pv, occ.reshape(b * n_win).contiguous(), bias_w, bias_r, bias_p,
        n_win_per_b=n_win,
    )
    out = out.reshape(b, n_wh, n_ww, heads, t, wh, ww, ch)
    out = out.permute(0, 4, 1, 5, 2, 6, 3, 7).reshape(b, t, new_h, new_w, cq)
    return _proj(p, pre + ".proj", out[:, :, :h, :w], tp)


# -------------------------------------------------------------- FFN + block


def transformer_block(
    p: Params, pre: str, x, fold_size, mask, t_ind, t_valid_mask=None, seq=None, split=None, tp=None,
):
    """TemporalSparseTransformer. x: [B, T, f_h, f_w, C] tokens (the rank's
    token rows under the H split `split`); tp: tensor parallelism."""
    b, t, fh, fw, c = x.shape
    att = sparse_window_attention(
        p, pre + ".attention", layer_norm(p, pre + ".norm1", x), mask, t_ind,
        t_valid_mask=t_valid_mask, seq=seq, split=split, tp=tp,
    )
    x = x + att
    y = layer_norm(p, pre + ".norm2", x)
    rows = None if split is None else split.tokens()
    mlp = fusion_feed_forward(p, pre + ".mlp", y.reshape(b * t, fh, fw, c), fold_size, rows, tp)
    return x + mlp.reshape(b, t, fh, fw, c)


def transformer_stack(
    p: Params, pre: str, x, fold_size, mask, depths: int = 8, t_dilation: int = 2,
    t_valid_mask=None, seq=None, t_total: int | None = None, split=None, tp=None,
):
    """TemporalSparseTransformerBlock: `depths` blocks, block i attends the
    temporal-dilation frame subset arange(i % t_dilation, T, t_dilation).
    seq / t_total: sequence parallelism (x is this rank's T share; the
    frame subsets are of the global t_total frames). split: the H split's
    `Partition` (x and mask hold the rank's token rows). tp: tensor
    parallelism (`sparse_window_attention`), not combined with the others."""
    if tp is not None and (seq is not None or not (split is None or split.whole)):
        raise ValueError("transformer_stack: tensor parallelism runs without the sequence or the spatial split")
    t = t_total if t_total is not None else x.shape[1]
    for i in range(depths):
        x = transformer_block(
            p, f"{pre}.transformer.{i}", x, fold_size, mask,
            np.arange(i % t_dilation, t, t_dilation), t_valid_mask, seq=seq, split=split, tp=tp,
        )
    return x
