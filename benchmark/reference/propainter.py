"""ProPainter's InpaintGenerator (inference), in plain PyTorch.

The encoder with grouped fusion, image propagation (warp-fill, no
weights), feature propagation with first-order deformable alignment,
SoftSplit / SoftComp as unfold / fold with their linear layers, the
8-block temporal sparse transformer and the decoder. NHWC activations,
one window (batch 1) at a time.

Window slots. The pipeline lays a window's frames out in slots: its
local frames from slot 0, its reference frames from slot `l_t_max` (the
local slots of the widest window); block i of the transformer attends
the frames in slots of the parity i % 2. `slots` gives each frame's slot.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import (
    binarize, deform_conv2d, flow_warp, fold_nhwc, layer_norm, leaky_relu, linear,
    max_pool2d, pconv2d, resize_bilinear, resize_nearest, scaled_softmax_attention, unfold_nhwc,
)

CHANNEL = 128
HIDDEN = 512
GROUPS = 16
HEADS = 4
WINDOW = (5, 9)
POOL = (4, 4)
T2T = dict(k=(7, 7), stride=(3, 3), pad=(3, 3))
DEPTHS = 8
_ENC_GROUPS = {10: 2, 12: 4, 14: 8, 16: 1}


def encoder(p, x):
    """[N, H, W, 5] -> [N, H/4, W/4, 128]."""
    out, x0 = x, None
    for i in range(0, 18, 2):
        if i == 8:
            x0 = out
        if i > 8:
            g = _ENC_GROUPS[i]
            n, h, w, _ = out.shape
            out = torch.cat([x0.reshape(n, h, w, g, -1), out.reshape(n, h, w, g, -1)], -1).reshape(n, h, w, -1)
        out = pconv2d(p, f"encoder.layers.{i}", out, stride=(2, 2) if i in (0, 4) else (1, 1), padding=(1, 1),
                      groups=_ENC_GROUPS.get(i, 1))
        out = leaky_relu(out, 0.2)
    return out


def decoder(p, x):
    """[N, h4, w4, 128] -> [N, 4 h4, 4 w4, 3] (before tanh)."""
    def deconv(pre, v):
        return pconv2d(p, pre + ".conv", resize_bilinear(v, 2 * v.shape[1], 2 * v.shape[2], True), padding=(1, 1))

    x = leaky_relu(deconv("decoder.0", x), 0.2)
    x = leaky_relu(pconv2d(p, "decoder.2", x, padding=(1, 1)), 0.2)
    x = leaky_relu(deconv("decoder.4", x), 0.2)
    return pconv2d(p, "decoder.6", x, padding=(1, 1))


# ------------------------------------------------------ image propagation


def _image_direction(xs, ms, flows_prop, flows_check):
    """Warp-fill in one direction over xs [T, H, W, 3], ms [T, H, W, 1]."""
    feats, masks = [xs[0]], [ms[0]]
    feat, mk = xs[0], ms[0]
    for i in range(1, xs.shape[0]):
        fp, fc = flows_prop[i - 1][None], flows_check[i - 1][None]
        warped3 = flow_warp(torch.cat([fc, mk[None]], -1), fp)[0]
        feat_w = flow_warp(feat[None], fp, "nearest")[0]
        fbw = warped3[..., :2]
        mk_valid = binarize(warped3[..., 2:])
        fp0 = fp[0]
        diff = fp0 + fbw
        mag = (fp0**2).sum(-1, keepdim=True) + (fbw**2).sum(-1, keepdim=True)
        valid = ((diff**2).sum(-1, keepdim=True) < 0.01 * mag + 0.5).float()
        union = binarize(ms[i] * valid * (1 - mk_valid))
        feat = union * feat_w + (1 - union) * xs[i]
        mk = binarize(ms[i] * (1 - valid * (1 - mk_valid)))
        feats.append(feat)
        masks.append(mk)
    return torch.stack(feats), torch.stack(masks)


def image_propagation(frames, masks, flows_f, flows_b):
    """frames [T, H, W, 3] in [-1, 1], masks [T, H, W, 1], completed flows
    [T-1, H, W, 2] -> (updated frames, updated masks)."""
    masked = frames * (1 - masks)
    fb_, mb_ = _image_direction(masked.flip(0), masks.flip(0), flows_f.flip(0), flows_b.flip(0))
    fb_, mb_ = fb_.flip(0), mb_.flip(0)
    prop, upd = _image_direction(fb_, mb_, flows_b, flows_f)
    return frames * (1 - masks) + prop * masks, upd


# ---------------------------------------------------- feature propagation


def _align(p, pre, x, cond, flow):
    n, h, w, _ = cond.shape
    o = leaky_relu(pconv2d(p, pre + ".conv_offset.0", cond, padding=(1, 1)), 0.1)
    o = leaky_relu(pconv2d(p, pre + ".conv_offset.2", o, padding=(1, 1)), 0.1)
    o = leaky_relu(pconv2d(p, pre + ".conv_offset.4", o, padding=(1, 1)), 0.1)
    o = pconv2d(p, pre + ".conv_offset.6", o, padding=(1, 1))
    g9 = GROUPS * 9
    offset = 3.0 * torch.tanh(torch.cat([o[..., :g9], o[..., g9 : 2 * g9]], -1)).reshape(n, h, w, GROUPS, 9, 2)
    offset = offset + torch.stack([flow[..., 1], flow[..., 0]], -1)[:, :, :, None, None, :]
    mask = torch.sigmoid(o[..., 2 * g9 :]).reshape(n, h, w, GROUPS, 9)
    return deform_conv2d(x, offset, mask, p[pre + ".weight"], p[pre + ".bias"])


def _feature_direction(p, module, xs, ms, flows_prop, flows_check):
    """xs [T, 1, h, w, 128], ms [T, 1, h, w, 2], flows [T-1, 1, h, w, 2]."""
    da, bb = f"feat_prop_module.deform_align.{module}", f"feat_prop_module.backbone.{module}"
    outs = []
    feat = None
    for i in range(xs.shape[0]):
        cur, mk = xs[i], ms[i]
        if i == 0:
            aligned = cur
        else:
            fp, fc = flows_prop[i - 1], flows_check[i - 1]
            warped = flow_warp(torch.cat([fc, feat], -1), fp)
            fbw, feat_w = warped[..., :2], warped[..., 2:]
            diff = fp + fbw
            mag = (fp**2).sum(-1, keepdim=True) + (fbw**2).sum(-1, keepdim=True)
            valid = ((diff**2).sum(-1, keepdim=True) < 0.01 * mag + 0.5).float()
            cond = torch.cat([cur, feat_w, fp, valid, mk], -1)
            aligned = _align(p, da, feat, cond, fp)
        y = leaky_relu(pconv2d(p, bb + ".0", torch.cat([cur, aligned, mk], -1), padding=(1, 1)), 0.2)
        feat = aligned + pconv2d(p, bb + ".2", y, padding=(1, 1))
        outs.append(feat)
    return torch.stack(outs)


def feature_propagation(p, x, flows_f, flows_b, masks):
    """x [T, h, w, 128], flows [T-1, h, w, 2], masks [T, h, w, 2]."""
    xs, ms = x[:, None], masks[:, None]
    ff, fb = flows_f[:, None], flows_b[:, None]
    bwd = _feature_direction(p, "backward_1", xs.flip(0), ms.flip(0), ff.flip(0), fb.flip(0)).flip(0)
    fwd = _feature_direction(p, "forward_1", bwd, ms, fb, ff)
    y = leaky_relu(pconv2d(p, "feat_prop_module.fuse.0", torch.cat([bwd, fwd, ms], -1)[:, 0], padding=(1, 1)), 0.2)
    return pconv2d(p, "feat_prop_module.fuse.2", y, padding=(1, 1)) + x


# ------------------------------------------------------------ transformer


def _token_hw(h, w):
    (kh, kw), (sh, sw), (ph, pw) = T2T["k"], T2T["stride"], T2T["pad"]
    return (h + 2 * ph - kh) // sh + 1, (w + 2 * pw - kw) // sw + 1


def soft_split(p, x):
    """[T, h, w, 128] -> tokens [T, fh, fw, 512]."""
    fh, fw = _token_hw(x.shape[1], x.shape[2])
    cols = unfold_nhwc(x, T2T["k"], T2T["stride"], T2T["pad"])
    return linear(p, "ss.embedding", cols).reshape(x.shape[0], fh, fw, HIDDEN)


def soft_comp(p, tokens, hw):
    """tokens [T, fh, fw, 512] -> [T, h, w, 128] (fold sums the overlaps)."""
    t = tokens.shape[0]
    cols = linear(p, "sc.embedding", tokens.reshape(t, -1, HIDDEN))
    feat = fold_nhwc(cols, hw, T2T["k"], T2T["stride"], T2T["pad"])
    return pconv2d(p, "sc.bias_conv", feat, padding=(1, 1))


def fusion_ffn(p, pre, x, hw):
    """FusionFeedForward: fc1, fold with the overlap count normalised,
    unfold, GELU, fc2. x [T, fh, fw, 512]."""
    t, fh, fw, _ = x.shape
    y = linear(p, pre + ".fc1.0", x.reshape(t, fh * fw, -1))
    ones = torch.ones_like(y)
    folded = fold_nhwc(y, hw, T2T["k"], T2T["stride"], T2T["pad"])
    norm = fold_nhwc(ones, hw, T2T["k"], T2T["stride"], T2T["pad"])
    y = unfold_nhwc(folded / norm, T2T["k"], T2T["stride"], T2T["pad"])
    y = linear(p, pre + ".fc2.1", torch.nn.functional.gelu(y))
    return y.reshape(t, fh, fw, -1)


def _partition(x):
    """[T, H, W, C] -> [nW, head, T, 45, ch]."""
    t, h, w, c = x.shape
    wh, ww = WINDOW
    x = x.reshape(t, h // wh, wh, w // ww, ww, HEADS, c // HEADS).permute(1, 3, 5, 0, 2, 4, 6)
    return x.reshape((h // wh) * (w // ww), HEADS, t, wh * ww, c // HEADS)


def _rolled_survivors():
    """Positions of the 4 rolled windows' keys outside the un-rolled window."""
    wh, ww = WINDOW
    eh, ew = (wh + 1) // 2, (ww + 1) // 2
    masks = []
    for corner in ("tl", "tr", "bl", "br"):
        m = np.ones((wh, ww), np.bool_)
        hs = slice(None, -eh) if corner in ("tl", "tr") else slice(eh, None)
        ws = slice(None, -ew) if corner in ("tl", "bl") else slice(ew, None)
        m[hs, ws] = False
        masks.append(m)
    return torch.as_tensor(np.nonzero(np.stack(masks).reshape(-1))[0])


def sparse_window_attention(p, pre, x, mask, t_sel):
    """x [T, h, w, C] tokens after LN; mask [l_t, h, w, 1] of the local
    frames; t_sel: the frames the occupied windows attend (a list).
    Occupied windows (the mask touches them in a local frame) attend
    over the selected frames' window keys, rolled keys and pooled keys;
    the others within each frame's own window."""
    t, h, w, c = x.shape
    wh, ww = WINDOW
    eh, ew = (wh + 1) // 2, (ww + 1) // 2
    nh, nw = -(-h // wh), -(-w // ww)
    x = torch.nn.functional.pad(x, (0, 0, 0, nw * ww - w, 0, nh * wh - h))
    mask = torch.nn.functional.pad(mask, (0, 0, 0, nw * ww - w, 0, nh * wh - h))
    q, k, v = (linear(p, f"{pre}.{n}", x) for n in ("query", "key", "value"))
    wq, wk, wv = _partition(q), _partition(k), _partition(v)
    keep = _rolled_survivors().to(x.device)
    shifts = [(-eh, -ew), (-eh, ew), (eh, -ew), (eh, ew)]
    rk = torch.cat([_partition(torch.roll(k, s, dims=(1, 2))) for s in shifts], 3).index_select(3, keep)
    rv = torch.cat([_partition(torch.roll(v, s, dims=(1, 2))) for s in shifts], 3).index_select(3, keep)
    pooled = pconv2d(p, f"{pre}.pool_layer", x, stride=POOL, groups=c)
    pk, pv = linear(p, f"{pre}.key", pooled), linear(p, f"{pre}.value", pooled)
    pk = pk.reshape(t, -1, HEADS, c // HEADS).permute(2, 0, 1, 3)  # [head, T, P, ch]
    pv = pv.reshape(t, -1, HEADS, c // HEADS).permute(2, 0, 1, 3)
    occ = max_pool2d(mask, WINDOW, WINDOW).reshape(mask.shape[0], -1).sum(0) > 0
    out = torch.empty_like(wq)
    sel = torch.as_tensor(t_sel, device=x.device)
    occ_ids = occ.nonzero().reshape(-1)
    for chunk in occ_ids.split(16):
        nwin = len(chunk)
        keys = torch.cat([wk[chunk][:, :, sel], rk[chunk][:, :, sel], pk[None, :, sel].expand(nwin, -1, -1, -1, -1)], 3)
        vals = torch.cat([wv[chunk][:, :, sel], rv[chunk][:, :, sel], pv[None, :, sel].expand(nwin, -1, -1, -1, -1)], 3)
        qa = wq[chunk].reshape(nwin, HEADS, t * wh * ww, -1)
        ya = scaled_softmax_attention(qa, keys.reshape(nwin, HEADS, -1, keys.shape[-1]),
                                      vals.reshape(nwin, HEADS, -1, vals.shape[-1]))
        out[chunk] = ya.reshape(nwin, HEADS, t, wh * ww, -1)
    clean = (~occ).nonzero().reshape(-1)
    if len(clean):
        out[clean] = scaled_softmax_attention(wq[clean], wk[clean], wv[clean])
    out = out.reshape(nh, nw, HEADS, t, wh, ww, c // HEADS).permute(3, 0, 4, 1, 5, 2, 6).reshape(t, nh * wh, nw * ww, c)
    return linear(p, f"{pre}.proj", out[:, :h, :w])


def transformer(p, tokens, hw, mask_pool, slots):
    """The 8 blocks over tokens [T, fh, fw, 512]; block i's occupied
    windows attend the frames whose slot has the parity i % 2."""
    x = tokens
    for i in range(DEPTHS):
        pre = f"transformers.transformer.{i}"
        t_sel = [j for j, s in enumerate(slots) if s % 2 == i % 2]
        x = x + sparse_window_attention(p, pre + ".attention", layer_norm(p, pre + ".norm1", x), mask_pool, t_sel)
        x = x + fusion_ffn(p, pre + ".mlp", layer_norm(p, pre + ".norm2", x), hw)
    return x


def window_forward(p, frames, masks_in, masks_upd, flows_f, flows_b, n_local, slots):
    """One window: frames [T, H, W, 3] in [-1, 1] (its n_local local
    frames, then its reference frames), masks [T, H, W, 1], flows of the
    local frames [n_local - 1, H, W, 2] both ways -> the local frames
    [n_local, H, W, 3] in [-1, 1]."""
    t, hh, ww, _ = frames.shape
    h, w = hh // 4, ww // 4
    feats = torch.cat([encoder(p, torch.cat([frames[i : i + 4], masks_in[i : i + 4], masks_upd[i : i + 4]], -1))
                       for i in range(0, t, 4)])
    ds_ff = resize_bilinear(flows_f, h, w) / 4.0
    ds_fb = resize_bilinear(flows_b, h, w) / 4.0
    ds_in = resize_nearest(masks_in[:n_local], h, w)
    ds_upd = resize_nearest(masks_upd[:n_local], h, w)
    mask_pool = max_pool2d(ds_in, (7, 7), (3, 3), (3, 3))
    local = feature_propagation(p, feats[:n_local], ds_ff, ds_fb, torch.cat([ds_in, ds_upd], -1))
    feats = torch.cat([local, feats[n_local:]])
    tokens = transformer(p, soft_split(p, feats), (h, w), mask_pool, slots)
    feats = feats + soft_comp(p, tokens, (h, w))
    return torch.tanh(torch.cat([decoder(p, feats[i : min(i + 2, n_local)]) for i in range(0, n_local, 2)]))

