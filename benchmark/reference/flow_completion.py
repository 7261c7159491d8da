"""The recurrent flow completion network, in plain PyTorch.

NDHWC activations: the P3D encoder, the mid dilation, the second-order
bidirectional propagation with deformable alignment (a Python loop over
frames), the decoder. Each direction of the flows is completed on its
own (the network couples nothing across its batch).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .ops import deform_conv2d, leaky_relu, pconv2d, pconv3d, resize_bilinear

CHANNEL = 128
GROUPS = 16
DECODE_FRAMES = 8  # frames a decoder call: its full-res activations stay small


def _p3d(p, pre, x, stride):
    y = leaky_relu(pconv3d(p, pre + ".conv1.0", x, stride=(1, stride, stride), padding=(0, 1, 1)), 0.2)
    return pconv3d(p, pre + ".conv2.0", y, padding=(2, 0, 0), dilation=(2, 1, 1))


def _deconv(p, pre, x):
    _, h, w, _ = x.shape
    return pconv2d(p, pre + ".conv", resize_bilinear(x, 2 * h, 2 * w, align_corners=True), padding=(1, 1))


def _align(p, pre, x, extra):
    """SecondOrderDeformableAlignment: x [N, H, W, 2C], extra [N, H, W, 3C]."""
    n, h, w, _ = x.shape
    o = leaky_relu(pconv2d(p, pre + ".conv_offset.0", extra, padding=(1, 1)), 0.1)
    o = leaky_relu(pconv2d(p, pre + ".conv_offset.2", o, padding=(1, 1)), 0.1)
    o = leaky_relu(pconv2d(p, pre + ".conv_offset.4", o, padding=(1, 1)), 0.1)
    o = pconv2d(p, pre + ".conv_offset.6", o, padding=(1, 1))
    g9 = GROUPS * 9
    offset = 5.0 * torch.tanh(torch.cat([o[..., :g9], o[..., g9 : 2 * g9]], -1)).reshape(n, h, w, GROUPS, 9, 2)
    mask = torch.sigmoid(o[..., 2 * g9 :]).reshape(n, h, w, GROUPS, 9)
    return deform_conv2d(x, offset, mask, p[pre + ".weight"], p[pre + ".bias"])


def _direction(p, module, xs, extra):
    """One propagation direction over xs [T, N, H, W, C] in its order."""
    da, bb = f"feat_prop_module.deform_align.{module}", f"feat_prop_module.backbone.{module}"
    zeros = torch.zeros_like(xs[0])
    prev1 = prev2 = zeros
    outs = []
    for i in range(xs.shape[0]):
        cur = xs[i]
        if i == 0:
            prop = zeros
        else:
            prop = _align(p, da, torch.cat([prev1, prev2], -1), torch.cat([prev1, cur, prev2], -1))
        parts = [cur] + ([extra[i]] if extra is not None else []) + [prop]
        y = leaky_relu(pconv2d(p, bb + ".0", torch.cat(parts, -1), padding=(1, 1)), 0.1)
        out = prop + pconv2d(p, bb + ".2", y, padding=(1, 1))
        prev2 = zeros if i == 0 else prev1
        prev1 = out
        outs.append(out)
    return torch.stack(outs)


def _decode(p, prop, e1):
    d2 = leaky_relu(pconv2d(p, "decoder2.0", prop, padding=(1, 1)), 0.2)
    d2 = leaky_relu(_deconv(p, "decoder2.2", d2), 0.2) + e1
    d1 = leaky_relu(pconv2d(p, "decoder1.0", d2, padding=(1, 1)), 0.2)
    d1 = leaky_relu(_deconv(p, "decoder1.2", d1), 0.2)
    up = leaky_relu(pconv2d(p, "upsample.0", d1, padding=(1, 1)), 0.2)
    return _deconv(p, "upsample.2", up)


def complete(p, flows, masks):
    """One direction: masked flows [T, H, W, 2] and masks [T, H, W, 1] ->
    completed flows [T, H, W, 2]."""
    t, h, w, _ = flows.shape
    x = torch.cat([flows, masks], -1)
    xp = F.pad(x.permute(0, 3, 1, 2), (2, 2, 2, 2), mode="replicate").permute(0, 2, 3, 1)[None]
    x = leaky_relu(pconv3d(p, "downsample.0", xp, stride=(1, 2, 2)), 0.2)
    e1 = leaky_relu(_p3d(p, "encoder1.0", x, 1), 0.2)
    e1 = leaky_relu(_p3d(p, "encoder1.2", e1, 2), 0.2)
    e2 = leaky_relu(_p3d(p, "encoder2.0", e1, 1), 0.2)
    e2 = leaky_relu(_p3d(p, "encoder2.2", e2, 2), 0.2)
    mid = leaky_relu(pconv3d(p, "mid_dilation.0", e2, padding=(0, 3, 3), dilation=(1, 3, 3)), 0.2)
    mid = leaky_relu(pconv3d(p, "mid_dilation.2", mid, padding=(0, 2, 2), dilation=(1, 2, 2)), 0.2)
    mid = leaky_relu(pconv3d(p, "mid_dilation.4", mid, padding=(0, 1, 1)), 0.2)[0]  # [T, h8, w8, C]
    xs = mid[:, None]
    bwd = _direction(p, "backward_", xs.flip(0), None).flip(0)
    fwd = _direction(p, "forward_", xs, bwd)
    fused = torch.cat([bwd, fwd], -1)[:, 0]
    prop = pconv2d(p, "feat_prop_module.fusion", fused) + mid
    e1 = e1[0]
    return torch.cat([_decode(p, prop[i : i + DECODE_FRAMES], e1[i : i + DECODE_FRAMES])
                      for i in range(0, t, DECODE_FRAMES)])


def complete_bidirectional(p, flows_f, flows_b, masks):
    """flows [T-1, H, W, 2] both ways, masks [T, H, W, 1] -> the completed
    flows, observed flow kept outside the mask. The backward flows are
    completed in reversed time."""
    mf, mb = masks[:-1], masks[1:]
    pf = complete(p, flows_f * (1 - mf), mf)
    pb = complete(p, (flows_b * (1 - mb)).flip(0), mb.flip(0)).flip(0)
    return pf * mf + flows_f * (1 - mf), pb * mb + flows_b * (1 - mb)
