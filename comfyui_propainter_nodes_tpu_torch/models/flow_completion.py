"""Recurrent flow completion network.

Port of the JAX package's `models/flow_completion.py` (main path): the
P3D encoder and mid dilation as NDHWC convs, the second-order
bidirectional propagation as a Python loop over frames with a
(prev1, prev2) carry, both temporal directions of
`forward_bidirect_flow` batched into one network call, and the
second-order deformable alignment on the deform-conv kernel
(ops/cuda/deform_conv.py).

The decoder's full-res activations are the network's largest (32
channels a pixel for every frame): it decodes as many frames a call as
keep one of them within `DECODE_BYTES`: in bf16 one call for a node's
24 frames at 1280x720, three for a streaming chunk of 90 pairs there.
The decoder is per-frame pure, so the computation is the same; the
values agree within fp32 rounding (a conv may take another algorithm
for another batch size). Decoded at once, a 90-pair chunk at 1280x720
asks for more than 60 GB.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

from ..ops.conv import leaky_relu, pconv2d, pconv3d
from ..ops.cuda.deform_conv import deform_conv2d
from ..ops.resize import resize_bilinear

Params = Mapping[str, torch.Tensor]

CHANNEL = 128
DEFORM_GROUPS = 16
# the largest full-res decoder activation of one decoder call, in bytes
DECODE_BYTES = 4 << 30


def _p3d(p: Params, pre: str, x, stride: int):
    """P3DBlock: (1,3,3) spatial conv + LeakyReLU, then a (3,1,1)
    dilated-2 temporal conv."""
    y = pconv3d(p, pre + ".conv1.0", x, stride=(1, stride, stride), padding=(0, 1, 1))
    y = leaky_relu(y, 0.2)
    return pconv3d(p, pre + ".conv2.0", y, padding=(2, 0, 0), dilation=(2, 1, 1))


def _deconv(p: Params, pre: str, x):
    """2x bilinear (align_corners=True) + 3x3 conv."""
    n, h, w, c = x.shape
    x = resize_bilinear(x, 2 * h, 2 * w, align_corners=True)
    return pconv2d(p, pre + ".conv", x, padding=(1, 1))


def _second_order_align(p: Params, pre: str, x, extra_feat):
    """SecondOrderDeformableAlignment: x [N,H,W,2C], extra_feat [N,H,W,3C]."""
    n, h, w, _ = x.shape
    o = leaky_relu(pconv2d(p, pre + ".conv_offset.0", extra_feat, padding=(1, 1)), 0.1)
    o = leaky_relu(pconv2d(p, pre + ".conv_offset.2", o, padding=(1, 1)), 0.1)
    o = leaky_relu(pconv2d(p, pre + ".conv_offset.4", o, padding=(1, 1)), 0.1)
    o = pconv2d(p, pre + ".conv_offset.6", o, padding=(1, 1))  # 27*G

    g9 = DEFORM_GROUPS * 9
    o1, o2, mask = o[..., :g9], o[..., g9 : 2 * g9], o[..., 2 * g9 :]
    offset = 5.0 * torch.tanh(torch.cat([o1, o2], dim=-1))
    # torchvision channel layout: (dy, dx) pairs per (group, tap)
    offset = offset.reshape(n, h, w, DEFORM_GROUPS, 9, 2)
    mask = torch.sigmoid(mask).reshape(n, h, w, DEFORM_GROUPS, 9)
    return deform_conv2d(
        x.contiguous(), offset.contiguous(), mask.contiguous(),
        p[pre + ".weight"], p[pre + ".bias"], padding=1,
    )


def _propagate_direction(p: Params, module: str, x_seq, extra_seq):
    """One direction of the second-order propagation. x_seq [T, N, H, W, C]
    in propagation order; extra_seq (forward pass) the other direction's
    features."""
    t, n, h, w, c = x_seq.shape
    da = f"feat_prop_module.deform_align.{module}"
    bb = f"feat_prop_module.backbone.{module}"
    zeros = x_seq.new_zeros((n, h, w, c))
    prev1, prev2 = zeros, zeros
    outs = []
    for i in range(t):
        feat_current = x_seq[i]
        if i == 0:
            # the reference skips alignment on the first frame
            feat_prop = zeros
        else:
            cond = torch.cat([prev1, feat_current, prev2], dim=-1)
            feat_prop = _second_order_align(p, da, torch.cat([prev1, prev2], dim=-1), cond)
        parts = [feat_current] + ([extra_seq[i]] if extra_seq is not None else []) + [feat_prop]
        y = leaky_relu(pconv2d(p, bb + ".0", torch.cat(parts, dim=-1), padding=(1, 1)), 0.1)
        out = feat_prop + pconv2d(p, bb + ".2", y, padding=(1, 1))
        prev2 = zeros if i == 0 else prev1
        prev1 = out
        outs.append(out)
    return torch.stack(outs)


def _bidirectional_propagation(p: Params, x):
    """x: [N, T, H, W, C] -> [N, T, H, W, C]."""
    x_t = x.movedim(1, 0)
    bwd = _propagate_direction(p, "backward_", x_t.flip(0), None).flip(0)
    fwd = _propagate_direction(p, "forward_", x_t, bwd)
    fused = torch.cat([bwd, fwd], dim=-1)
    t, n, h, w, c2 = fused.shape
    out = pconv2d(p, "feat_prop_module.fusion", fused.reshape(t * n, h, w, c2))
    return out.reshape(t, n, h, w, c2 // 2).movedim(0, 1) + x


def _encode(p: Params, inputs):
    """[B,T,H,W,3] -> (e1 [B,T,H/4,W/4,64], e2 [B,T,H/8,W/8,128]); the
    (1,5,5) stride-2 downsample conv uses replicate spatial padding."""
    b, t, h, w, c = inputs.shape
    xp = F.pad(inputs.reshape(b * t, h, w, c).permute(0, 3, 1, 2), (2, 2, 2, 2), mode="replicate")
    xp = xp.permute(0, 2, 3, 1).reshape(b, t, h + 4, w + 4, c)
    x = leaky_relu(pconv3d(p, "downsample.0", xp, stride=(1, 2, 2)), 0.2)
    e1 = leaky_relu(_p3d(p, "encoder1.0", x, 1), 0.2)
    e1 = leaky_relu(_p3d(p, "encoder1.2", e1, 2), 0.2)
    e2 = leaky_relu(_p3d(p, "encoder2.0", e1, 1), 0.2)
    e2 = leaky_relu(_p3d(p, "encoder2.2", e2, 2), 0.2)
    return e1, e2


def _mid(p: Params, e2):
    """Three dilated spatial convs at 1/8 res."""
    mid = leaky_relu(pconv3d(p, "mid_dilation.0", e2, padding=(0, 3, 3), dilation=(1, 3, 3)), 0.2)
    mid = leaky_relu(pconv3d(p, "mid_dilation.2", mid, padding=(0, 2, 2), dilation=(1, 2, 2)), 0.2)
    return leaky_relu(pconv3d(p, "mid_dilation.4", mid, padding=(0, 1, 1)), 0.2)


def _decode(p: Params, prop2, e1_2):
    """prop2 [BT, H/8, W/8, 128], e1_2 [BT, H/4, W/4, 64] -> [BT, H, W, 2]."""
    d2 = leaky_relu(pconv2d(p, "decoder2.0", prop2, padding=(1, 1)), 0.2)
    d2 = leaky_relu(_deconv(p, "decoder2.2", d2), 0.2)
    d2 = d2 + e1_2
    d1 = leaky_relu(pconv2d(p, "decoder1.0", d2, padding=(1, 1)), 0.2)
    d1 = leaky_relu(_deconv(p, "decoder1.2", d1), 0.2)
    up = leaky_relu(pconv2d(p, "upsample.0", d1, padding=(1, 1)), 0.2)
    return _deconv(p, "upsample.2", up)


def flow_complete_forward(p: Params, masked_flows, masks):
    """masked_flows [B,T,H,W,2], masks [B,T,H,W,1] -> completed [B,T,H,W,2]."""
    b, t, h, w, _ = masked_flows.shape
    inputs = torch.cat([masked_flows, masks], dim=-1)
    e1, e2 = _encode(p, inputs)
    prop = _bidirectional_propagation(p, _mid(p, e2)).reshape(b * t, h // 8, w // 8, CHANNEL)
    e1 = e1.reshape(b * t, h // 4, w // 4, 64)
    chunk = max(1, DECODE_BYTES // (h * w * 32 * prop.element_size()))
    flow = [_decode(p, prop[i : i + chunk], e1[i : i + chunk]) for i in range(0, b * t, chunk)]
    return (flow[0] if len(flow) == 1 else torch.cat(flow)).reshape(b, t, h, w, 2)


def forward_bidirect_flow(p: Params, flows_f, flows_b, masks):
    """Complete both directions in one batched call; the backward stream
    runs time-flipped. flows_* [B, T-1, H, W, 2]; masks [B, T, H, W, 1]."""
    masks_fwd = masks[:, :-1]
    masks_bwd = masks[:, 1:]
    mf = flows_f * (1 - masks_fwd)
    mb = flows_b * (1 - masks_bwd)
    pred = flow_complete_forward(
        p,
        torch.cat([mf, mb.flip(1)], dim=0),
        torch.cat([masks_fwd, masks_bwd.flip(1)], dim=0),
    )
    b = flows_f.shape[0]
    return pred[:b], pred[b:].flip(1)


def combine_flow(flows_f, flows_b, pred_f, pred_b, masks):
    """Keep observed flow outside the mask."""
    masks_fwd = masks[:, :-1]
    masks_bwd = masks[:, 1:]
    out_f = pred_f * masks_fwd + flows_f * (1 - masks_fwd)
    out_b = pred_b * masks_bwd + flows_b * (1 - masks_bwd)
    return out_f, out_b
