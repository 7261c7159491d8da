"""RAFT (large, test mode), bidirectional, in plain PyTorch.

NHWC activations. The all-pairs correlation of a frame pair is one
matrix product; the backward direction's volume is its transpose. Each
iteration samples a 9x9 window per level of the 4-level pyramid,
bilinearly with zeros outside (grid_sample, align_corners=True), with
channels in RAFT's (level, dx, dy) order. Flows are float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .ops import (
    batch_norm_eval, coords_grid, instance_norm, matmul, pconv2d, unfold_nhwc,
)

LEVELS = 4
RADIUS = 4
HDIM = 128


def _residual_block(p, pre, x, stride, norm):
    def nrm(name, v):
        return instance_norm(v) if norm == "instance" else batch_norm_eval(p, name, v)

    y = torch.relu(nrm(pre + ".norm1", pconv2d(p, pre + ".conv1", x, stride=(stride, stride), padding=(1, 1))))
    y = torch.relu(nrm(pre + ".norm2", pconv2d(p, pre + ".conv2", y, padding=(1, 1))))
    if stride != 1:
        x = nrm(pre + ".norm3", pconv2d(p, pre + ".downsample.0", x, stride=(stride, stride)))
    return torch.relu(x + y)


def encoder(p, pre, x, norm):
    """BasicEncoder: [N, H, W, 3] -> [N, H/8, W/8, 256]."""
    x = pconv2d(p, pre + ".conv1", x, stride=(2, 2), padding=(3, 3))
    x = torch.relu(instance_norm(x) if norm == "instance" else batch_norm_eval(p, pre + ".norm1", x))
    for layer, stride in (("layer1", 1), ("layer2", 2), ("layer3", 2)):
        x = _residual_block(p, f"{pre}.{layer}.0", x, stride, norm)
        x = _residual_block(p, f"{pre}.{layer}.1", x, 1, norm)
    return pconv2d(p, pre + ".conv2", x)


def pyramid(corr):
    """[M, 1, H, W] -> 4 levels of 2x2 average pools."""
    levels = [corr]
    for _ in range(LEVELS - 1):
        levels.append(F.avg_pool2d(levels[-1], 2, stride=2))
    return levels


def lookup(levels, coords):
    """coords [M, 2] (x, y) at 1/8 -> [M, 324]: per level the 9x9 window
    around coords / 2^l, output (a, b) sampled at x + a - 4, y + b - 4."""
    d = torch.arange(-RADIUS, RADIUS + 1, dtype=torch.float32, device=coords.device)
    da, db = torch.meshgrid(d, d, indexing="ij")
    out = []
    for lvl, corr in enumerate(levels):
        h, w = corr.shape[-2:]
        if w == 1 or h == 1:  # grid_sample's normalisation would divide by zero
            raise ValueError("RAFT reference: a pyramid level is one pixel wide")
        c = coords / 2**lvl
        px = c[:, 0, None, None] + da  # [M, 9, 9]
        py = c[:, 1, None, None] + db
        grid = torch.stack([2 * px / (w - 1) - 1, 2 * py / (h - 1) - 1], dim=-1)
        out.append(F.grid_sample(corr, grid, mode="bilinear", padding_mode="zeros", align_corners=True).reshape(-1, 81))
    return torch.cat(out, dim=1)


def _update(p, net, inp, corr, flow):
    pre = "update_block.encoder"
    cor = torch.relu(pconv2d(p, pre + ".convc1", corr))
    cor = torch.relu(pconv2d(p, pre + ".convc2", cor, padding=(1, 1)))
    flo = torch.relu(pconv2d(p, pre + ".convf1", flow, padding=(3, 3)))
    flo = torch.relu(pconv2d(p, pre + ".convf2", flo, padding=(1, 1)))
    motion = torch.cat([torch.relu(pconv2d(p, pre + ".conv", torch.cat([cor, flo], -1), padding=(1, 1))), flow], -1)
    x = torch.cat([inp, motion], -1)
    g = "update_block.gru"
    for tag, pad in (("1", (0, 2)), ("2", (2, 0))):
        hx = torch.cat([net, x], -1)
        z = torch.sigmoid(pconv2d(p, f"{g}.convz{tag}", hx, padding=pad))
        r = torch.sigmoid(pconv2d(p, f"{g}.convr{tag}", hx, padding=pad))
        q = torch.tanh(pconv2d(p, f"{g}.convq{tag}", torch.cat([r * net, x], -1), padding=pad))
        net = (1 - z) * net + z * q
    fh = torch.relu(pconv2d(p, "update_block.flow_head.conv1", net, padding=(1, 1)))
    return net, pconv2d(p, "update_block.flow_head.conv2", fh, padding=(1, 1))


def convex_upsample(p, net, flow):
    """RAFT's convex 8x upsampling with the mask head on the last state."""
    n, h, w, _ = flow.shape
    m = 0.25 * pconv2d(p, "update_block.mask.2", torch.relu(pconv2d(p, "update_block.mask.0", net, padding=(1, 1))))
    m = torch.softmax(m.reshape(n, h, w, 9, 8, 8), dim=3)
    patches = unfold_nhwc(8.0 * flow, 3, 1, 1).reshape(n, h, w, 2, 9)  # (C, k) order
    up = torch.einsum("nhwkab,nhwck->nhwabc", m, patches)
    return up.permute(0, 1, 3, 2, 4, 5).reshape(n, 8 * h, 8 * w, 2)


def raft_pair(p, fm, cn, iters):
    """Flows (frame 0 -> frame 1, frame 1 -> frame 0) [2, H, W, 2] of one
    frame pair from its fnet and cnet features fm, cn [2, H/8, W/8, 256]."""
    _, h8, w8, c = fm.shape
    f1, f2 = fm[0].reshape(h8 * w8, c), fm[1].reshape(h8 * w8, c)
    corr = matmul(f1, f2.t()) / math.sqrt(c)
    fwd = pyramid(corr.reshape(h8 * w8, 1, h8, w8))
    bwd = pyramid(corr.t().contiguous().reshape(h8 * w8, 1, h8, w8))
    del corr
    net, inp = torch.tanh(cn[..., :HDIM]), torch.relu(cn[..., HDIM:])
    coords0 = coords_grid(2, h8, w8, fm.device)
    coords1 = coords0.clone()
    for _ in range(iters):
        flat = coords1.reshape(2, h8 * w8, 2)
        corr_f = torch.cat([lookup(fwd, flat[0]), lookup(bwd, flat[1])]).reshape(2, h8, w8, 4 * 81)
        net, delta = _update(p, net, inp, corr_f, coords1 - coords0)
        coords1 = coords1 + delta
    return convex_upsample(p, net, coords1 - coords0)


def raft_bidirectional(p, frames, iters, frames_a_call=6):
    """frames [T, H, W, 3] in [-1, 1] -> (forward, backward) [T-1, H, W, 2]:
    both encoders once a frame (in calls of `frames_a_call` frames), then
    the update loop one pair at a time."""
    fm = torch.cat([encoder(p, "fnet", frames[i : i + frames_a_call], "instance")
                    for i in range(0, frames.shape[0], frames_a_call)])
    cn = torch.cat([encoder(p, "cnet", frames[i : i + frames_a_call], "batch")
                    for i in range(0, frames.shape[0], frames_a_call)])
    flows = [raft_pair(p, fm[i : i + 2], cn[i : i + 2], iters) for i in range(frames.shape[0] - 1)]
    return torch.stack([f[0] for f in flows]), torch.stack([f[1] for f in flows])
