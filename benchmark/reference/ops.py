"""Plain ops on NHWC activations with upstream-layout weights.

Weights: conv OIHW, conv3d OIDHW, linear (out, in), in a flat
{state_dict_key: tensor} dict. Every conv, linear and matrix product
passes its operands through `operand`, which is the identity unless
`operand_precision("fp8")` is in force; then the products' results
are rounded the same way, so every conv, linear and matrix product
reads and stores float8 e4m3, as the program's bf16 path reads and
stores bf16.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

_FP8_MAX = 448.0  # largest finite float8 e4m3 value
_PRECISION = "fp32"


@contextlib.contextmanager
def operand_precision(name: str):
    """"fp32" (the reference) or "fp8" (the control) inside the block: in
    fp8 the operands and results of every product are rounded to float8
    e4m3 with a per-tensor scale, the accumulation in float32."""
    global _PRECISION
    if name not in ("fp32", "fp8"):
        raise ValueError(f"unknown operand precision {name!r}")
    old, _PRECISION = _PRECISION, name
    try:
        yield
    finally:
        _PRECISION = old


def operand(x: torch.Tensor) -> torch.Tensor:
    """x as a product reads or stores it: unchanged in fp32; in fp8 scaled
    so its largest magnitude maps to 448, rounded to e4m3, scaled back."""
    if _PRECISION == "fp32":
        return x
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / _FP8_MAX, torch.ones_like(amax))
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return operand(torch.matmul(operand(a), operand(b)))


def conv2d(x, w, b=None, stride=(1, 1), padding=(0, 0), dilation=(1, 1), groups=1):
    """x [N, H, W, Cin], w [Cout, Cin/groups, kh, kw] -> [N, H', W', Cout];
    computed on a contiguous NCHW copy."""
    y = F.conv2d(operand(x.permute(0, 3, 1, 2).contiguous()), operand(w), b,
                 stride=stride, padding=padding, dilation=dilation, groups=groups)
    return operand(y).permute(0, 2, 3, 1)


def conv3d(x, w, b=None, stride=(1, 1, 1), padding=(0, 0, 0), dilation=(1, 1, 1)):
    """x [N, T, H, W, Cin], w [Cout, Cin, kt, kh, kw]."""
    y = F.conv3d(operand(x.permute(0, 4, 1, 2, 3).contiguous()), operand(w), b,
                 stride=stride, padding=padding, dilation=dilation)
    return operand(y).permute(0, 2, 3, 4, 1)


def pconv2d(p, name, x, **kw):
    return conv2d(x, p[name + ".weight"], p.get(name + ".bias"), **kw)


def pconv3d(p, name, x, **kw):
    return conv3d(x, p[name + ".weight"], p.get(name + ".bias"), **kw)


def linear(p, name, x):
    b = p.get(name + ".bias")
    y = torch.matmul(operand(x), operand(p[name + ".weight"].t()))
    return operand(y if b is None else y + b)


def leaky_relu(x, slope=0.2):
    return F.leaky_relu(x, slope)


def layer_norm(p, name, x, eps=1e-5):
    return F.layer_norm(x, (x.shape[-1],), p[name + ".weight"], p[name + ".bias"], eps)


def instance_norm(x, eps=1e-5):
    """InstanceNorm2d without affine, over H and W of [N, H, W, C]."""
    mu = x.mean(dim=(1, 2), keepdim=True)
    var = x.var(dim=(1, 2), keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + eps)


def batch_norm_eval(p, name, x, eps=1e-5):
    rm, rv = p[name + ".running_mean"], p[name + ".running_var"]
    return (x - rm) * torch.rsqrt(rv + eps) * p[name + ".weight"] + p[name + ".bias"]


# ------------------------------------------------------------- sampling


def _gather(img, iy, ix):
    """img [N, H, W, C] at integer (iy, ix) [N, P] (clamped) -> [N, P, C]."""
    n, h, w, c = img.shape
    idx = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).long()
    return torch.gather(img.reshape(n, h * w, c), 1, idx[..., None].expand(-1, -1, c))


def grid_sample(img, coords, mode="bilinear"):
    """img [N, H, W, C] at pixel coords [N, P, 2] (x, y), zero outside."""
    n, h, w, c = img.shape
    x, y = coords[..., 0], coords[..., 1]

    def inside(iy, ix):
        return ((ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)).to(img.dtype)

    if mode == "nearest":
        ix, iy = torch.round(x).long(), torch.round(y).long()
        return _gather(img, iy, ix) * inside(iy, ix)[..., None]
    x0, y0 = torch.floor(x), torch.floor(y)
    wx1, wy1 = x - x0, y - y0
    ix0, iy0 = x0.long(), y0.long()
    out = 0
    for dy, wy in ((0, 1 - wy1), (1, wy1)):
        for dx, wx in ((0, 1 - wx1), (1, wx1)):
            iy, ix = iy0 + dy, ix0 + dx
            out = out + _gather(img, iy, ix) * (wy * wx * inside(iy, ix))[..., None]
    return out


def coords_grid(batch, h, w, device=None):
    """[N, H, W, 2] pixel grid, last axis (x, y)."""
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    return torch.stack([gx, gy], dim=-1)[None].expand(batch, h, w, 2)


def flow_warp(x, flow, mode="bilinear"):
    """Backward warp of x [N, H, W, C] by flow [N, H, W, 2] (dx, dy)."""
    n, h, w, _ = flow.shape
    coords = (coords_grid(1, h, w, flow.device) + flow).reshape(n, h * w, 2)
    return grid_sample(x, coords, mode).reshape(n, h, w, x.shape[-1])


# --------------------------------------------------------------- resizes


def _linear_taps(n_in, n_out, align_corners, device):
    o = torch.arange(n_out, dtype=torch.float64, device=device)
    if align_corners and n_out > 1:
        src = o * (n_in - 1) / (n_out - 1)
    else:
        src = torch.clamp((o + 0.5) * (n_in / n_out) - 0.5, min=0.0)
    i0 = torch.clamp(torch.floor(src).long(), 0, n_in - 1)
    i1 = torch.clamp(i0 + 1, max=n_in - 1)
    return i0, i1, (src - i0).float()


def resize_bilinear(x, out_h, out_w, align_corners=False):
    """torch bilinear interpolation of [..., H, W, C], one axis at a time."""
    h, w = x.shape[-3], x.shape[-2]
    if (h, w) == (out_h, out_w):
        return x
    for axis, n_in, n_out in ((x.ndim - 3, h, out_h), (x.ndim - 2, w, out_w)):
        i0, i1, w1 = _linear_taps(n_in, n_out, align_corners, x.device)
        shape = [1] * x.ndim
        shape[axis] = n_out
        v0, v1 = x.index_select(axis, i0), x.index_select(axis, i1)
        x = v0 + (v1 - v0) * w1.reshape(shape).to(x.dtype)
    return x


def resize_nearest(x, out_h, out_w):
    """torch 'nearest': source index floor(i * in / out)."""
    h, w = x.shape[-3], x.shape[-2]
    iy = torch.clamp(torch.floor(torch.arange(out_h, dtype=torch.float64) * (h / out_h)).long(), max=h - 1)
    ix = torch.clamp(torch.floor(torch.arange(out_w, dtype=torch.float64) * (w / out_w)).long(), max=w - 1)
    return x.index_select(x.ndim - 3, iy.to(x.device)).index_select(x.ndim - 2, ix.to(x.device))


# ------------------------------------------------------------ morphology


def binary_dilation(mask, iterations):
    """scipy's binary_dilation with the 4-connected cross, `iterations`
    times, on a {0, 1} mask [..., H, W]."""
    m = (mask > 0).float()
    for _ in range(iterations):
        p = F.pad(m, (1, 1, 1, 1))
        m = torch.maximum(torch.maximum(p[..., 1:-1, 1:-1], torch.maximum(p[..., :-2, 1:-1], p[..., 2:, 1:-1])),
                          torch.maximum(p[..., 1:-1, :-2], p[..., 1:-1, 2:]))
    return m


def binarize(x, threshold=0.1):
    return (x > threshold).to(x.dtype)


def max_pool2d(x, kernel, stride, padding=(0, 0)):
    """MaxPool2d on [N, H, W, C]."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), kernel, stride, padding).permute(0, 2, 3, 1)


# -------------------------------------------------------- deformable conv


def deform_conv2d(x, offset, mask, weight, bias, padding=1):
    """Modulated deformable 3x3 conv (DCNv2, torchvision's semantics).
    x [N, H, W, Cin]; offset [N, H, W, G, 9, 2] as (dy, dx); mask
    [N, H, W, G, 9]; weight [Cout, Cin, 3, 3] -> [N, H, W, Cout]. Each
    sample is bilinear with zeros outside the image."""
    n, h, w, cin = x.shape
    g = offset.shape[3]
    cg = cin // g
    cout = weight.shape[0]
    dev = x.device
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
    ky, kx = torch.meshgrid(torch.arange(3, dtype=torch.float32, device=dev) - padding,
                            torch.arange(3, dtype=torch.float32, device=dev) - padding, indexing="ij")
    sy = gy[None, :, :, None, None] + ky.reshape(1, 1, 1, 1, 9) + offset[..., 0]  # [N, H, W, G, 9]
    sx = gx[None, :, :, None, None] + kx.reshape(1, 1, 1, 1, 9) + offset[..., 1]
    xg = x.reshape(n, h * w, g, cg)
    y0, x0 = torch.floor(sy), torch.floor(sx)
    samp = 0
    for dy, wy in ((0, 1 - (sy - y0)), (1, sy - y0)):
        for dx, wx in ((0, 1 - (sx - x0)), (1, sx - x0)):
            iy, ix = y0 + dy, x0 + dx
            ok = ((iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)).float()
            idx = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).long()  # [N, H, W, G, 9]
            idx = idx.permute(0, 1, 2, 4, 3).reshape(n, h * w * 9, g)  # (pixel, tap, group)
            v = torch.gather(xg, 1, idx[..., None].expand(-1, -1, -1, cg))  # [N, HW9, G, cg]
            wgt = (wy * wx * ok).permute(0, 1, 2, 4, 3).reshape(n, h * w * 9, g)
            samp = samp + v * wgt[..., None]
    samp = samp * mask.permute(0, 1, 2, 4, 3).reshape(n, h * w * 9, g)[..., None]
    cols = samp.reshape(n * h * w, 9 * cin)  # (tap, channel)
    wmat = weight.permute(2, 3, 1, 0).reshape(9 * cin, cout)
    out = torch.matmul(operand(cols), operand(wmat)).reshape(n, h, w, cout)
    return operand(out + bias)


def unfold_nhwc(x, k, stride, pad):
    """[N, H, W, C] -> [N, L, C*k*k] in torch's (C, kh, kw) order."""
    cols = F.unfold(x.permute(0, 3, 1, 2), k, padding=pad, stride=stride)
    return cols.transpose(1, 2)


def fold_nhwc(cols, out_hw, k, stride, pad):
    """Adjoint of `unfold_nhwc`: [N, L, C*k*k] -> [N, H, W, C]."""
    return F.fold(cols.transpose(1, 2), out_hw, k, padding=pad, stride=stride).permute(0, 2, 3, 1)


def scaled_softmax_attention(q, k, v, bias=None):
    """softmax(q k^T / sqrt(ch) + bias) v over the last two axes."""
    att = matmul(q, k.transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    if bias is not None:
        att = att + bias
    return matmul(torch.softmax(att, dim=-1), v)
