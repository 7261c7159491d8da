"""Conv / linear / norm helpers on NHWC activations, upstream weights.

Weights are upstream-layout tensors (conv OIHW, conv3d OIDHW, linear
(out, in)) in a flat {state_dict_key: tensor} dict. Activations stay
NHWC like the JAX package; each conv views its input as NCHW with
channels-last strides, which cuDNN takes natively, so the permutes
around `F.conv2d` copy nothing on the card. `conv2d_gemm` computes a
stride-1 conv as matrix products over its taps instead (cuBLAS on the
card), on weights laid out once by `gemm_weight`.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

from ..utils import profiling

Params = Mapping[str, torch.Tensor]

# `conv2d_gemm` unfolds every tap into one product below this many input
# channels, and takes one product of every tap's weights below this many
# output channels: a product per tap would be a sliver of a matrix
FEW_CHANNELS = 8


def conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None = None,
    stride: tuple[int, int] = (1, 1),
    padding: tuple[int, int] = (0, 0),
    dilation: tuple[int, int] = (1, 1),
    groups: int = 1,
) -> torch.Tensor:
    """x: [N, H, W, Cin], w: [Cout, Cin/groups, kh, kw] -> [N, H', W', Cout]."""
    y = F.conv2d(
        x.permute(0, 3, 1, 2),
        w.to(x.dtype),
        None if b is None else b.to(x.dtype),
        stride=stride,
        padding=padding,
        dilation=dilation,
        groups=groups,
    )
    return y.permute(0, 2, 3, 1)


def conv3d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None = None,
    stride: tuple[int, int, int] = (1, 1, 1),
    padding: tuple[int, int, int] = (0, 0, 0),
    dilation: tuple[int, int, int] = (1, 1, 1),
) -> torch.Tensor:
    """x: [N, T, H, W, Cin], w: [Cout, Cin, kt, kh, kw]."""
    y = F.conv3d(
        x.permute(0, 4, 1, 2, 3),
        w.to(x.dtype),
        None if b is None else b.to(x.dtype),
        stride=stride,
        padding=padding,
        dilation=dilation,
    )
    return y.permute(0, 2, 3, 4, 1)


def pconv2d(p: Params, name: str, x: torch.Tensor, **kw) -> torch.Tensor:
    return conv2d(x, p[name + ".weight"], p.get(name + ".bias"), **kw)


def gemm_weight(w: torch.Tensor) -> torch.Tensor:
    """Conv weight [Cout, Cin, kh, kw] -> the tap-major [kh*kw, Cin, Cout]
    layout `conv2d_gemm` takes (tap t = i*kw + j)."""
    co, ci, kh, kw = w.shape
    return w.permute(2, 3, 1, 0).reshape(kh * kw, ci, co).contiguous()


def conv2d_gemm(
    x: torch.Tensor,
    wt: torch.Tensor,
    b: torch.Tensor | None,
    kernel: tuple[int, int],
    padding: tuple[int, int],
) -> torch.Tensor:
    """Stride-1, undilated, ungrouped conv as matrix products over its taps.
    x [N, H, W, Cin]; wt [kh*kw, Cin, Cout] (`gemm_weight`), b [Cout] or
    None, both in x's dtype -> [N, H', W', Cout] in x's dtype, with H' =
    H + 2*ph - kh + 1 (W' alike); often a strided view.

    x is zero-padded once and its padded rows flattened into one run of
    N*Hp*Wp pixels; output pixel (n, y, x) is row r = (n*Hp + y)*Wp + x
    of one output of the same rows (less the last taps' reach), and tap
    (i, j) adds input row r + i*Wp + j times its weight. So each tap is
    one 2D product whose A operand is a shifted view of the padded input
    (no copy a tap), added into the output in place; the bias is the
    first tap's C operand. The result is a strided view of the output's
    [:H', :W'] corner of each image; the rows between mix neighbouring
    pixels and are never read. A 1x1 conv is one product. Below
    FEW_CHANNELS input channels the taps are unfolded into one product
    over kh*kw*Cin columns; below FEW_CHANNELS output channels x takes
    one product with every tap's weights side by side, and the taps'
    outputs are added shifted. Differentiable. The products run in x's
    dtype under the caller's TF32 setting
    (`pipeline/stages.py::full_fp32` turns it off). Counted as
    `conv_gemm`, one a call (utils/profiling.py::kernel)."""
    kh, kw = kernel
    ph, pw = padding
    n, h, w, c = x.shape
    taps, _, co = wt.shape
    ho, wo = h + 2 * ph - kh + 1, w + 2 * pw - kw + 1
    with profiling.kernel("conv_gemm"):
        xp = F.pad(x, (0, 0, pw, pw, ph, ph)) if ph or pw else x
        if c < FEW_CHANNELS:
            cols = torch.cat([xp[:, i : i + ho, j : j + wo] for i in range(kh) for j in range(kw)], -1)
            cols, wcols = cols.reshape(-1, taps * c), wt.reshape(taps * c, co)
            y = torch.mm(cols, wcols) if b is None else torch.addmm(b, cols, wcols)
            return y.view(n, ho, wo, co)
        if co < FEW_CHANNELS:
            y = torch.mm(x.reshape(-1, c), wt.permute(1, 0, 2).reshape(c, taps * co))
            yp = F.pad(y.view(n, h, w, taps, co), (0, 0, 0, 0, pw, pw, ph, ph))
            out = x.new_zeros(n, ho, wo, co) if b is None else b.expand(n, ho, wo, co).clone()
            for t in range(taps):
                i, j = divmod(t, kw)
                out += yp[:, i : i + ho, j : j + wo, t]
            return out
        hp, wp = h + 2 * ph, w + 2 * pw
        flat = xp.reshape(n * hp * wp, c)
        m = n * hp * wp - (kh - 1) * wp - (kw - 1)
        out = torch.mm(flat[:m], wt[0]) if b is None else torch.addmm(b, flat[:m], wt[0])
        for t in range(1, taps):
            i, j = divmod(t, kw)
            out.addmm_(flat[i * wp + j : i * wp + j + m], wt[t])
        return out.as_strided((n, ho, wo, co), (hp * wp * co, wp * co, co, 1))


def pconv3d(p: Params, name: str, x: torch.Tensor, **kw) -> torch.Tensor:
    """conv3d; (1, k, k) kernels with no temporal padding run as batched
    2D convs (T folded into the batch)."""
    w = p[name + ".weight"]
    b = p.get(name + ".bias")
    stride = kw.get("stride", (1, 1, 1))
    padding = kw.get("padding", (0, 0, 0))
    dilation = kw.get("dilation", (1, 1, 1))
    if w.shape[2] == 1 and stride[0] == 1 and padding[0] == 0:
        n, t, h, ww, c = x.shape
        y = conv2d(
            x.reshape(n * t, h, ww, c),
            w[:, :, 0],
            b,
            stride=stride[1:],
            padding=padding[1:],
            dilation=dilation[1:],
        )
        return y.reshape(n, t, y.shape[1], y.shape[2], y.shape[3])
    return conv3d(x, w, b, stride=stride, padding=padding, dilation=dilation)


def linear(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    """x: [..., in]; weight stored as (out, in)."""
    b = p.get(name + ".bias")
    return F.linear(
        x, p[name + ".weight"].to(x.dtype), None if b is None else b.to(x.dtype)
    )


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.2) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)


def layer_norm(p: Params, name: str, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return F.layer_norm(
        x,
        (x.shape[-1],),
        p[name + ".weight"].to(x.dtype),
        p[name + ".bias"].to(x.dtype),
        eps,
    )


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d(affine=False): per-sample, per-channel over H, W."""
    mu = x.mean(dim=(-3, -2), keepdim=True)
    var = x.var(dim=(-3, -2), keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + eps)


def batch_norm_eval(p: Params, name: str, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """BatchNorm2d in eval mode: normalize with stored running stats."""
    rm = p[name + ".running_mean"].to(x.dtype)
    rv = p[name + ".running_var"].to(x.dtype)
    w = p[name + ".weight"].to(x.dtype)
    b = p[name + ".bias"].to(x.dtype)
    return (x - rm) * torch.rsqrt(rv + eps) * w + b
