"""Conv / linear / norm helpers on NHWC activations, upstream weights.

Weights are upstream-layout tensors (conv OIHW, conv3d OIDHW, linear
(out, in)) in a flat {state_dict_key: tensor} dict. Activations stay
NHWC like the JAX package; each conv views its input as NCHW with
channels-last strides, which cuDNN takes natively, so the permutes
around `F.conv2d` copy nothing on the card.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

Params = Mapping[str, torch.Tensor]


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
