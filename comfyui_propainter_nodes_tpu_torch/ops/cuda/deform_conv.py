"""Modulated deformable conv (DCNv2): CUDA kernels (csrc/deform_conv.cu) + plain version.

Shapes (the JAX package's layout, `ops/deform_conv.py:184-188` there):
  x      [N, H, W, Cin]
  offset [N, Ho, W, G, K, 2] (dy, dx) per offset group per tap, K = 9
  mask   [N, Ho, W, G, K]    modulation scalars (already sigmoided)
  weight [Cout, Cin, 3, 3]   upstream OIHW; bias [Cout] or None
Returns [N, Ho, W, Cout] in x's dtype. Stride 1, dilation 1, padding 1.
Output row y sits at input row row0 + y of x (`row0`, default 0): a row
slab of the output over the whole input, as the spatial H split
(parallel/spatial.py) runs it; Ho = H and row0 = 0 is the whole image.
CPU tensors take the plain version. CUDA tensors take a kernel by dtype:
bf16 the tensor-core kernel (samples rounded to bf16 before the product,
as the JAX package's XLA path rounds them, fp32 accumulation), fp32 the
CUDA-core kernel (exact); any other dtype raises. Under grad mode, with
x, offset, mask, weight or bias requiring grad, the fp32 kernel runs
inside `_grad.TwinGrad`: the backward is the plain version's (bf16
raises there).
"""

from __future__ import annotations

import collections
import weakref

import torch

from . import _build
from ._grad import twin_grad, wants_grad

KC = 64  # channels of the tensor-core kernel's K chunk (csrc/deform_conv.cu, tc::KC)
BN = 128  # output channels of its block (tc::BN)
launches = 0  # kernel launches since the last reset
# launches by x's shape (and, for a row slab, its rows), reset with `launches`
launch_shapes: collections.Counter = collections.Counter()

# the weights laid out for the kernels, once per weight tensor:
# (id, dtype) -> (weakref to the weight, its version, the laid-out copy)
_LAYOUTS: dict = {}


def deform_conv2d_plain(x, offset, mask, weight, bias=None, padding: int = 1, row0: int = 0):
    """Port of the JAX package's `deform_conv2d_xla` for output rows
    [row0, row0 + Ho), computed in fp32 (in float64 for float64 x: the JAX
    function computes in x's dtype)."""
    n, h, w, cin = x.shape
    ho = offset.shape[1]
    cout, _, kh, kw = weight.shape
    k = kh * kw
    g = offset.shape[3]
    cg = cin // g
    dev = x.device
    ft = torch.float64 if x.dtype == torch.float64 else torch.float32
    xf = x.to(ft)
    gy, gx = torch.meshgrid(
        torch.arange(row0, row0 + ho, dtype=ft, device=dev),
        torch.arange(w, dtype=ft, device=dev),
        indexing="ij",
    )
    ky, kx = torch.meshgrid(
        torch.arange(kh, dtype=ft, device=dev) - padding,
        torch.arange(kw, dtype=ft, device=dev) - padding,
        indexing="ij",
    )
    base_y = gy[:, :, None] + ky.reshape(-1)  # [Ho, W, K]
    base_x = gx[:, :, None] + kx.reshape(-1)
    # [N, Ho, W, K, G]: flattening gives (pixel, K, G) like the weight layout
    sy = (base_y[None, :, :, None, :] + offset[..., 0].to(ft)).transpose(3, 4)
    sx = (base_x[None, :, :, None, :] + offset[..., 1].to(ft)).transpose(3, 4)
    xg = xf.reshape(n, h * w, g, cg)

    def tap(iy, ix, wgt):
        valid = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        iyc = iy.clamp(0, h - 1).long()
        ixc = ix.clamp(0, w - 1).long()
        idx = (iyc * w + ixc).reshape(n, ho * w * k, g)
        v = torch.gather(xg, 1, idx[..., None].expand(-1, -1, -1, cg))  # [N, HoW*K, G, Cg]
        wv = (wgt * valid.to(ft)).reshape(n, ho * w * k, g)
        return v * wv[..., None]

    y0, x0 = torch.floor(sy), torch.floor(sx)
    wy1, wx1 = sy - y0, sx - x0
    wy0, wx0 = 1.0 - wy1, 1.0 - wx1
    samp = (
        tap(y0, x0, wy0 * wx0)
        + tap(y0, x0 + 1, wy0 * wx1)
        + tap(y0 + 1, x0, wy1 * wx0)
        + tap(y0 + 1, x0 + 1, wy1 * wx1)
    )
    samp = samp * mask.to(ft).transpose(3, 4).reshape(n, ho * w * k, g)[..., None]
    samp = samp.reshape(n * ho * w, k * cin)
    wmat = weight.to(ft).permute(2, 3, 1, 0).reshape(k * cin, cout)
    out = torch.matmul(samp, wmat).reshape(n, ho, w, cout)
    if bias is not None:
        out = out + bias.to(ft)
    return out.to(x.dtype)


def weight_layout(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[Cout, Cin, 3, 3] -> the kernel's layout: fp32 [9*Cin, Cout] (tap
    outer, channel inner); bf16 [Np, 9, Kp], K contiguous per output
    channel, Cout padded to a multiple of BN and Cin to one of KC with
    zeros."""
    cout, cin = weight.shape[:2]
    if dtype == torch.float32:
        return weight.float().permute(2, 3, 1, 0).reshape(9 * cin, cout).contiguous()
    np_, kp = -(-cout // BN) * BN, -(-cin // KC) * KC
    out = weight.new_zeros((np_, 9, kp), dtype=torch.bfloat16)
    out[:cout, :, :cin] = weight.permute(0, 2, 3, 1).reshape(cout, 9, cin)
    return out


def _cached_layout(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """weight_layout, computed once per weight tensor (and again only if
    the tensor is written in place)."""
    key = (id(weight), dtype)
    hit = _LAYOUTS.get(key)
    if hit is not None and hit[0]() is weight and hit[1] == weight._version:
        return hit[2]
    laid = weight_layout(weight, dtype)
    _LAYOUTS[key] = (weakref.ref(weight, lambda _, key=key: _LAYOUTS.pop(key, None)), weight._version, laid)
    return laid


def block_rows(m: int, cout: int, device) -> int:
    """Pixels a block of the tensor-core kernel: 64, unless 64-pixel
    blocks would not give every SM two blocks; then 32."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return 64 if -(-m // 64) * -(-cout // BN) >= 2 * sms else 32


def _check(x, offset, mask, weight, bias, padding, row0):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"deform_conv2d: x must be fp32 or bf16, got {x.dtype}")
    n, h, w, cin = x.shape
    cout = weight.shape[0]
    if weight.shape != (cout, cin, 3, 3) or padding != 1:
        raise ValueError(f"deform_conv2d kernel takes 3x3 weights [Cout, {cin}, 3, 3], padding 1; got {tuple(weight.shape)}, {padding}")
    if offset.dim() != 6 or offset.shape[0] != n or offset.shape[2] != w or offset.shape[4:] != (9, 2):
        raise ValueError(f"offset must be [N, Ho, W, G, 9, 2], got {tuple(offset.shape)}")
    ho, g = offset.shape[1], offset.shape[3]
    if not 0 <= row0 <= h - ho:
        raise ValueError(f"deform_conv2d: output rows [{row0}, {row0 + ho}) must lie within x's {h} rows")
    if cin % g or mask.shape != (n, ho, w, g, 9):
        raise ValueError(f"mask must be [N, Ho, W, {g}, 9] with Cin % G == 0, got {tuple(mask.shape)}")
    for name, t in (("x", x), ("offset", offset), ("mask", mask)):
        if t.dtype != x.dtype or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"deform_conv2d: {name} must be contiguous {x.dtype} on {x.device}")
    if weight.device != x.device or (bias is not None and (bias.device != x.device or bias.shape != (cout,))):
        raise ValueError("deform_conv2d: weight/bias must be on x's device, bias [Cout]")
    if h * w * cin >= 2**31:
        raise ValueError(f"deform_conv2d: one image of x must hold < 2^31 elements, got {h * w * cin}")


def deform_conv2d(x, offset, mask, weight, bias=None, padding: int = 1, row0: int = 0):
    if x.device.type == "cpu":
        return deform_conv2d_plain(x, offset, mask, weight, bias, padding, row0)
    if x.device.type != "cuda":
        raise ValueError(f"deform_conv2d: unsupported device {x.device}")
    inputs = (x, offset, mask, weight, bias)
    if wants_grad(*inputs):
        return twin_grad("deform_conv2d", _launch, deform_conv2d_plain, 5, inputs, padding=padding, row0=row0)
    return _launch(*inputs, padding=padding, row0=row0)


def _launch(x, offset, mask, weight, bias=None, padding: int = 1, row0: int = 0):
    global launches
    _check(x, offset, mask, weight, bias, padding, row0)
    n, h, w, cin = x.shape
    ho = offset.shape[1]
    cout = weight.shape[0]
    g = offset.shape[3]
    wmat = _cached_layout(weight, x.dtype)
    out = torch.empty((n, ho, w, cout), device=x.device, dtype=x.dtype)
    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if x.dtype == torch.bfloat16:
        b = None if bias is None else bias.to(torch.bfloat16).contiguous()  # the JAX path adds bias.astype(dt)
        vec = (cin // g) % 8 == 0 and x.data_ptr() % 16 == 0
        status = lib.propainter_deform_conv_mma(
            x.data_ptr(), offset.data_ptr(), mask.data_ptr(), wmat.data_ptr(),
            None if b is None else b.data_ptr(), out.data_ptr(),
            n, h, w, cin, cout, g, wmat.shape[2], block_rows(n * ho * w, cout, x.device), int(vec), ho, row0, stream,
        )
    else:
        b = None if bias is None else bias.float().contiguous()
        status = lib.propainter_deform_conv(
            x.data_ptr(), offset.data_ptr(), mask.data_ptr(), wmat.data_ptr(),
            None if b is None else b.data_ptr(), out.data_ptr(),
            n, h, w, cin, cout, g, ho, row0, stream,
        )
    _build.check(status, "deform_conv2d")
    launches += 1
    launch_shapes[tuple(x.shape) if ho == h else tuple(x.shape) + (f"rows{row0}-{row0 + ho}",)] += 1
    return out
