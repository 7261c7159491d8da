"""Conv / linear / norm helpers on NHWC activations, upstream weights.

Weights are upstream-layout tensors (conv OIHW, conv3d OIDHW, linear
(out, in)) in a flat {state_dict_key: tensor} dict. Activations stay
NHWC like the JAX package; each conv views its input as NCHW with
channels-last strides, which cuDNN takes natively, so the permutes
around `F.conv2d` copy nothing on the card. `conv2d_gemm` computes a
stride-1 conv as matrix products over its taps instead (cuBLAS on the
card), on weights laid out by `gemm_weight`. Which convs take it is one
rule, `gemm_site`: the named sites of GEMM_SITES, on CUDA float32
activations, with grad mode off; `conv2d` and `pconv2d` consult it, and
lay out each weight once per tensor and dtype.
"""

from __future__ import annotations

import weakref
from typing import Mapping, Sequence

import torch
import torch.nn.functional as F

from ..utils import profiling

Params = Mapping[str, torch.Tensor]

# `conv2d_gemm` unfolds every tap into one product below this many input
# channels, and takes one product of every tap's weights below this many
# output channels: a product per tap would be a sliver of a matrix
FEW_CHANNELS = 8

# The float32 conv sites (a weight's name) that run as `conv2d_gemm` on the
# card: each stride-1, undilated site where cuDNN's heuristic takes an FFT
# algorithm, takes 1.5x the GEMMs' time or more, or holds a workspace of 4
# GiB or more, at the float32 inpaint clip's shapes (640x360, 24 frames;
# `chip_smoke.py --conv-gemm` times every conv site of the clip both ways
# and reads each one's memory in the clip; PERF.md keeps the table). The
# other sites are as fast or faster on cuDNN's implicit GEMMs.
GEMM_SITES = frozenset(
    # RAFT's encoders: the residual blocks at 1/4 and 1/8 res (FFT), the 1x1 head
    [f"{net}.{conv}" for net in ("fnet", "cnet")
     for conv in ("layer2.0.conv2", "layer2.1.conv1", "layer2.1.conv2", "layer3.0.conv2", "layer3.1.conv1",
                  "layer3.1.conv2", "conv2")]
    # RAFT's update block (convc2, convf2, conv: FFT) and mask head
    + ["update_block." + conv for conv in ("encoder.convc1", "encoder.convc2", "encoder.convf2", "encoder.conv",
                                           "gru.convz2", "gru.convr2", "gru.convq2", "flow_head.conv2", "mask.2")]
    # flow completion: the mid dilation's last conv and the decoder's first (FFT), the 1x1 fusion
    + ["mid_dilation.4", "feat_prop_module.fusion", "decoder2.0"]
    # ProPainter: the encoder's grouped 768 -> 384 and its 512 -> 128 (47 and 39 GiB
    # workspaces), feature fusion, soft_comp's bias conv and the decoder's first two
    # (FFT), its last
    + ["encoder.layers.12", "encoder.layers.16", "feat_prop_module.fuse.0", "feat_prop_module.fuse.2",
       "sc.bias_conv", "decoder.0.conv", "decoder.2", "decoder.6"]
)


def gemm_site(site: str | None, x: torch.Tensor) -> bool:
    """Whether the conv at `site` runs as `conv2d_gemm`: a site of
    GEMM_SITES, on CUDA float32 activations, with grad mode off. The
    training step keeps cuDNN: on GEMMs its first step's gradients moved
    past the 1e-4 that `chip_smoke.py` holds them to against the plain
    kernels' step (1.56e-4), for 2% of its time. bf16 and CPU activations
    keep `F.conv2d`."""
    return site in GEMM_SITES and x.is_cuda and x.dtype == torch.float32 and not torch.is_grad_enabled()


# laid-out weights by the layout function, the first weight tensor's id and
# the dtype: (weak reference to that tensor, the versions, the other
# weights laid beside it, the layout)
_LAYOUTS: dict = {}


def laid_weight(layout, ws: Sequence[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """layout(*ws, dtype=dtype), computed once per weight tensor and dtype,
    and again only if one of ws is written in place (an optimizer step) or
    other weights are laid beside the first: `gemm_layout` here, B2's
    `ops/cuda/deform_conv.py::weight_layout`."""
    key = (layout, id(ws[0]), dtype)
    versions = tuple(w._version for w in ws)
    hit = _LAYOUTS.get(key)
    if (hit is not None and hit[0]() is ws[0] and hit[1] == versions and len(hit[2]) == len(ws) - 1
            and all(a is b for a, b in zip(hit[2], ws[1:]))):
        return hit[3]
    laid = layout(*ws, dtype=dtype)
    _LAYOUTS[key] = (weakref.ref(ws[0], lambda _, key=key: _LAYOUTS.pop(key, None)), versions, tuple(ws[1:]), laid)
    return laid


def conv2d(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor | None = None,
    stride: tuple[int, int] = (1, 1),
    padding: tuple[int, int] = (0, 0),
    dilation: tuple[int, int] = (1, 1),
    groups: int = 1,
    site: str | None = None,
) -> torch.Tensor:
    """x: [N, H, W, Cin], w: [Cout, Cin/groups, kh, kw] -> [N, H', W', Cout].
    At a stride-1, undilated `site` that `gemm_site` takes: `conv2d_gemm`."""
    if tuple(stride) == (1, 1) and tuple(dilation) == (1, 1) and gemm_site(site, x):
        return conv2d_gemm(
            x, laid_weight(gemm_layout, (w,), x.dtype), None if b is None else b.to(x.dtype), tuple(w.shape[2:]),
            padding, groups,
        )
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
    """The conv whose weight and bias are p[name + ".weight"] / ".bias";
    `name` is its site."""
    return conv2d(x, p[name + ".weight"], p.get(name + ".bias"), site=name, **kw)


def pconv2d_many(p: Params, names: Sequence[str], x: torch.Tensor, padding=(0, 0)) -> list[torch.Tensor]:
    """Stride-1 convs of one input, of one kernel size: `pconv2d` each;
    or, where `gemm_site` takes the first, one `conv2d_gemm` with their
    weights side by side (laid out once), its output split."""
    ws = [p[n + ".weight"] for n in names]
    if not gemm_site(names[0], x):
        return [pconv2d(p, n, x, padding=padding) for n in names]
    b = torch.cat([p[n + ".bias"] for n in names]).to(x.dtype)
    y = conv2d_gemm(x, laid_weight(gemm_layout, ws, x.dtype), b, tuple(ws[0].shape[2:]), padding)
    return list(y.split([w.shape[0] for w in ws], -1))


def gemm_weight(w: torch.Tensor) -> torch.Tensor:
    """Conv weight [Cout, Cin/groups, kh, kw] -> the tap-major [kh*kw,
    Cin/groups, Cout] layout `conv2d_gemm` takes (tap t = i*kw + j; group
    g's outputs are its columns [g*Cout/groups, (g+1)*Cout/groups))."""
    co, ci, kh, kw = w.shape
    return w.permute(2, 3, 1, 0).reshape(kh * kw, ci, co).contiguous()


def gemm_layout(*ws: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`gemm_weight` of the weights ws (of one input) in dtype, side by side
    along Cout."""
    return torch.cat([gemm_weight(w.to(dtype)) for w in ws], -1)


def conv2d_gemm(
    x: torch.Tensor,
    wt: torch.Tensor,
    b: torch.Tensor | None,
    kernel: tuple[int, int],
    padding: tuple[int, int],
    groups: int = 1,
) -> torch.Tensor:
    """Stride-1, undilated conv as matrix products over its taps.
    x [N, H, W, Cin]; wt [kh*kw, Cin/groups, Cout] (`gemm_weight`), b
    [Cout] or None, both in x's dtype -> [N, H', W', Cout] in x's dtype,
    with H' = H + 2*ph - kh + 1 (W' alike); often a strided view.

    x is zero-padded once and its padded rows flattened into one run of
    N*Hp*Wp pixels; output pixel (n, y, x) is row r = (n*Hp + y)*Wp + x
    of one output of the same rows (less the last taps' reach), and tap
    (i, j) adds input row r + i*Wp + j times its weight. So each tap is
    one 2D product whose A operand is a shifted view of the padded input
    (no copy a tap), added into the output in place; the bias is the
    first tap's C operand. The result is a strided view of the output's
    [:H', :W'] corner of each image; the rows between mix neighbouring
    pixels and are never read. With groups, each tap is one product
    batched over the groups: group g's A operand is the column slice
    [g*Cin/groups, ..) of the same shifted view, its output the column
    slice [g*Cout/groups, ..) of the one output, which starts as the bias
    (all strided views, no copy). A 1x1 conv is one product. Below
    FEW_CHANNELS input channels the taps are unfolded into one product
    over kh*kw*Cin columns; below FEW_CHANNELS output channels x takes
    one product with every tap's weights side by side, and the taps'
    outputs are added shifted (both ungrouped only). Differentiable.
    The products run in x's dtype under the caller's TF32 setting
    (`pipeline/stages.py::full_fp32` turns it off). Counted as
    `conv_gemm`, one a call (utils/profiling.py::kernel)."""
    kh, kw = kernel
    ph, pw = padding
    n, h, w, c = x.shape
    taps, cg, co = wt.shape
    ho, wo = h + 2 * ph - kh + 1, w + 2 * pw - kw + 1
    if c != groups * cg or (groups > 1 and min(c, co) < FEW_CHANNELS):
        raise ValueError(f"conv2d_gemm: {c} input channels, weights {tuple(wt.shape)}, groups {groups}")
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
        if groups == 1:
            out = torch.mm(flat[:m], wt[0]) if b is None else torch.addmm(b, flat[:m], wt[0])
            for t in range(1, taps):
                i, j = divmod(t, kw)
                out.addmm_(flat[i * wp + j : i * wp + j + m], wt[t])
        else:
            out = x.new_zeros(m, co) if b is None else b.expand(m, co).clone()
            per_group = out.view(m, groups, co // groups).transpose(0, 1)
            for t in range(taps):
                i, j = divmod(t, kw)
                a = flat[i * wp + j : i * wp + j + m].view(m, groups, cg).transpose(0, 1)
                per_group.baddbmm_(a, wt[t].view(cg, groups, co // groups).transpose(0, 1))
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
            site=name,
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
