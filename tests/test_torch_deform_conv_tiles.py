"""The numerics and chunking of the deformable conv kernels
(csrc/deform_conv.cu), modelled in torch on the CPU: the bf16 kernel
(`deform_conv_mma_kernel`) and, at the end of the file, the fp32 kernel
(`deform_conv_kernel`).

The kernel is an implicit GEMM: the reduction over K = 9 taps x Cin is
walked in chunks of one tap x 64 channels of the weights laid out by
`ops/cuda/deform_conv.py::weight_layout` ([Np, 9, Kp], zero padding). A
gather unit is (pixel, tap, 8-channel slice): its group's (dy, dx) and
mask give one sample position for all its channels, whose four corners
are blended in fp32 in the plain version's order, multiplied by the mask
and rounded once to bf16. The products accumulate in fp32 chunk by
chunk; the bias is added in fp32 and the sum rounded once to bf16. With
the roundings switched off the model is the plain version's arithmetic
in another summation order. Inputs come from a seeded numpy generator.
"""

import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_propainter_nodes_tpu.ops.deform_conv import deform_conv2d_xla
from comfyui_propainter_nodes_tpu_torch.ops import conv
from comfyui_propainter_nodes_tpu_torch.ops.cuda import deform_conv as b2

torch.set_num_threads(1)

KC, SLICE = 64, 8  # the kernel's K chunk and gather slice


def _layout(weight, dtype):
    """The bf16 layout's arithmetic in any dtype: [Np, 9, Kp]."""
    if dtype == torch.bfloat16:
        return b2.weight_layout(weight, dtype).float()
    cout, cin = weight.shape[:2]
    out = torch.zeros(-(-cout // b2.BN) * b2.BN, 9, -(-cin // KC) * KC)
    out[:cout, :, :cin] = weight.float().permute(0, 2, 3, 1).reshape(cout, 9, cin)
    return out


def kernel_model(x, offset, mask, weight, bias=None, rounded=True):
    """deform_conv2d as the tensor-core kernel computes it; `rounded`
    rounds the samples and the output to bf16 (the kernel's bf16 path)."""
    n, h, w, cin = x.shape
    cout = weight.shape[0]
    g = offset.shape[3]
    cg = cin // g
    m = n * h * w
    wl = _layout(weight, torch.bfloat16 if rounded else torch.float32)
    kp = wl.shape[2]
    xg = x.float().reshape(n, h * w, g, cg)
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32), torch.arange(w, dtype=torch.float32), indexing="ij")
    acc = torch.zeros(m, wl.shape[0])
    for k in range(9):
        ki, kj = divmod(k, 3)
        # one position a (pixel, group, tap): shared by the group's channels
        sy = (ys + (ki - 1))[None, :, :, None] + offset[..., k, 0].float()  # [N, H, W, G]
        sx = (xs + (kj - 1))[None, :, :, None] + offset[..., k, 1].float()
        y0, x0 = torch.floor(sy), torch.floor(sx)
        wy, wx = sy - y0, sx - x0
        iy, ix = y0.clamp(-4, h + 4).long(), x0.clamp(-4, w + 4).long()

        def corner(qy, qx):
            yy, xx = iy + qy, ix + qx
            ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).reshape(n, h * w, g)
            v = torch.gather(xg, 1, idx[..., None].expand(-1, -1, -1, cg))
            return (v * ok.reshape(n, h * w, g, 1)).reshape(n, h, w, g, cg)  # zero outside

        gy, gx = 1.0 - wy, 1.0 - wx
        v00, v01, v10, v11 = corner(0, 0), corner(0, 1), corner(1, 0), corner(1, 1)
        s = (v00 * (gy * gx)[..., None] + v01 * (gy * wx)[..., None] + v10 * (wy * gx)[..., None]
             + v11 * (wy * wx)[..., None]) * mask[..., k].float()[..., None]
        s = torch.nn.functional.pad(s.reshape(m, cin), (0, kp - cin))
        if rounded:
            s = s.bfloat16().float()
        for c0 in range(0, kp, KC):  # fp32 accumulation chunk by chunk
            acc = acc + s[:, c0 : c0 + KC] @ wl[:, k, c0 : c0 + KC].T
    out = acc[:, :cout]
    if bias is not None:
        out = out + (bias.bfloat16().float() if rounded else bias.float())
    out = out.reshape(n, h, w, cout)
    return out.bfloat16() if rounded else out


def _inputs(rng, n, h, w, cin, g, cout, scale=4.0):
    """Offsets of scale ~4-12 px put many taps outside the image."""
    x = rng.standard_normal((n, h, w, cin)).astype(np.float32)
    off = (rng.standard_normal((n, h, w, g, 9, 2)) * scale).astype(np.float32)
    mask = rng.uniform(0, 1, (n, h, w, g, 9)).astype(np.float32)
    wgt = (rng.standard_normal((cout, cin, 3, 3)) / np.sqrt(9 * cin)).astype(np.float32)
    bias = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    return x, off, mask, wgt, bias


def _rel(a, b):
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


# (N, H, W, Cin, G, Cout): the call sites' cg 8 and 16 at narrow sizes,
# then the ragged cg 4 and 12 with Cout 40 and H*W = 77 (no multiple of a
# pixel tile), Cin 48 not of the 64-channel chunk
_SHAPES = [(2, 9, 12, 64, 8, 32), (1, 9, 12, 128, 8, 48), (2, 7, 11, 64, 16, 40), (1, 7, 11, 48, 4, 40)]


@pytest.mark.parametrize("shape", _SHAPES)
def test_model_is_the_plain_conv(shape):
    """Roundings off: the plain version's arithmetic (1e-5); on, with bf16
    inputs: within 3e-2 of the plain version on the same inputs."""
    n, h, w, cin, g, cout = shape
    x, off, mask, wgt, bias = (torch.from_numpy(a) for a in _inputs(np.random.default_rng(cin + g), *shape))
    assert (off.abs() > 6).any()
    exact = kernel_model(x, off, mask, wgt, bias, rounded=False)
    assert _rel(exact, b2.deform_conv2d_plain(x, off, mask, wgt, bias)) < 1e-5
    bf = [t.bfloat16() for t in (x, off, mask, wgt, bias)]
    out = kernel_model(*bf)
    ref = b2.deform_conv2d_plain(*bf)
    assert out.dtype == ref.dtype == torch.bfloat16
    assert _rel(out, ref) < 3e-2
    assert _rel(out, b2.deform_conv2d_plain(*[t.float() for t in bf]).bfloat16()) < 3e-2


@pytest.mark.parametrize("shape", _SHAPES)
def test_model_matches_jax_xla_bf16(shape):
    """The JAX package's `deform_conv2d_xla` in bf16 (the function whose
    numerics the kernel follows: samples in the input type before the
    product) on the same rounded inputs: within 3e-2. In bf16 the JAX
    function also rounds each sample position and bilinear weight to
    bf16, which the kernel keeps in fp32; offsets on a 1/8-pixel grid
    (|offset| <= 16, so every position is below 32) make those exact in
    bf16, and the comparison then measures the samples' and the output's
    rounding."""
    x, off, mask, wgt, bias = _inputs(np.random.default_rng(7 + shape[3]), *shape)
    off = np.clip(np.round(off * 8) / 8, -16, 16)
    bf = [torch.from_numpy(a).bfloat16() for a in (x, off, mask, wgt, bias)]
    out = kernel_model(*bf)
    ja = [jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16) for t in bf]
    ref = deform_conv2d_xla(ja[0], ja[1], ja[2], jnp.transpose(ja[3], (2, 3, 1, 0)), ja[4])
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32)))
    assert _rel(out, ref) < 3e-2


@pytest.mark.parametrize("cin,g,vector", [(128, 16, True), (256, 16, True), (64, 16, False), (48, 4, False)])
def test_gather_slices(cin, g, vector):
    """Every 8-channel slice of a 64-channel chunk lies in one offset group
    exactly where the kernel gathers 16-byte corner vectors (cg a multiple
    of 8: the call sites' cg 8 and 16); with cg 4 or 12 some slice spans
    two groups and the kernel gathers channel by channel."""
    cg = cin // g
    kp = -(-cin // KC) * KC
    groups = [{ci // cg for ci in range(s, min(s + SLICE, cin))} for s in range(0, kp, SLICE) if s < cin]
    assert all(len(gs) == 1 for gs in groups) == vector == (cg % SLICE == 0)


def test_weight_layout_is_cached_per_tensor():
    """[Cout, Cin, 3, 3] -> [Np, 9, Kp] bf16 with zero padding, made once a
    weight tensor (`ops/conv.py::laid_weight`), remade after an in-place
    write, dropped with the tensor."""
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.standard_normal((40, 48, 3, 3)).astype(np.float32)).bfloat16()
    laid = conv.laid_weight(b2.weight_layout, (w,), torch.bfloat16)
    assert laid.shape == (128, 9, 64) and laid.dtype == torch.bfloat16
    assert torch.equal(laid[:40, :, :48], w.permute(0, 2, 3, 1).reshape(40, 9, 48))
    assert torch.count_nonzero(laid[40:]) == 0 and torch.count_nonzero(laid[:, :, 48:]) == 0
    assert conv.laid_weight(b2.weight_layout, (w,), torch.bfloat16) is laid
    f32 = conv.laid_weight(b2.weight_layout, (w,), torch.float32)
    assert f32.shape == (9, 48, 128) and f32.dtype == torch.float32
    assert torch.equal(f32[:, :, :40], w.float().permute(2, 3, 1, 0).reshape(9, 48, 40))
    assert torch.count_nonzero(f32[:, :, 40:]) == 0
    w.mul_(2)
    again = conv.laid_weight(b2.weight_layout, (w,), torch.bfloat16)
    assert again is not laid and torch.equal(again[:40, :, :48], w.permute(0, 2, 3, 1).reshape(40, 9, 48))
    key = (b2.weight_layout, id(w), torch.bfloat16)
    del w, laid, again, f32
    gc.collect()
    assert key not in conv._LAYOUTS


# ------------------------------------------------------------ fp32 kernel
#
# The CUDA-core kernel walks K in chunks of one tap x F32_KC (16) channels
# of the fp32 layout [9, Kp, Np] (`weight_layout`: zeros past Cin and
# Cout). A gather unit is (pixel, tap, 4-channel slice): where cg % 4 == 0
# the slice lies in one offset group and one sample position serves its
# four channels; otherwise each channel takes its own group's position.
# Corners are blended in the plain version's order, then multiplied by the
# mask. With a tap split of s blocks, block z sums taps 9z/s .. 9(z+1)/s - 1
# chunk by chunk into its own partial sums; a second kernel adds the
# partials in split order and then the bias.

UNIT = 4  # channels of the fp32 kernel's gather unit


def f32_kernel_model(x, offset, mask, weight, bias=None, splits=1, row0=0):
    """deform_conv2d as the CUDA-core kernel schedules it, in x's dtype
    (fp32, or float64 for the same schedule without fp32's rounding)."""
    n, h, w, cin = x.shape
    ho, g = offset.shape[1], offset.shape[3]
    cout = weight.shape[0]
    cg = cin // g
    dt = x.dtype
    wl = b2.weight_layout(weight, torch.float32).to(dt)
    kp, np_ = wl.shape[1:]
    assert kp % b2.F32_KC == 0 and np_ % b2.BN == 0 and kp >= cin and np_ >= cout
    m = n * ho * w
    xf = x.reshape(n, h * w, cin)
    ys, xs = torch.meshgrid(torch.arange(row0, row0 + ho, dtype=dt), torch.arange(w, dtype=dt), indexing="ij")

    def samples(k, grp, c0, c1):
        """[m, c1 - c0]: channels c0 .. c1 - 1 at group grp's position for tap k"""
        ki, kj = divmod(k, 3)
        sy = (ys + (ki - 1))[None] + offset[:, :, :, grp, k, 0]
        sx = (xs + (kj - 1))[None] + offset[:, :, :, grp, k, 1]
        y0, x0 = torch.floor(sy), torch.floor(sx)
        wy, wx = sy - y0, sx - x0
        iy, ix = y0.clamp(-4, h + 4).long(), x0.clamp(-4, w + 4).long()

        def corner(qy, qx):
            yy, xx = iy + qy, ix + qx
            ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            idx = (yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)).reshape(n, ho * w, 1)
            v = torch.gather(xf[:, :, c0:c1], 1, idx.expand(-1, -1, c1 - c0))
            return v * ok.reshape(n, ho * w, 1)

        gy, gx = 1.0 - wy, 1.0 - wx
        f = lambda t: t.reshape(n, ho * w, 1)  # noqa: E731
        s = (corner(0, 0) * f(gy * gx) + corner(0, 1) * f(gy * wx) + corner(1, 0) * f(wy * gx)
             + corner(1, 1) * f(wy * wx)) * f(mask[:, :, :, grp, k])
        return s.reshape(m, c1 - c0)

    taps = 9 // splits
    partials = []
    for z in range(splits):
        acc = torch.zeros(m, np_, dtype=dt)
        for k in range(z * taps, (z + 1) * taps):
            for c0 in range(0, kp, b2.F32_KC):  # one chunk: its samples, then its products
                a = torch.zeros(m, b2.F32_KC, dtype=dt)
                for u0 in range(c0, min(c0 + b2.F32_KC, cin), UNIT):
                    u1 = min(u0 + UNIT, cin)
                    if cg % UNIT == 0:  # one position for the unit
                        assert u0 // cg == (u1 - 1) // cg
                        a[:, u0 - c0 : u1 - c0] = samples(k, u0 // cg, u0, u1)
                    else:
                        for ci in range(u0, u1):
                            a[:, ci - c0 : ci - c0 + 1] = samples(k, ci // cg, ci, ci + 1)
                acc = acc + a @ wl[k, c0 : c0 + b2.F32_KC]
        partials.append(acc)
    out = partials[0]
    for p in partials[1:]:  # the reduce kernel's order
        out = out + p
    out = out[:, :cout]
    if bias is not None:
        out = out + bias.to(dt)
    return out.reshape(n, ho, w, cout)


# (N, H, W, Cin, G, Cout, row0, Ho): cg 8 and 16 as at the call sites;
# ragged cg 6 (channel by channel) with Cin 24 and cg 4 with Cin 40 (no
# multiples of the 16-channel chunk); Cout 136 over two 128-channel blocks
# and 40, 20 within one; M = N * Ho * W no multiple of the 64-pixel tile;
# a row slab (rows 3-9)
_F32_SHAPES = [(2, 9, 12, 64, 8, 32, 0, 9), (1, 9, 12, 128, 8, 136, 0, 9), (2, 7, 11, 24, 4, 40, 0, 7),
               (1, 7, 11, 40, 10, 20, 0, 7), (2, 13, 11, 64, 4, 40, 3, 6)]


def _f32_inputs(shape, dt=torch.float32):
    n, h, w, cin, g, cout, row0, ho = shape
    x, off, mask, wgt, bias = _inputs(np.random.default_rng(cin + g + cout), n, h, w, cin, g, cout)
    off, mask = off[:, row0 : row0 + ho], mask[:, row0 : row0 + ho]
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dt) for a in (x, off, mask, wgt, bias)], row0


@pytest.mark.parametrize("splits", b2.TAP_SPLITS)
@pytest.mark.parametrize("shape", _F32_SHAPES)
def test_f32_model_is_the_plain_conv(shape, splits):
    """Each tap split of the fp32 schedule is the plain version: within
    1e-5 (relative to the largest output) in fp32, where the chunks and
    the partial sums change only the summation order, and within 1e-12
    in float64."""
    args, row0 = _f32_inputs(shape)
    assert (args[1].abs() > 6).any()
    out = f32_kernel_model(*args, splits=splits, row0=row0)
    assert out.dtype == torch.float32
    assert _rel(out, b2.deform_conv2d_plain(*args, row0=row0)) < 1e-5
    args64 = [t.double() for t in args]
    out64 = f32_kernel_model(*args64, splits=splits, row0=row0)
    ref64 = b2.deform_conv2d_plain(*args64, row0=row0)
    assert ref64.dtype == torch.float64
    assert float((out64 - ref64).abs().max() / ref64.abs().max()) < 1e-12


@pytest.mark.parametrize("shape", [s for s in _F32_SHAPES if s[6] == 0])
def test_f32_model_matches_jax_xla(shape):
    """The fp32 schedule, one split and a split of 9, against the JAX
    package's `deform_conv2d_xla` in fp32 (both fp32 throughout): 1e-5
    relative to the largest output."""
    args, _ = _f32_inputs(shape)
    ja = [jnp.asarray(t.numpy()) for t in args]
    ref = deform_conv2d_xla(ja[0], ja[1], ja[2], jnp.transpose(ja[3], (2, 3, 1, 0)), ja[4])
    assert ref.dtype == jnp.float32
    ref = torch.from_numpy(np.array(ref))
    for splits in (1, 9):
        assert _rel(f32_kernel_model(*args, splits=splits), ref) < 1e-5


@pytest.mark.parametrize("cin,g,vector", [(128, 16, True), (256, 16, True), (40, 10, True), (48, 4, True),
                                          (24, 4, False), (40, 8, False)])
def test_f32_gather_units(cin, g, vector):
    """Every 4-channel unit of a 16-channel chunk lies in one offset group
    exactly where the kernel gathers 16-byte corner vectors (cg a multiple
    of 4: the call sites' cg 8 and 16, cg 4 and 12); with cg 6 or 5 some
    unit spans two groups and the kernel samples channel by channel. Cin
    pads to whole chunks."""
    cg = cin // g
    kp = b2.weight_layout(torch.zeros(8, cin, 3, 3), torch.float32).shape[1]
    assert kp == -(-cin // b2.F32_KC) * b2.F32_KC
    units = [{ci // cg for ci in range(u, min(u + UNIT, cin))} for u in range(0, cin, UNIT)]
    assert all(len(gs) == 1 for gs in units) == vector == (cg % UNIT == 0)


def test_tap_splits_rule(monkeypatch):
    """On a 132-SM card: no split where the 64-pixel tiles give three
    blocks for every two SMs (the main path's feature propagation, path
    T's, path C's x[4,45,80,256], the 720p shapes, the row form), a tap a
    block at the flow completion's x[2,45,80,256] and path O's
    x[2,45,96,256] and at small test shapes."""
    import types

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda d: types.SimpleNamespace(multi_processor_count=132))
    picks = {m: b2.tap_splits(m, 128, "cuda") for m in (5 * 90 * 160, 2 * 45 * 80, 2 * 45 * 96, 2 * 60 * 108,
                                                        4 * 45 * 80, 2 * 90 * 160, 5 * 96 * 320, 2 * 13 * 21)}
    assert picks == {72000: 1, 7200: 9, 8640: 9, 12960: 1, 14400: 1, 28800: 1, 153600: 1, 546: 9}
