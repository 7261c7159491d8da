"""PyTorch port vs the JAX package: params bridge and the op library.

Inputs are made with numpy from a seed and go through the JAX function
and its port on the CPU, in fp32. Per-op tolerance: 1e-5 absolute (the
same arithmetic in another framework; only summation order and fused
multiply-adds differ)."""

import functools
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from comfyui_propainter_nodes_tpu import ops as jops
from comfyui_propainter_nodes_tpu.utils import image as jimage
from comfyui_propainter_nodes_tpu.utils.checkpoint import convert_state_dict
from comfyui_propainter_nodes_tpu.utils.weights import random_params as jax_random_params
from comfyui_propainter_nodes_tpu_torch.models import raft as traft
from comfyui_propainter_nodes_tpu_torch.ops import conv, dilation, patches, pool, resize, warp
from comfyui_propainter_nodes_tpu_torch.utils import image as timage
from comfyui_propainter_nodes_tpu_torch.utils import profiling
from comfyui_propainter_nodes_tpu_torch.utils.params import from_jax_params
from comfyui_propainter_nodes_tpu_torch.utils.weights import random_params

torch.set_num_threads(1)
ATOL = 1e-5


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), atol=atol, rtol=0)


def test_from_jax_params_inverts_convert_state_dict():
    rng = np.random.default_rng(0)
    state = {
        "module.a.conv.weight": torch.from_numpy(rng.standard_normal((8, 3, 3, 5)).astype(np.float32)),
        "module.a.conv.bias": torch.from_numpy(rng.standard_normal(8).astype(np.float32)),
        "b.conv3d.weight": torch.from_numpy(rng.standard_normal((4, 2, 3, 1, 1)).astype(np.float32)),
        "c.linear.weight": torch.from_numpy(rng.standard_normal((6, 7)).astype(np.float32)),
        "d.norm.running_var": torch.from_numpy(rng.uniform(0.5, 1.5, 8).astype(np.float32)),
        "d.norm.num_batches_tracked": torch.tensor(3),
    }
    back = from_jax_params(convert_state_dict(state))
    assert set(back) == {"a.conv.weight", "a.conv.bias", "b.conv3d.weight", "c.linear.weight", "d.norm.running_var"}
    for k, v in back.items():
        src = state["module." + k] if "module." + k in state else state[k]
        assert torch.equal(v, src), k


@pytest.mark.parametrize("model", ["raft", "flow_completion", "inpaint_generator"])
def test_random_params_match_jax(model):
    ours, ref = random_params(model, seed=3), jax_random_params(model, seed=3)
    assert list(ours) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k])


@pytest.mark.parametrize(
    "stride,groups,dilation_", [((1, 1), 1, (1, 1)), ((2, 2), 1, (1, 1)), ((1, 1), 2, (2, 2))]
)
def test_conv2d(stride, groups, dilation_):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 11, 13, 4)).astype(np.float32)
    w = rng.standard_normal((3, 3, 4 // groups, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    ref = jops.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=stride, padding=(1, 1),
                      dilation=dilation_, groups=groups)
    out = conv.conv2d(torch.from_numpy(x), torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                      torch.from_numpy(b), stride=stride, padding=(1, 1), dilation=dilation_, groups=groups)
    _close(out, ref)


# `conv2d_gemm`'s cases: RAFT's update-loop convs (models/raft.py; the GRU's
# z and r side by side) and ProPainter's grouped encoder layers
# (models/propainter.py): name, Cin, Cout of each conv, kernel, padding, groups
GEMM_CONVS = {
    "encoder.convc1": (324, (256,), (1, 1), (0, 0), 1),
    "encoder.convc2": (256, (192,), (3, 3), (1, 1), 1),
    "encoder.convf1": (2, (128,), (7, 7), (3, 3), 1),
    "flow_head.conv2": (256, (2,), (3, 3), (1, 1), 1),
    "gru.convz1+convr1": (384, (128, 128), (1, 5), (0, 2), 1),
    "gru.convq2": (384, (128,), (5, 1), (2, 0), 1),
    "encoder.layers.10": (640, (512,), (3, 3), (1, 1), 2),
    "encoder.layers.12": (768, (384,), (3, 3), (1, 1), 4),
    "encoder.layers.14": (640, (256,), (3, 3), (1, 1), 8),
}
# each dtype's tolerance against F.conv2d: fp32 sums in another order;
# float64 is exact to its own rounding
GEMM_TOL = {torch.float32: 1e-5, torch.float64: 1e-10}


def _gemm_case(name, n, h, w, dtype, gen, bias=True):
    """x, the weights of each conv of the case (scaled to unit outputs) and
    their biases."""
    cin, couts, kernel, _, groups = GEMM_CONVS[name]
    x = torch.randn(n, h, w, cin, generator=gen, dtype=dtype)
    fan = cin // groups * kernel[0] * kernel[1]
    ws = [torch.randn(co, cin // groups, *kernel, generator=gen, dtype=dtype) / fan**0.5 for co in couts]
    bs = [torch.randn(co, generator=gen, dtype=dtype) if bias else None for co in couts]
    return x, ws, bs


@pytest.mark.parametrize("name", list(GEMM_CONVS))
@pytest.mark.parametrize("n,h,w", [(1, 5, 7), (3, 6, 9)])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_conv2d_gemm_matches_conv2d(name, n, h, w, bias, dtype):
    """`conv2d_gemm` on `gemm_weight`'s layout against `F.conv2d`, in fp32
    and float64, each of a fused pair's halves against its own conv, the
    grouped layers as one product a tap batched over the groups; one
    `conv_gemm` count a call."""
    _, couts, kernel, padding, groups = GEMM_CONVS[name]
    x, ws, bs = _gemm_case(name, n, h, w, dtype, torch.Generator().manual_seed(11), bias)
    wt = torch.cat([conv.gemm_weight(w_) for w_ in ws], -1)
    before = profiling.counters().get("conv_gemm", 0)
    out = conv.conv2d_gemm(x, wt, torch.cat(bs) if bias else None, kernel, padding, groups)
    assert profiling.counters()["conv_gemm"] == before + 1
    assert out.shape == (n, h, w, sum(couts)) and out.dtype == dtype
    for part, w_, b_ in zip(out.split(list(couts), -1), ws, bs):
        ref = F.conv2d(x.permute(0, 3, 1, 2), w_, b_, padding=padding, groups=groups).permute(0, 2, 3, 1)
        torch.testing.assert_close(part, ref, rtol=GEMM_TOL[dtype], atol=GEMM_TOL[dtype])


@pytest.mark.parametrize(
    "name", ["encoder.convc2", "encoder.convf1", "flow_head.conv2", "encoder.layers.10", "encoder.layers.12",
             "encoder.layers.14"]
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_conv2d_gemm_gradients_match_conv2d(name, dtype):
    """Each of `conv2d_gemm`'s forms (products a tap, unfolded taps, taps
    side by side, and a tap's product batched over groups 2, 4 and 8) is
    differentiable: x's, the weight's and the bias's gradients against
    `F.conv2d`'s, in fp32 and float64."""
    _, (co,), kernel, padding, groups = GEMM_CONVS[name]
    gen = torch.Generator().manual_seed(13)
    x, (w_,), (b_,) = _gemm_case(name, 2, 5, 7, dtype, gen)
    for t in (x, w_, b_):
        t.requires_grad_()
    gout = torch.randn(2, 5, 7, co, generator=gen, dtype=dtype)
    out = conv.conv2d_gemm(x, conv.gemm_weight(w_), b_, kernel, padding, groups)
    got = torch.autograd.grad(out, (x, w_, b_), gout)
    ref = F.conv2d(x.permute(0, 3, 1, 2), w_, b_, padding=padding, groups=groups).permute(0, 2, 3, 1)
    want = torch.autograd.grad(ref, (x, w_, b_), gout)
    for g, wg in zip(got, want):
        torch.testing.assert_close(g, wg, rtol=GEMM_TOL[dtype], atol=GEMM_TOL[dtype])


def test_conv2d_gemm_refuses_mismatched_groups():
    """Input channels that the weights' groups do not account for, and the
    few-channel forms asked for groups, raise."""
    x = torch.randn(1, 4, 5, 12)
    with pytest.raises(ValueError):
        conv.conv2d_gemm(x, torch.randn(9, 5, 8), None, (3, 3), (1, 1), 2)
    with pytest.raises(ValueError):
        conv.conv2d_gemm(torch.randn(1, 4, 5, 6), torch.randn(9, 3, 8), None, (3, 3), (1, 1), 2)


def test_refine_gemm_convs_match_pconv2d(monkeypatch):
    """RAFT's update loop (3 iterations and the mask head) with the convs
    of GEMM_SITES forced onto `conv2d_gemm` against `pconv2d` on cuDNN's
    stand-in, on the CPU in fp32. The two sum each conv in another order;
    the GRU and the bilinear lookup carry the difference through the
    iterations. Here the flows reach 2.7 px, the two runs sit 3.1e-6 px
    apart and each within 3e-6 px of the same loop in float64: atol 2e-5
    px, rtol 1e-5."""
    params = from_jax_params(random_params("raft", seed=5))
    gen = torch.Generator().manual_seed(12)
    n, h8, w8 = 1, 5, 7
    f1, f2 = (torch.randn(n, h8, w8, 256, generator=gen) for _ in range(2))
    cnet = torch.randn(2 * n, h8, w8, 256, generator=gen)
    lookup = traft._lookup_fn("lanes", f1, f2, bidirectional=True)
    before = profiling.counters().get("conv_gemm", 0)
    ref = traft._refine(params, cnet, lookup, h8, w8, 3)
    assert profiling.counters().get("conv_gemm", 0) == before
    monkeypatch.setattr(conv, "gemm_site", lambda site, x: site in conv.GEMM_SITES)
    out = traft._refine(params, cnet, lookup, h8, w8, 3)
    # 7 convs an iteration (convc1, convc2, convf2, conv, the GRU's 5x1 z|r and
    # q, flow_head.conv2), 1 in the mask head (mask.2)
    assert profiling.counters()["conv_gemm"] == before + 7 * 3 + 1
    assert out.shape == (2 * n, 8 * h8, 8 * w8, 2) and ref.abs().max() > 0.1
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=2e-5)


@functools.lru_cache(maxsize=1)
def _all_params() -> dict:
    """The three networks' random weights in float64, by name (no name is
    in two networks); made once, read only."""
    out = {}
    for model in ("raft", "flow_completion", "inpaint_generator"):
        p = from_jax_params(random_params(model, seed=4))
        assert not set(out) & set(p)
        out.update({k: v.double() for k, v in p.items()})
    return out


def _site_conv(p, site):
    """A GEMM site's weight, bias, padding (the site's own: half the kernel)
    and groups."""
    from comfyui_propainter_nodes_tpu_torch.models import propainter as tpp

    w = p[site + ".weight"]
    if w.ndim == 5:  # a (1, k, k) conv3d, run as a batched 2D conv (`pconv3d`)
        w = w[:, :, 0]
    i = int(site.rsplit(".", 1)[1]) if site.startswith("encoder.layers.") else None
    return w, p.get(site + ".bias"), (w.shape[2] // 2, w.shape[3] // 2), tpp._ENC_GROUPS.get(i, 1)


@pytest.mark.parametrize("site", sorted(conv.GEMM_SITES))
def test_gemm_sites_match_pconv2d(site):
    """Each site of GEMM_SITES, its GEMM form (`conv2d_gemm` on `gemm_weight`
    of its weights, called directly) against its `pconv2d` form (`conv2d`
    at the site, which keeps F.conv2d on the CPU), in float64 at a small
    grid: the same conv, equal to float64 rounding."""
    p = _all_params()
    w, b, padding, groups = _site_conv(p, site)
    x = torch.randn(2, 6, 9, w.shape[1] * groups, generator=torch.Generator().manual_seed(14), dtype=torch.float64)
    before = profiling.counters().get("conv_gemm", 0)
    want = conv.conv2d(x, w, b, padding=padding, groups=groups, site=site)
    assert profiling.counters().get("conv_gemm", 0) == before
    got = conv.conv2d_gemm(x, conv.gemm_weight(w), b, tuple(w.shape[2:]), padding, groups)
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10)


def test_gemm_site_rule():
    """`gemm_site`: a site of GEMM_SITES on CUDA float32 activations with
    grad mode off; CPU and bf16 activations, other sites and grad mode on
    (the training step) keep cuDNN (stand-in tensors: the rule reads only
    the device and the dtype). On the CPU, float32 and bf16 convs at a
    site launch no `conv_gemm`."""
    from types import SimpleNamespace as T

    site = sorted(conv.GEMM_SITES)[0]
    cuda32 = T(is_cuda=True, dtype=torch.float32)
    with torch.no_grad():
        assert conv.gemm_site(site, cuda32)
        assert not conv.gemm_site("encoder.layers.0", cuda32)
        assert not conv.gemm_site(None, cuda32)
        assert not conv.gemm_site(site, T(is_cuda=True, dtype=torch.bfloat16))
        assert not conv.gemm_site(site, T(is_cuda=False, dtype=torch.float32))
    with torch.enable_grad():
        assert not conv.gemm_site(site, cuda32)
    p = _all_params()
    wt = p[site + ".weight"]
    before = profiling.counters().get("conv_gemm", 0)
    for dt in (torch.float32, torch.bfloat16):
        q = {k: v.to(dt) for k, v in p.items() if k.startswith(site + ".")}
        conv.pconv2d(q, site, torch.randn(1, 5, 6, wt.shape[1], dtype=dt), padding=(wt.shape[2] // 2, wt.shape[3] // 2))
    assert profiling.counters().get("conv_gemm", 0) == before


def test_laid_weight_is_laid_once_per_tensor():
    """`laid_weight` lays a weight (or weights side by side, `gemm_layout`)
    out once per tensor and dtype, again after an in-place write."""
    w, v = torch.randn(4, 3, 3, 3), torch.randn(2, 3, 3, 3)
    first = conv.laid_weight(conv.gemm_layout, (w,), torch.float32)
    assert conv.laid_weight(conv.gemm_layout, (w,), torch.float32) is first
    assert torch.equal(first, conv.gemm_weight(w))
    pair = conv.laid_weight(conv.gemm_layout, (w, v), torch.float32)
    assert pair is not first and torch.equal(pair, torch.cat([conv.gemm_weight(w), conv.gemm_weight(v)], -1))
    assert conv.laid_weight(conv.gemm_layout, (w, v), torch.float32) is pair
    # the same first weight alone again: its own layout, not the pair's
    assert torch.equal(conv.laid_weight(conv.gemm_layout, (w,), torch.float32), conv.gemm_weight(w))
    assert conv.laid_weight(conv.gemm_layout, (w,), torch.float64).dtype == torch.float64
    w.mul_(2)
    again = conv.laid_weight(conv.gemm_layout, (w,), torch.float32)
    assert again is not first and torch.equal(again, conv.gemm_weight(w))


def test_pconv3d_spatial_and_temporal():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 5, 6, 7, 3)).astype(np.float32)
    p_j, p_t = {}, {}
    for name, shape in (("s", (1, 3, 3, 3, 4)), ("t", (3, 1, 1, 3, 4))):
        w = rng.standard_normal(shape).astype(np.float32)
        b = rng.standard_normal(4).astype(np.float32)
        p_j[name + ".weight"], p_j[name + ".bias"] = jnp.asarray(w), jnp.asarray(b)
    p_t = from_jax_params({k: np.asarray(v) for k, v in p_j.items()})
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    _close(conv.pconv3d(p_t, "s", xt, stride=(1, 2, 2), padding=(0, 1, 1)),
           jops.pconv3d(p_j, "s", xj, stride=(1, 2, 2), padding=(0, 1, 1)))
    _close(conv.pconv3d(p_t, "t", xt, padding=(2, 0, 0), dilation=(2, 1, 1)),
           jops.pconv3d(p_j, "t", xj, padding=(2, 0, 0), dilation=(2, 1, 1)))


def test_norms_and_linear():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 6, 8)).astype(np.float32)
    raw = {
        "ln.weight": rng.standard_normal(8).astype(np.float32),
        "ln.bias": rng.standard_normal(8).astype(np.float32),
        "bn.weight": rng.standard_normal(8).astype(np.float32),
        "bn.bias": rng.standard_normal(8).astype(np.float32),
        "bn.running_mean": rng.standard_normal(8).astype(np.float32),
        "bn.running_var": rng.uniform(0.5, 1.5, 8).astype(np.float32),
        "fc.weight": rng.standard_normal((8, 3)).astype(np.float32),
        "fc.bias": rng.standard_normal(3).astype(np.float32),
    }
    pj = {k: jnp.asarray(v) for k, v in raw.items()}
    pt = from_jax_params(raw)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    _close(conv.layer_norm(pt, "ln", xt), jops.layer_norm(pj, "ln", xj))
    _close(conv.batch_norm_eval(pt, "bn", xt), jops.batch_norm_eval(pj, "bn", xj))
    _close(conv.instance_norm(xt), jops.instance_norm(xj))
    _close(conv.linear(pt, "fc", xt), jops.linear(pj, "fc", xj))


@pytest.mark.parametrize(
    "size_in,size_out,align",
    [((16, 24), (32, 48), True), ((45, 80), (90, 160), True), ((64, 96), (16, 24), False), ((7, 9), (20, 11), False)],
)
def test_resize_bilinear(size_in, size_out, align):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2,) + size_in + (3,)).astype(np.float32)
    ref = jops.resize_bilinear(jnp.asarray(x), *size_out, align_corners=align)
    _close(resize.resize_bilinear(torch.from_numpy(x), *size_out, align_corners=align), ref)


def test_resize_nearest_and_upflow8():
    rng = np.random.default_rng(5)
    m = (rng.uniform(size=(3, 64, 96, 1)) > 0.5).astype(np.float32)
    _close(resize.resize_nearest(torch.from_numpy(m), 16, 24), jops.resize_nearest(jnp.asarray(m), 16, 24), 0)
    f = rng.standard_normal((1, 6, 8, 2)).astype(np.float32)
    _close(resize.upflow8(torch.from_numpy(f)), jops.upflow8(jnp.asarray(f)))


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
def test_flow_warp_and_consistency(mode):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 12, 16, 5)).astype(np.float32)
    flow = (rng.standard_normal((2, 12, 16, 2)) * 4).astype(np.float32)
    flow2 = (rng.standard_normal((2, 12, 16, 2)) * 4).astype(np.float32)
    _close(warp.flow_warp(torch.from_numpy(x), torch.from_numpy(flow), mode),
           jops.flow_warp(jnp.asarray(x), jnp.asarray(flow), mode))
    _close(warp.fb_consistency_check(torch.from_numpy(flow), torch.from_numpy(flow2)),
           jops.fb_consistency_check(jnp.asarray(flow), jnp.asarray(flow2)), 0)


def test_flow_warp_bf16_samples_at_float32_coordinates():
    """A bf16 map 640 px wide, warped by a sub-pixel flow, samples the same
    taps with the same weights as the warp at float32 coordinates (grid
    and `grid + flow` in float32): bit for bit. bf16 coordinates would be
    exact only up to 256 px, and past it a whole 2-4 px off."""
    gen = torch.Generator().manual_seed(21)
    h, w = 4, 640
    x = torch.randn(1, h, w, 3, generator=gen).to(torch.bfloat16)
    flow = torch.full((1, h, w, 2), 0.375).to(torch.bfloat16)
    flow[..., 1] = -0.625
    coords = (warp.coords_grid(1, h, w) + flow.float()).reshape(1, h * w, 2)
    want = warp.grid_sample(x, coords).reshape(1, h, w, 3)
    got = warp.flow_warp(x, flow)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    # float32 maps and flows: the same arithmetic as ever
    x32, f32 = x.float(), flow.float()
    assert torch.equal(warp.flow_warp(x32, f32),
                       warp.grid_sample(x32, (warp.coords_grid(1, h, w) + f32).reshape(1, h * w, 2)).reshape(1, h, w, 3))


def test_pools_dilation_patches():
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 3, 17, 22, 2)).astype(np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    _close(pool.max_pool2d(xt, (7, 7), (3, 3), (3, 3)), jops.max_pool2d(xj, (7, 7), (3, 3), (3, 3)), 0)
    _close(pool.avg_pool2d(xt, (2, 2), (2, 2)), jops.avg_pool2d(xj, (2, 2), (2, 2)))
    m = (rng.uniform(size=(3, 20, 24)) > 0.97).astype(np.float32)
    _close(dilation.binary_dilation(torch.from_numpy(m), 3), jops.binary_dilation(jnp.asarray(m), 3), 0)
    y = rng.standard_normal((2, 10, 13, 3)).astype(np.float32)
    geo = ((7, 7), (3, 3), (3, 3))
    up = patches.unfold(torch.from_numpy(y), *geo)
    _close(up, jops.unfold(jnp.asarray(y), *geo))
    _close(patches.fold(up, (10, 13), *geo), jops.fold(jops.unfold(jnp.asarray(y), *geo), (10, 13), *geo))
    _close(patches.fold_normalizer(up.shape[1:3], (10, 13), *geo),
           jops.fold_normalizer(up.shape[1:3], (10, 13), *geo))


def test_prepare_frames_and_masks():
    rng = np.random.default_rng(8)
    frames = rng.uniform(size=(2, 30, 44, 3)).astype(np.float32)
    masks = (rng.uniform(size=(2, 30, 44)) > 0.8).astype(np.float32)
    n_t, b_t = timage.prepare_frames(torch.from_numpy(frames), 24, 16)
    n_j, b_j = jimage.prepare_frames(jnp.asarray(frames), 24, 16)
    # both round to bytes; a weight rounding difference may flip one level
    assert np.abs(b_t.numpy() - np.asarray(b_j)).max() <= 1.0
    fm_t, md_t = timage.prepare_masks(torch.from_numpy(masks), 24, 16, 3, 2)
    fm_j, md_j = jimage.prepare_masks(jnp.asarray(masks), 24, 16, 3, 2)
    _close(fm_t, fm_j, 0)
    _close(md_t, md_j, 0)


def test_port_imports_no_jax():
    """The port imports neither jax nor any module of the JAX package."""
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import comfyui_propainter_nodes_tpu_torch, comfyui_propainter_nodes_tpu_torch.nodes\n"
        "import comfyui_propainter_nodes_tpu_torch.pipeline.stages\n"
        "bad = [m for m in sys.modules if m == 'comfyui_propainter_nodes_tpu'"
        " or m.startswith('comfyui_propainter_nodes_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
