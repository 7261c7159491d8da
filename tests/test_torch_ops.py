"""PyTorch port vs the JAX package: params bridge and the op library.

Inputs are made with numpy from a seed and go through the JAX function
and its port on the CPU, in fp32. Per-op tolerance: 1e-5 absolute (the
same arithmetic in another framework; only summation order and fused
multiply-adds differ)."""

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


# RAFT's update-loop convs (models/raft.py): name, Cin, Cout of each conv
# (the GRU's z and r side by side), kernel, padding
GEMM_CONVS = {
    "encoder.convc1": (324, (256,), (1, 1), (0, 0)),
    "encoder.convc2": (256, (192,), (3, 3), (1, 1)),
    "encoder.convf1": (2, (128,), (7, 7), (3, 3)),
    "flow_head.conv2": (256, (2,), (3, 3), (1, 1)),
    "gru.convz1+convr1": (384, (128, 128), (1, 5), (0, 2)),
    "gru.convq2": (384, (128,), (5, 1), (2, 0)),
}


@pytest.mark.parametrize("name", list(GEMM_CONVS))
@pytest.mark.parametrize("n,h,w", [(1, 5, 7), (3, 6, 9)])
@pytest.mark.parametrize("bias", [True, False])
def test_conv2d_gemm_matches_conv2d(name, n, h, w, bias):
    """`conv2d_gemm` on `gemm_weight`'s layout against `F.conv2d`, fp32,
    each of a fused pair's halves against its own conv; one `conv_gemm`
    count a call."""
    cin, couts, kernel, padding = GEMM_CONVS[name]
    gen = torch.Generator().manual_seed(11)
    x = torch.randn(n, h, w, cin, generator=gen)
    ws = [torch.randn(co, cin, *kernel, generator=gen) / (cin * kernel[0] * kernel[1]) ** 0.5 for co in couts]
    bs = [torch.randn(co, generator=gen) if bias else None for co in couts]
    wt = torch.cat([conv.gemm_weight(w_) for w_ in ws], -1)
    before = profiling.counters().get("conv_gemm", 0)
    out = conv.conv2d_gemm(x, wt, torch.cat(bs) if bias else None, kernel, padding)
    assert profiling.counters()["conv_gemm"] == before + 1
    assert out.shape == (n, h, w, sum(couts))
    for part, w_, b_ in zip(out.split(list(couts), -1), ws, bs):
        ref = F.conv2d(x.permute(0, 3, 1, 2), w_, b_, padding=padding).permute(0, 2, 3, 1)
        torch.testing.assert_close(part, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["encoder.convc2", "encoder.convf1", "flow_head.conv2"])
def test_conv2d_gemm_gradients_match_conv2d(name):
    """Each of `conv2d_gemm`'s three forms is differentiable: x's, the
    weight's and the bias's gradients against `F.conv2d`'s, fp32."""
    cin, (co,), kernel, padding = GEMM_CONVS[name]
    gen = torch.Generator().manual_seed(13)
    x = torch.randn(2, 5, 7, cin, generator=gen, requires_grad=True)
    w_ = (torch.randn(co, cin, *kernel, generator=gen) / (cin * kernel[0] * kernel[1]) ** 0.5).requires_grad_()
    b_ = torch.randn(co, generator=gen, requires_grad=True)
    gout = torch.randn(2, 5, 7, co, generator=gen)
    out = conv.conv2d_gemm(x, conv.gemm_weight(w_), b_, kernel, padding)
    got = torch.autograd.grad(out, (x, w_, b_), gout)
    ref = F.conv2d(x.permute(0, 3, 1, 2), w_, b_, padding=padding).permute(0, 2, 3, 1)
    want = torch.autograd.grad(ref, (x, w_, b_), gout)
    for g, wg in zip(got, want):
        torch.testing.assert_close(g, wg, rtol=1e-5, atol=1e-5)


def test_refine_gemm_convs_match_pconv2d(monkeypatch):
    """RAFT's update loop (3 iterations and the mask head) with the convs
    forced onto `conv2d_gemm` against `pconv2d`, on the CPU in fp32. The
    two sum each conv in another order; the GRU and the bilinear lookup
    carry the difference through the iterations. Here the flows reach
    2.7 px, the two runs sit 3.1e-6 px apart and each within 3e-6 px of
    the same loop in float64: atol 2e-5 px, rtol 1e-5."""
    params = from_jax_params(random_params("raft", seed=5))
    gen = torch.Generator().manual_seed(12)
    n, h8, w8 = 1, 5, 7
    f1, f2 = (torch.randn(n, h8, w8, 256, generator=gen) for _ in range(2))
    cnet = torch.randn(2 * n, h8, w8, 256, generator=gen)
    lookup = traft._lookup_fn("lanes", f1, f2, bidirectional=True)
    before = profiling.counters().get("conv_gemm", 0)
    ref = traft._refine(params, cnet, lookup, h8, w8, 3)
    assert profiling.counters().get("conv_gemm", 0) == before
    monkeypatch.setattr(traft, "gemm_convs", lambda x: True)
    out = traft._refine(params, cnet, lookup, h8, w8, 3)
    # 11 convs an iteration (the GRU's z and r one each 1x5 / 5x1), 2 in the mask head
    assert profiling.counters()["conv_gemm"] == before + 11 * 3 + 2
    assert out.shape == (2 * n, 8 * h8, 8 * w8, 2) and ref.abs().max() > 0.1
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=2e-5)


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
