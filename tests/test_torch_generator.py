"""PyTorch port vs the JAX package: image propagation, the sparse
transformer and the InpaintGenerator.

Same numpy inputs and the same seeded random weights (`random_params`,
carried across by `from_jax_params`) on the CPU, in fp32. JAX runs its
CPU paths (the Pallas kernels' XLA twins). Per-model tolerance: 1e-4 of
the output's largest magnitude (fp32 reassociation through a few dozen
layers and recurrent steps). The whole generator also in float64, at
the JAX package's own spatial test case (tests/test_spatial.py), to
1e-9 as that test pins it: the port's plain kernels follow float64
inputs as the JAX XLA twins do."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from comfyui_propainter_nodes_tpu.models import propainter as jpp
from comfyui_propainter_nodes_tpu.ops import attention as jatt
from comfyui_propainter_nodes_tpu.utils.weights import random_params
from comfyui_propainter_nodes_tpu_torch.models import propainter as tpp
from comfyui_propainter_nodes_tpu_torch.ops import attention as tatt
from comfyui_propainter_nodes_tpu_torch.utils.params import from_jax_params

torch.set_num_threads(1)


def _params(raw):
    return {k: jnp.asarray(v) for k, v in raw.items()}, from_jax_params(raw)


def _close_rel(port, ref, rel=1e-4):
    ref = np.asarray(ref)
    port = port.detach().numpy() if hasattr(port, "detach") else np.asarray(port)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(port - ref).max())
    assert err <= rel * scale, f"max abs err {err} > {rel} * {scale}"


def test_img_propagation():
    """Warp-fill propagation: nearest sampling and binarized masks, so the
    port must agree to rounding (1e-5)."""
    rng = np.random.default_rng(2)
    frames = rng.uniform(-1, 1, (1, 6, 32, 48, 3)).astype(np.float32)
    ff = (rng.standard_normal((1, 5, 32, 48, 2)) * 2).astype(np.float32)
    fb = (rng.standard_normal((1, 5, 32, 48, 2)) * 2).astype(np.float32)
    masks = np.zeros((1, 6, 32, 48, 1), np.float32)
    for i in range(6):
        masks[:, i, 8 + i : 20 + i, 10 + 2 * i : 26 + 2 * i] = 1.0
    masked = frames * (1 - masks)
    ref = jpp.img_propagation(jnp.asarray(masked), jnp.asarray(ff), jnp.asarray(fb), jnp.asarray(masks))
    out = tpp.img_propagation(torch.from_numpy(masked), torch.from_numpy(ff), torch.from_numpy(fb), torch.from_numpy(masks))
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-5, rtol=0)


def _block_params(rng, pre, c, c_mid):
    def r(*s, scale=None):
        return (rng.standard_normal(s) * (scale or 1.0 / np.sqrt(s[0]))).astype(np.float32)

    p = {}
    for name in ("query", "key", "value", "proj"):
        p[f"{pre}.attention.{name}.weight"] = r(c, c)
        p[f"{pre}.attention.{name}.bias"] = r(c, scale=0.05)
    p[f"{pre}.attention.pool_layer.weight"] = r(4, 4, 1, c, scale=0.25)
    p[f"{pre}.attention.pool_layer.bias"] = r(c, scale=0.05)
    for n in ("norm1", "norm2"):
        p[f"{pre}.{n}.weight"] = 1.0 + r(c, scale=0.1)
        p[f"{pre}.{n}.bias"] = r(c, scale=0.1)
    p[f"{pre}.mlp.fc1.0.weight"] = r(c, 49 * c_mid)
    p[f"{pre}.mlp.fc1.0.bias"] = r(49 * c_mid, scale=0.05)
    p[f"{pre}.mlp.fc2.1.weight"] = r(49 * c_mid, c)
    p[f"{pre}.mlp.fc2.1.bias"] = r(c, scale=0.05)
    return p


def test_sparse_window_attention_narrow():
    """32 channels, 4 heads, a 12x20 token grid (padded to 15x27), a t_ind
    subset and one padded frame in the second batch row."""
    rng = np.random.default_rng(3)
    raw = _block_params(rng, "blk", 32, 2)
    pj, pt = _params(raw)
    x = rng.standard_normal((2, 4, 12, 20, 32)).astype(np.float32)
    mask = np.zeros((2, 2, 12, 20, 1), np.float32)
    mask[0, 0, 2:6, 3:9] = 1.0
    mask[1, 1, 9:11, 14:19] = 1.0
    tvm = np.ones((2, 4), bool)
    tvm[1, 3] = False
    t_ind = np.arange(0, 4, 2)
    ref = jatt.sparse_window_attention(pj, "blk.attention", jnp.asarray(x), jnp.asarray(mask), t_ind,
                                       t_valid_mask=jnp.asarray(tvm))
    out = tatt.sparse_window_attention(pt, "blk.attention", torch.from_numpy(x), torch.from_numpy(mask), t_ind,
                                       t_valid_mask=torch.from_numpy(tvm))
    _close_rel(out, ref)


def test_transformer_stack_narrow():
    """8 blocks, temporal dilation 2, on a 10x18 token grid folded from a
    30x54 feature map."""
    rng = np.random.default_rng(4)
    raw = {}
    for i in range(8):
        raw.update(_block_params(rng, f"tr.transformer.{i}", 32, 2))
    pj, pt = _params(raw)
    x = rng.standard_normal((1, 5, 10, 18, 32)).astype(np.float32)
    mask = np.zeros((1, 3, 10, 18, 1), np.float32)
    mask[0, 1, 1:4, 2:7] = 1.0
    tvm = np.asarray([True, True, True, True, False])
    ref = jatt.transformer_stack(pj, "tr", jnp.asarray(x), (30, 54), jnp.asarray(mask), t_valid_mask=jnp.asarray(tvm))
    out = tatt.transformer_stack(pt, "tr", torch.from_numpy(x), (30, 54), torch.from_numpy(mask),
                                 t_valid_mask=torch.from_numpy(tvm))
    _close_rel(out, ref)


def test_inpaint_generator_forward():
    """1 x (4 local + 2 reference) frames at 64x96, full widths."""
    pj, pt = _params(random_params("inpaint_generator", seed=5))
    rng = np.random.default_rng(5)
    frames = rng.uniform(-1, 1, (1, 6, 64, 96, 3)).astype(np.float32)
    masks = np.zeros((1, 6, 64, 96, 1), np.float32)
    masks[:, :, 16:40, 24:60] = 1.0
    upd = masks.copy()
    upd[:, :, 16:28] = 0.0
    ff = (rng.standard_normal((1, 3, 64, 96, 2)) * 2).astype(np.float32)
    fb = (rng.standard_normal((1, 3, 64, 96, 2)) * 2).astype(np.float32)
    masked = frames * (1 - masks)
    ref = jpp.inpaint_generator_forward(pj, *[jnp.asarray(a) for a in (masked, ff, fb, masks, upd)], 4)
    out = tpp.inpaint_generator_forward(pt, *[torch.from_numpy(a) for a in (masked, ff, fb, masks, upd)], 4)
    _close_rel(out, ref)


def test_inpaint_generator_forward_float64():
    """tests/test_spatial.py's case (b 1, l_t 4, 2 reference frames, 80x96,
    seed 0) in float64: atol = rtol = 1e-9; measured: 1.6e-15 at most."""
    import test_torch_spatial

    raw = random_params("inpaint_generator")
    arrays, l_t = test_torch_spatial.forward_inputs(80, 96, np.float64)
    with jax.enable_x64(True):
        jparams = {k: jnp.asarray(v, jnp.float64) for k, v in raw.items()}
        ref = np.asarray(jpp.inpaint_generator_forward(jparams, *map(jnp.asarray, arrays), l_t))
    params = {k: v.double() for k, v in from_jax_params(raw).items()}
    out = tpp.inpaint_generator_forward(params, *(torch.from_numpy(a) for a in arrays), l_t).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-9, rtol=1e-9)
