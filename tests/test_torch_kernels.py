"""The port's three kernels: plain versions vs the JAX Pallas kernels.

On the CPU each wrapper takes its plain version. The JAX side runs the
Pallas kernel in interpret mode, as the JAX package's own kernel tests do
(tests/test_pallas_kernels.py, tests/test_pallas_attention.py). The CUDA
kernels are held against the plain versions in tests/test_torch_cuda.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from comfyui_propainter_nodes_tpu.ops.pallas.corr_lanes import build_corr_pyramid_bi_lanes, corr_lookup_lanes
from comfyui_propainter_nodes_tpu.ops.pallas.deform_conv import deform_conv2d_pallas
from comfyui_propainter_nodes_tpu.ops.pallas.window_attention import window_attention_pallas
from comfyui_propainter_nodes_tpu_torch.models.raft import build_corr_pyramids
from comfyui_propainter_nodes_tpu_torch.ops.cuda import corr_lookup as b1
from comfyui_propainter_nodes_tpu_torch.ops.cuda import deform_conv as b2
from comfyui_propainter_nodes_tpu_torch.ops.cuda import window_attention as b3

torch.set_num_threads(1)


def _coords(rng, im, h8, w8, scale):
    yy, xx = np.mgrid[0:h8, 0:w8].astype(np.float32)
    base = np.stack([xx, yy], axis=-1)[None]
    return (np.broadcast_to(base, (im, h8, w8, 2)) + rng.standard_normal((im, h8, w8, 2)) * scale).astype(np.float32)


def _port_lookup(f1, f2, coords):
    """Both directions in one call, as RAFT makes it."""
    fwd, bwd = build_corr_pyramids(torch.from_numpy(f1), torch.from_numpy(f2))
    return b1.corr_lookup(fwd, torch.from_numpy(coords), bwd)


def test_corr_lookup_plain_matches_pallas_lanes():
    """Same fmaps, same coords (some windows partly outside): identical
    (level, dx, dy) channels. Odd height exercises the pool tails.
    Tolerance 2e-4: the Pallas kernel sums tent weights over the map, the
    port gathers the 2x2 corners; both in fp32."""
    rng = np.random.default_rng(3)
    n, h8, w8, c = 2, 17, 24, 8
    f1 = rng.standard_normal((n, h8, w8, c)).astype(np.float32)
    f2 = rng.standard_normal((n, h8, w8, c)).astype(np.float32)
    coords = _coords(rng, 2 * n, h8, w8, 3.0)
    with pltpu.force_tpu_interpret_mode():
        ref = corr_lookup_lanes(build_corr_pyramid_bi_lanes(jnp.asarray(f1), jnp.asarray(f2)), jnp.asarray(coords))
    out = _port_lookup(f1, f2, coords)
    assert out.shape == (2 * n, h8, w8, 324)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4, rtol=2e-4)


def test_corr_lookup_plain_all_oob_is_zero():
    rng = np.random.default_rng(9)
    f1 = rng.standard_normal((1, 16, 24, 8)).astype(np.float32)
    f2 = rng.standard_normal((1, 16, 24, 8)).astype(np.float32)
    out = _port_lookup(f1, f2, np.full((2, 16, 24, 2), -50.0, np.float32))
    assert torch.count_nonzero(out) == 0


@pytest.mark.parametrize("shape,g", [((1, 23, 31, 8), 2), ((2, 9, 12, 32), 16)])
def test_deform_conv_plain_matches_pallas(shape, g):
    """fp32; offsets up to ~12 px put many taps outside the image.
    Tolerance 1e-4: 9*Cin-term fp32 sums in another order."""
    rng = np.random.default_rng(7)
    n, h, w, cin = shape
    cout = 16
    x = rng.standard_normal(shape).astype(np.float32)
    off = (rng.standard_normal((n, h, w, g, 9, 2)) * 4).astype(np.float32)
    mask = rng.uniform(0, 1, (n, h, w, g, 9)).astype(np.float32)
    wgt = (rng.standard_normal((3, 3, cin, cout)) * 0.2).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = deform_conv2d_pallas(jnp.asarray(x), jnp.asarray(off), jnp.asarray(mask), jnp.asarray(wgt), jnp.asarray(bias))
    out = b2.deform_conv2d(
        torch.from_numpy(x), torch.from_numpy(off), torch.from_numpy(mask),
        torch.from_numpy(wgt.transpose(3, 2, 0, 1).copy()), torch.from_numpy(bias),
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


def _attention_inputs(rng):
    b, nwb, nh, t, wsz, ch = 2, 3, 2, 4, 8, 16
    nw = b * nwb
    tsel, nroll, pp = 2, 5, 6
    r = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    arrays = [r(nw, nh, t, wsz, ch), r(nw, nh, t, wsz, ch), r(nw, nh, t, wsz, ch),
              r(nw, nh, tsel * nroll, ch), r(nw, nh, tsel * nroll, ch),
              r(b, nh, tsel * pp, ch), r(b, nh, tsel * pp, ch)]
    occ = np.asarray([True, False, True, False, False, True])
    bias_w = np.stack([np.repeat([0.0, -1e9, 0.0, -1e9], wsz), np.repeat([0.0, -1e9, -1e9, -1e9], wsz)])
    bias_r = np.stack([np.where(np.arange(tsel * nroll) % 7 == 3, -1e9, 0.0),
                       np.where(np.arange(tsel * nroll) % 5 == 1, -1e9, 0.0)])
    bias_p = np.zeros((b, tsel * pp))
    return arrays + [occ] + [a.astype(np.float32) for a in (bias_w, bias_r, bias_p)], nwb


def test_window_attention_plain_matches_pallas():
    """Per-batch-row biases (t_ind subset, a padded frame), mixed
    occupancy. Tolerance as the JAX package's own kernel test."""
    args, nwb = _attention_inputs(np.random.default_rng(0))
    with pltpu.force_tpu_interpret_mode():
        ref = window_attention_pallas(*[jnp.asarray(a) for a in args], n_win_per_b=nwb, k_tile=16)
    out = b3.window_attention(*[torch.from_numpy(a) for a in args], n_win_per_b=nwb)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-4)


def test_wrappers_reject_other_devices():
    x = torch.zeros((1, 4, 4, 2), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        b2.deform_conv2d(x, x, x, x)
