"""The port's outpaint path vs the JAX package's: the canvas size, the
canvas (`outpaint_canvas`) and its two ring masks, and the whole
ProPainterOutpaint node.

Sizes and the canvas are exact; the node's IMAGE is within 1/255 (the
uint8 floor of the composite can flip one level), its interior equals
the input bytes exactly and OUTPAINT_MASK is equal. The port runs with
device="cpu", so its kernels take their plain versions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_propainter_nodes_tpu.config import OutpaintConfig as JaxOutpaintConfig
from comfyui_propainter_nodes_tpu.nodes import ProPainterOutpaint as JaxOutpaint
from comfyui_propainter_nodes_tpu.utils import image as jimage
from comfyui_propainter_nodes_tpu_torch.config import OutpaintConfig
from comfyui_propainter_nodes_tpu_torch.nodes import ProPainterOutpaint, _host_resize_u8, _to_u8
from comfyui_propainter_nodes_tpu_torch.utils import image as timage
from test_torch_node import synthetic_clip

torch.set_num_threads(1)


@pytest.mark.parametrize("width,height", [(640, 360), (96, 64), (333, 217), (1280, 720)])
def test_outpaint_size_matches_jax(width, height):
    for ws in (0.5, 1.0, 1.2, 1.25, 1.33, 1.5, 2.0, 2.37):
        for hs in (1.0, 1.1, 1.5, 1.77):
            args = (width, height, 5, 8, ws, hs)
            ours, ref = OutpaintConfig(*args), JaxOutpaintConfig(*args)
            assert ours.outpaint_size == ref.outpaint_size
            assert ours.process_size == ref.process_size


# (frame h, w, canvas h, w): every margin above 10 px; the width's margin
# 8 px (the flow mask's 4 px inset is 0 there); a resize to 48x64 first
CANVASES = [((64, 96), (96, 120), (64, 96)), ((64, 96), (64, 112), (64, 96)), ((30, 44), (80, 96), (48, 64))]


@pytest.mark.parametrize("in_hw,canvas_hw,out_hw", CANVASES)
def test_extrapolate_frames_matches_jax(in_hw, canvas_hw, out_hw):
    """`outpaint_canvas` on the frames' bytes at the process size (the
    node's, `resize_frames` of the quantized frames) against the JAX
    `extrapolate_frames` of the same frames."""
    frames = np.random.default_rng(3).uniform(size=(3, *in_hw, 3)).astype(np.float32)
    (oh, ow), (chh, cw) = out_hw, canvas_hw
    byte = timage.resize_frames(torch.floor(torch.clamp(torch.from_numpy(frames) * 255.0, 0.0, 255.0)), ow, oh)
    ours = timage.outpaint_canvas(byte, canvas_hw)
    ref = jimage.extrapolate_frames(jnp.asarray(frames), ow, oh, cw, chh)
    canvas, ref_canvas = ours[0].numpy() / np.float32(255), np.asarray(ref[0])
    assert canvas.shape == ref_canvas.shape == (3, chh, cw, 3)
    if in_hw == out_hw:
        np.testing.assert_array_equal(canvas, ref_canvas)
    else:  # a rounding of the bicubic weights may flip one byte level
        assert np.abs(canvas - ref_canvas).max() <= 1.0 / 255 + 1e-6
    for o, r in zip(ours[1:], ref[1:]):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    h_start, w_start = (chh - oh) // 2, (cw - ow) // 2
    inset_w = 4 if w_start > 10 else 0
    fm = ours[1].numpy()[0, :, :, 0]
    assert fm[h_start + oh // 2, w_start + inset_w - 1] == 1.0
    assert fm[h_start + oh // 2, w_start + inset_w] == 0.0


def test_outpaint_node_matches_jax_node():
    frames, _ = synthetic_clip(t=6)
    kw = dict(
        width=96, height=64, width_scale=1.25, height_scale=1.5, mask_dilates=4, flow_mask_dilates=4,
        ref_stride=4, neighbor_length=4, subvideo_length=80, raft_iter=2, fp16="disable",
        _allow_random_weights=True,
    )
    img, mask, ow, oh = ProPainterOutpaint(device="cpu").propainter_outpainting(frames, **kw)
    ref_img, ref_mask, ref_ow, ref_oh = JaxOutpaint().propainter_outpainting(frames, **kw)
    assert (ow, oh) == (ref_ow, ref_oh) == (120, 96)
    assert img.dtype == mask.dtype == torch.float32
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
    ref_img = np.asarray(ref_img)
    assert img.shape == ref_img.shape == (6, 96, 120, 3)
    assert np.abs(img.numpy() - ref_img).max() <= 1.0 / 255 + 1e-6
    # the interior is the input's own bytes; all four bands are outpainted
    interior = _host_resize_u8(_to_u8(frames), 96, 64).astype(np.float32) / 255.0
    np.testing.assert_array_equal(img.numpy()[:, 16:80, 12:108], interior)
    assert mask.numpy()[:, 16:80, 12:108].sum() == 0 and mask.numpy().sum() == 6 * (96 * 120 - 64 * 96)
    bands = (img[:, :16], img[:, 80:], img[:, 16:80, :12], img[:, 16:80, 108:])
    assert all(float(b.abs().max()) > 0 for b in bands)
