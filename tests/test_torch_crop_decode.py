"""The inpaint node's crop: the port's window resize, crop decoder, crop
plan and the node that decodes and fetches only the crop, against the
JAX package on the same inputs.

`resize_2x_window` and `decoder_crop` in fp32 within 1e-5 (seeded
`random_params`), at aligned, unaligned interior and clamped border
offsets; `decoder_crop` also against the port's full decoder sliced to
the crop. The crop plan is exact. The node, on a clip whose mask is small
enough for the JAX node to take its crop: masks equal, IMAGE within 1/255
(the uint8 floor can flip one level), with PIL on the host and without."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_propainter_nodes_tpu import nodes as jnodes
from comfyui_propainter_nodes_tpu.models import propainter as jpp
from comfyui_propainter_nodes_tpu.ops import resize as jresize
from comfyui_propainter_nodes_tpu.utils.weights import random_params
from comfyui_propainter_nodes_tpu_torch import nodes as tnodes
from comfyui_propainter_nodes_tpu_torch.models import propainter as tpp
from comfyui_propainter_nodes_tpu_torch.ops import resize as tresize
from comfyui_propainter_nodes_tpu_torch.pipeline.stages import crop_decode_ok
from comfyui_propainter_nodes_tpu_torch.utils.params import from_jax_params
from test_torch_node import assert_node_outputs_match

torch.set_num_threads(1)


@pytest.mark.parametrize("y0k,x0k", [(0, 0), (28, 32), (7, 13), (3, 5), (14, 0)])
def test_resize_2x_window_matches_jax(y0k, x0k):
    """A 12x16 block of a 40x48 image: top-left and bottom-right blocks
    (clamped), unaligned interior ones."""
    blk = np.random.default_rng(5).standard_normal((2, 12, 16, 5)).astype(np.float32)
    ours = tresize.resize_2x_window(torch.from_numpy(blk), y0k, x0k, 40, 48)
    ref = jresize.resize_2x_window(jnp.asarray(blk), jnp.asarray(y0k), jnp.asarray(x0k), 40, 48)
    assert ours.shape == (2, 24, 32, 5)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    # inside the block's reach the window equals the full image's resize
    full_img = np.random.default_rng(6).standard_normal((1, 40, 48, 2)).astype(np.float32)
    block = torch.from_numpy(full_img[:, y0k : y0k + 12, x0k : x0k + 16])
    win = tresize.resize_2x_window(block, y0k, x0k, 40, 48).numpy()
    full = tresize.resize_bilinear(torch.from_numpy(full_img), 80, 96, align_corners=True).numpy()
    sl = full[:, 2 * y0k : 2 * y0k + 24, 2 * x0k : 2 * x0k + 32]
    np.testing.assert_allclose(win[:, 2:-2, 2:-2], sl[:, 2:-2, 2:-2], atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def decoder_inputs():
    raw = random_params("inpaint_generator", seed=0)
    pj = {k: jnp.asarray(v) for k, v in raw.items()}
    x = (np.random.default_rng(9).standard_normal((2, 48, 64, 128)) * 0.1).astype(np.float32)
    full = tpp.decoder(from_jax_params(raw), torch.from_numpy(x)).numpy()
    return pj, from_jax_params(raw), x, full


# full-res 192x256: aligned, unaligned interior, clamped at the top-left and
# at the bottom-right corners
CROPS = [(32, 64, 64, 96), (99, 119, 64, 96), (47, 59, 32, 64), (0, 0, 32, 32), (3, 5, 32, 32),
         (160, 224, 32, 32), (150, 201, 32, 32)]


@pytest.mark.parametrize("crop", CROPS)
def test_decoder_crop_matches_jax_and_full_decoder(decoder_inputs, crop):
    pj, pt, x, full = decoder_inputs
    y0, x0, ch, cw = crop
    ours = tpp.decoder_crop(pt, torch.from_numpy(x), y0, x0, ch, cw).numpy()
    ref = np.asarray(jpp.decoder_crop(pj, jnp.asarray(x), jnp.asarray(y0), jnp.asarray(x0), ch, cw))
    assert ours.shape == ref.shape == (2, ch, cw, 3)
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(ours, full[:, y0 : y0 + ch, x0 : x0 + cw], atol=1e-5, rtol=0)


def _plan_masks():
    rng = np.random.default_rng(11)
    cases = [np.zeros((3, 64, 96), bool)]  # empty: a 32x32 corner
    for _ in range(6):  # random boxes, some near the borders
        m = np.zeros((3, 64, 96), bool)
        for t in range(3):
            y, x = rng.integers(0, 60), rng.integers(0, 90)
            m[t, y : y + rng.integers(1, 20), x : x + rng.integers(1, 30)] = True
        cases.append(m)
    big = np.zeros((3, 64, 96), bool)
    big[:, 2:60, 3:90] = True  # past 70% of the frame: the whole frame
    cases.append(big)
    return cases


@pytest.mark.parametrize("case", range(len(_plan_masks())))
@pytest.mark.parametrize("pad", [0, 5, 9])
def test_mask_crop_plan_matches_jax(case, pad):
    m = _plan_masks()[case]
    plan = tnodes._mask_crop_plan(m, 64, 96, pad)
    assert plan == jnodes._mask_crop_plan(m, 64, 96, pad)
    if case == len(_plan_masks()) - 1:
        assert plan == (0, 0, 64, 96)


def small_mask_clip(t=6, h=120, w=160, box_h=16):
    """A gradient clip with a 16-wide moving box: at 96x64 the 16x16
    square's crop is 32 rows by 64 columns, small enough for the crop
    decode; a box 100 rows tall gives a crop too tall for it."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([yy / h, xx / w, (yy + xx) / (h + w)], axis=-1).astype(np.float32)
    frames = np.repeat(base[None], t, axis=0)
    masks = np.zeros((t, h, w), dtype=np.float32)
    for i in range(t):
        y0, x0 = 58 - box_h // 2, 40 + 4 * i
        frames[i, y0 : y0 + box_h, x0 : x0 + 16] = [1.0, 0.2, 0.2]
        masks[i, y0 : y0 + box_h, x0 : x0 + 16] = 1.0
    return frames, masks


WIDGETS = dict(
    width=96, height=64, mask_dilates=2, flow_mask_dilates=2, ref_stride=4, neighbor_length=4,
    subvideo_length=80, raft_iter=2, fp16="disable", _allow_random_weights=True,
)


def _run_both(monkeypatch, pil: bool, box_h: int = 16):
    frames, masks = small_mask_clip(box_h=box_h)
    plans = []
    real_plan = tnodes._mask_crop_plan
    monkeypatch.setattr(tnodes, "_mask_crop_plan", lambda *a: plans.append(real_plan(*a)) or plans[-1])
    decoded = []
    real_crop = tpp.decoder_crop
    monkeypatch.setattr(tpp, "decoder_crop", lambda p, x, *a: decoded.append(a) or real_crop(p, x, *a))
    if not pil:
        monkeypatch.setattr(jnodes, "_host_resize_u8", lambda *a: None)
        monkeypatch.setattr(tnodes, "_host_resize_u8", lambda *a: None)
    ref = jnodes.ProPainterInpaint().propainter_inpainting(frames, masks, **WIDGETS)
    out = tnodes.ProPainterInpaint(device="cpu").propainter_inpainting(frames, masks, **WIDGETS)
    return out, ref, plans, decoded


# a 16x16 square (the crop decoded alone, with PIL and without) and a
# box 100 rows tall, whose crop lies within 32 rows of the frame's height
# and fails the gate: the full frames are decoded and then cropped
@pytest.mark.parametrize("pil,box_h", [(True, 16), (False, 16), (True, 100)])
def test_node_crop_matches_jax_node(monkeypatch, pil, box_h):
    monkeypatch.delenv("PROPAINTER_TPU_CROP_DECODE", raising=False)
    out, ref, plans, decoded = _run_both(monkeypatch, pil, box_h)
    (y0, x0, ch, cw), = plans
    alone = crop_decode_ok((64, 96), plans[0])
    if box_h == 16:  # the JAX node's gate takes this crop; so does the port's
        assert ch == 32 and cw <= 64 and alone
    else:
        assert (y0, x0, ch, cw) != (0, 0, 64, 96) and not alone
    assert bool(decoded) == alone and all(a == (y0, x0, ch, cw) for a in decoded)
    assert_node_outputs_match(out, ref)


def test_crop_decode_switch_gives_the_same_outputs(monkeypatch):
    """PROPAINTER_TPU_CROP_DECODE=0 decodes the full frames and crops
    after: the same node outputs as the crop decode."""
    frames, masks = small_mask_clip()
    node = tnodes.ProPainterInpaint(device="cpu")
    monkeypatch.delenv("PROPAINTER_TPU_CROP_DECODE", raising=False)
    crop = node.propainter_inpainting(frames, masks, **WIDGETS)
    decoded = []
    real_crop = tpp.decoder_crop
    monkeypatch.setattr(tpp, "decoder_crop", lambda *a: decoded.append(a) or real_crop(*a))
    monkeypatch.setenv("PROPAINTER_TPU_CROP_DECODE", "0")
    full = node.propainter_inpainting(frames, masks, **WIDGETS)
    assert not decoded
    for a, b in zip(crop, full):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
