"""The port's ProPainterInpaint node vs the JAX package's node.

The synthetic clip of tests/test_nodes.py (8 frames, 120x160 resized to
96x64), raft_iter 2, fp16 disable, seeded random weights; the port runs
with device="cpu", so its kernels take their plain versions. FLOW_MASK
and MASK_DILATE must be equal; IMAGE within 1/255 everywhere, because
the uint8 floor of the composite can flip one level."""

import numpy as np
import pytest
import torch

from comfyui_propainter_nodes_tpu import NODE_CLASS_MAPPINGS as JAX_CLASSES
from comfyui_propainter_nodes_tpu import NODE_DISPLAY_NAME_MAPPINGS as JAX_NAMES
from comfyui_propainter_nodes_tpu.nodes import ProPainterInpaint as JaxInpaint
from comfyui_propainter_nodes_tpu_torch import NODE_CLASS_MAPPINGS, NODE_DISPLAY_NAME_MAPPINGS
from comfyui_propainter_nodes_tpu_torch.nodes import ProPainterInpaint, ProPainterOutpaint

torch.set_num_threads(1)


def synthetic_clip(t=8, h=120, w=160):
    """Moving square over a gradient background + object mask."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([yy / h, xx / w, (yy + xx) / (h + w)], axis=-1).astype(np.float32)
    frames = np.repeat(base[None], t, axis=0)
    masks = np.zeros((t, h, w), dtype=np.float32)
    for i in range(t):
        x0, y0 = 10 + 6 * i, 30 + 2 * i
        frames[i, y0 : y0 + 24, x0 : x0 + 24] = [1.0, 0.2, 0.2]
        masks[i, y0 : y0 + 24, x0 : x0 + 24] = 1.0
    return frames, masks


def run_both(frames, masks, **widgets):
    kw = dict(widgets, fp16="disable", _allow_random_weights=True)
    ref = JaxInpaint().propainter_inpainting(frames, masks, **kw)
    out = ProPainterInpaint(device="cpu").propainter_inpainting(frames, masks, **kw)
    return out, ref


def assert_node_outputs_match(out, ref):
    img, fm, md = out
    assert all(isinstance(o, torch.Tensor) and o.dtype == torch.float32 for o in out)
    np.testing.assert_array_equal(fm.numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(md.numpy(), np.asarray(ref[2]))
    ref_img = np.asarray(ref[0])
    assert img.shape == ref_img.shape
    assert np.abs(img.numpy() - ref_img).max() <= 1.0 / 255 + 1e-6


def test_node_matches_jax_node():
    frames, masks = synthetic_clip()
    out, ref = run_both(
        frames, masks, width=96, height=64, mask_dilates=4, flow_mask_dilates=4,
        ref_stride=4, neighbor_length=4, subvideo_length=80, raft_iter=2,
    )
    assert_node_outputs_match(out, ref)


def test_node_contract():
    assert set(NODE_CLASS_MAPPINGS) == {"ProPainterInpaint", "ProPainterOutpaint"}
    assert set(NODE_CLASS_MAPPINGS) == set(JAX_CLASSES)
    assert NODE_DISPLAY_NAME_MAPPINGS == JAX_NAMES
    for name, node in NODE_CLASS_MAPPINGS.items():
        jax_node = JAX_CLASSES[name]
        assert node.INPUT_TYPES() == jax_node.INPUT_TYPES()
        for attr in ("RETURN_TYPES", "RETURN_NAMES", "FUNCTION", "CATEGORY"):
            assert getattr(node, attr) == getattr(jax_node, attr)


@pytest.mark.parametrize("node", [ProPainterInpaint, ProPainterOutpaint])
def test_node_without_card_raises(monkeypatch, node):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        node()


def test_pipelines_of_two_configs_share_the_device_params():
    """Two configs of one dtype on one device get pipelines of their own
    on the same parameter storage (the JAX package uploads once per
    model and dtype); the fp32 and bf16 configs do not share it."""
    from comfyui_propainter_nodes_tpu_torch import nodes
    from comfyui_propainter_nodes_tpu_torch.config import PipelineConfig

    a, b, c = (
        nodes.get_pipeline(PipelineConfig(neighbor_length=n, fp16=fp16, process_size=(96, 64)), "cpu", True)
        for n, fp16 in ((10, "enable"), (6, "enable"), (10, "disable"))
    )
    assert a is not b and a.config != b.config
    for model in ("raft_params", "flow_params", "inpaint_params"):
        pa, pb, pc = getattr(a, model), getattr(b, model), getattr(c, model)
        assert pa.keys() == pb.keys() == pc.keys()
        for k, v in pa.items():
            assert v.dtype == torch.bfloat16 and v.data_ptr() == pb[k].data_ptr(), (model, k)
            assert pc[k].dtype == torch.float32 and pc[k].data_ptr() != v.data_ptr(), (model, k)
