"""The port's ProPainterInpaint node vs the JAX package's node at the
default numerics, fp16="enable" (bf16 in all three networks).

The clip and widgets of tests/test_torch_node.py (8 frames, 120x160
resized to 96x64, raft_iter 2, seeded random weights); the port runs with
device="cpu". At this size both RAFT calls take the lanes blend in the
port (w8 = 12), while the JAX package on the CPU always takes
`lookup_corr`: the lookup alone differs by a bf16 ulp here and there.
FLOW_MASK and MASK_DILATE must be equal; IMAGE within 1/255 everywhere,
because the uint8 floor of the composite can flip one level."""

import torch

from comfyui_propainter_nodes_tpu.nodes import ProPainterInpaint as JaxInpaint
from comfyui_propainter_nodes_tpu_torch.nodes import ProPainterInpaint
from test_torch_node import assert_node_outputs_match, synthetic_clip

torch.set_num_threads(1)


def test_node_bf16_matches_jax_node():
    frames, masks = synthetic_clip()
    kw = dict(
        width=96, height=64, mask_dilates=4, flow_mask_dilates=4, ref_stride=4, neighbor_length=4,
        subvideo_length=80, raft_iter=2, fp16="enable", _allow_random_weights=True,
    )
    ref = JaxInpaint().propainter_inpainting(frames, masks, **kw)
    out = ProPainterInpaint(device="cpu").propainter_inpainting(frames, masks, **kw)
    assert_node_outputs_match(out, ref)
