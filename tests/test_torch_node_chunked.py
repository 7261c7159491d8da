"""The port's node vs the JAX node on a clip longer than subvideo_length:
chunked flow completion and image propagation, windows with global
reference frames. Same tolerances as tests/test_torch_node.py."""

import torch

from test_torch_node import assert_node_outputs_match, run_both, synthetic_clip

torch.set_num_threads(1)


def test_chunked_node_matches_jax_node():
    frames, masks = synthetic_clip(t=14)
    out, ref = run_both(
        frames, masks, width=64, height=48, mask_dilates=2, flow_mask_dilates=2,
        ref_stride=3, neighbor_length=4, subvideo_length=6, raft_iter=2,
    )
    assert out[0].shape == (14, 48, 64, 3)
    assert_node_outputs_match(out, ref)
