"""The port's node vs the JAX node on a clip longer than subvideo_length:
chunked flow completion and image propagation, windows with global
reference frames. Same tolerances as tests/test_torch_node.py. The
single-card clip-parallel form of the chunked stages
(PROPAINTER_TPU_CLIP_PARALLEL=1) against the chunks in turn and the JAX
`Pipeline.process` under the same variable."""

import jax.numpy as jnp
import numpy as np
import torch

from comfyui_propainter_nodes_tpu.config import PipelineConfig as JaxConfig
from comfyui_propainter_nodes_tpu.pipeline.stages import Pipeline as JaxPipeline
from comfyui_propainter_nodes_tpu.utils import weights as jax_weights
from comfyui_propainter_nodes_tpu_torch.config import PipelineConfig
from comfyui_propainter_nodes_tpu_torch.pipeline.stages import Pipeline
from comfyui_propainter_nodes_tpu_torch.utils import weights
from test_torch_node import assert_node_outputs_match, run_both, synthetic_clip
from torch_parallel_ranks import make_inputs

torch.set_num_threads(1)


def test_chunked_node_matches_jax_node():
    frames, masks = synthetic_clip(t=14)
    out, ref = run_both(
        frames, masks, width=64, height=48, mask_dilates=2, flow_mask_dilates=2,
        ref_stride=3, neighbor_length=4, subvideo_length=6, raft_iter=2,
    )
    assert out[0].shape == (14, 48, 64, 3)
    assert_node_outputs_match(out, ref)


def test_single_card_clip_parallel_process_matches_jax(monkeypatch):
    """16 frames at 48x64, subvideo_length 6, fp32 (tests/test_sharding.py's
    clip-parallel clip): with the variable and no mesh RAFT's 2 chunks,
    the 3 completion and the 3 image-propagation chunks each run as one
    padded batched call; the same bytes as the chunks in turn, and within
    one uint8 level of the JAX package under the same variable."""
    monkeypatch.delenv("PROPAINTER_TPU_CLIP_PARALLEL", raising=False)
    widgets = dict(ref_stride=4, neighbor_length=4, subvideo_length=6, raft_iter=1, fp16="disable", process_size=(64, 48))
    frames, masks, orig = make_inputs(1, 16, 48, 64)
    models = ("raft", "flow_completion", "inpaint_generator")
    pipe = Pipeline(*(weights.get_params(m, allow_random=True) for m in models), PipelineConfig(**widgets), device="cpu")
    args = [torch.from_numpy(a) for a in (frames, masks, masks, orig)]
    in_turn = pipe.process(*args).numpy()
    monkeypatch.setenv("PROPAINTER_TPU_CLIP_PARALLEL", "1")
    assert pipe._clip_parallel() and pipe._dp() == 1
    np.testing.assert_array_equal(pipe.process(*args).numpy(), in_turn)
    jax_pipe = JaxPipeline(*(jax_weights.get_params(m, allow_random=True) for m in models), JaxConfig(**widgets))
    ref = np.asarray(jax_pipe.process(*(jnp.asarray(a) for a in (frames, masks, masks, orig))))
    assert np.abs(in_turn - ref).max() <= 1.0
