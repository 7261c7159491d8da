"""The pipeline's TF32 switch is scoped to a run.

`Pipeline.process` runs on the card with TF32 off for cuDNN convs and
matmuls (`stages.full_fp32`) and gives the process its own two flags back
after the run, also when a stage raises. The CPU pipeline does not enter
the switch, so these tests drive the context manager directly and
`Pipeline.process` with stand-in stages on a pipeline that says it is on
the card."""

import contextlib
import itertools

import pytest
import torch

from comfyui_propainter_nodes_tpu_torch.pipeline import stages
from comfyui_propainter_nodes_tpu_torch.utils import profiling


def _flags():
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


@pytest.fixture
def restore_flags():
    before = _flags()
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before


@pytest.mark.parametrize("cudnn,matmul", list(itertools.product([True, False], repeat=2)))
@pytest.mark.parametrize("raises", [False, True])
def test_full_fp32_restores_the_flags(restore_flags, cudnn, matmul, raises):
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = cudnn, matmul
    with pytest.raises(RuntimeError) if raises else contextlib.nullcontext():
        with stages.full_fp32():
            assert _flags() == (False, False)
            if raises:
                raise RuntimeError("a stage failed")
    assert _flags() == (cudnn, matmul)


def test_process_runs_in_full_fp32_and_restores(restore_flags):
    """Stand-in stages record the flags they run under."""
    pipe = stages.Pipeline.__new__(stages.Pipeline)
    pipe.device = torch.device("cuda")
    pipe._sync = lambda: None
    seen = []

    def stage(*args):
        seen.append(_flags())
        return args[0]

    pipe.compute_flow = pipe.complete_flow = pipe.feature_propagation = stage
    pipe.image_propagation = lambda *args: (stage(*args), None)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, True
    profiling.reset_stages()
    assert pipe.process("frames", "flow_masks", "masks", "original") == "frames"
    assert seen == [(False, False)] * 4
    assert _flags() == (True, True)
    assert set(profiling.summary()) == {"compute_flow", "complete_flow", "image_propagation", "feature_propagation"}


def test_building_a_pipeline_leaves_the_flags(restore_flags):
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, True
    stages.Pipeline({}, {}, {}, stages.PipelineConfig(), device="cpu")
    assert _flags() == (True, True)
