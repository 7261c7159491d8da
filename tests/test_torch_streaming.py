"""The port's long-video entry point (`pipeline/streaming.py::process_streaming`)
against the port's in-memory `Pipeline.process` (bit for bit in fp32) and
the JAX package's `Pipeline.process` (within one uint8 level), on a clip
much longer than subvideo_length: chunked flow completion and image
propagation, reference frames, cache eviction. The working set's bound
is checked on longer clips with a stand-in pipeline (`ShapesOnly`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_propainter_nodes_tpu.config import PipelineConfig as JaxConfig
from comfyui_propainter_nodes_tpu.pipeline.stages import Pipeline as JaxPipeline
from comfyui_propainter_nodes_tpu.utils import image as jax_image
from comfyui_propainter_nodes_tpu.utils import weights as jax_weights
from comfyui_propainter_nodes_tpu_torch.config import PipelineConfig
from comfyui_propainter_nodes_tpu_torch.pipeline.stages import Pipeline, window_plan
from comfyui_propainter_nodes_tpu_torch.pipeline.streaming import process_streaming
from comfyui_propainter_nodes_tpu_torch.utils import image as image_utils
from comfyui_propainter_nodes_tpu_torch.utils import weights

torch.set_num_threads(1)

T, H, W = 18, 32, 48
# subvideo_length 6 << T: three completion and three image-propagation
# chunks; ref_stride 3 gives ref_num 2, so windows take reference frames
# and the caches evict once a window starts past frame 9
WIDGETS = dict(ref_stride=3, neighbor_length=6, subvideo_length=6, raft_iter=1, fp16="disable")
DILATES = 2


def moving_box_clip(t: int, h: int, w: int):
    """Frames [t, h, w, 3] and masks [t, h, w] float32 in [0, 1]: a box
    moving over a gradient, masked."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([yy / h, xx / w, (yy + xx) / (h + w)], -1).astype(np.float32)
    frames = np.repeat(base[None], t, 0)
    masks = np.zeros((t, h, w), np.float32)
    bh, bw = h // 4, w // 6
    for i in range(t):
        y0, x0 = h // 3, (3 + 2 * i) % (w - bw - 3)
        frames[i, y0 : y0 + bh, x0 : x0 + bw] = [0.9, 0.2, 0.2]
        masks[i, y0 : y0 + bh, x0 : x0 + bw] = 1.0
    return frames, masks


def port_pipeline(t_cfg: dict, h: int, w: int) -> Pipeline:
    return Pipeline(
        weights.get_params("raft", allow_download=False, allow_random=True),
        weights.get_params("flow_completion", allow_download=False, allow_random=True),
        weights.get_params("inpaint_generator", allow_download=False, allow_random=True),
        PipelineConfig(**t_cfg, process_size=(w, h)),
        device="cpu",
    )


def stream(pipe, frames, masks):
    """process_streaming over arrays: (output, write calls, progress ticks,
    cache peaks)."""
    t, h, w = masks.shape
    out = np.full((t, h, w, 3), -1.0, np.float32)
    writes, ticks = [], []
    pipe.progress = lambda *a: ticks.append(a)

    def write(start, arr):
        writes.append((start, arr.shape[0]))
        out[start : start + arr.shape[0]] = arr

    peaks = process_streaming(
        pipe, lambda s, c: frames[s : s + c], lambda s, c: masks[s : s + c], t, write, DILATES, DILATES
    )
    return out, writes, ticks, peaks


@pytest.fixture(scope="module")
def runs():
    frames, masks = moving_box_clip(T, H, W)
    pipe = port_pipeline(WIDGETS, H, W)
    out, writes, ticks, peaks = stream(pipe, frames, masks)
    fnorm, byte = image_utils.prepare_frames(torch.from_numpy(frames), W, H)
    fm, md = image_utils.prepare_masks(torch.from_numpy(masks), W, H, DILATES, DILATES)
    expected = pipe.process(fnorm[None], fm[None], md[None], byte).numpy()
    return dict(frames=frames, masks=masks, out=out, writes=writes, ticks=ticks, peaks=peaks, expected=expected)


def test_streaming_equals_in_memory_fp32(runs):
    np.testing.assert_array_equal(runs["out"], runs["expected"])


def test_short_clip_equals_in_memory_fp32():
    """A clip no longer than subvideo_length: one chunk a stage, and every
    window takes reference frames from the whole clip (ref_num -1)."""
    t = 8
    frames, masks = moving_box_clip(t, H, W)
    pipe = port_pipeline(dict(WIDGETS, subvideo_length=80), H, W)
    out, writes, _, peaks = stream(pipe, frames, masks)
    fnorm, byte = image_utils.prepare_frames(torch.from_numpy(frames), W, H)
    fm, md = image_utils.prepare_masks(torch.from_numpy(masks), W, H, DILATES, DILATES)
    np.testing.assert_array_equal(out, pipe.process(fnorm[None], fm[None], md[None], byte).numpy())
    assert peaks == {"prep": 1, "completed": 1, "updated": 1}


def test_every_frame_written_once_in_order(runs):
    starts = [s for s, _ in runs["writes"]]
    ends = [s + n for s, n in runs["writes"]]
    assert starts[0] == 0 and ends[-1] == T
    assert starts[1:] == ends[:-1] and all(n > 0 for _, n in runs["writes"])
    out = runs["out"]
    assert out.min() >= 0 and out.max() <= 255 and np.array_equal(out, np.floor(out))


def test_window_ticks_reach_the_window_count(runs):
    n_windows = len(window_plan(PipelineConfig(**WIDGETS, process_size=(W, H)), T))
    ticks = [(d, n) for stage, d, n in runs["ticks"] if stage == "feature_windows"]
    assert ticks == [(i + 1, n_windows) for i in range(n_windows)]


def test_streaming_matches_jax(runs):
    """Within one uint8 level of the JAX package's in-memory run, which
    tests/test_streaming.py holds equal to its own streaming run."""
    jpipe = JaxPipeline(
        jax_weights.get_params("raft", allow_download=False, allow_random=True),
        jax_weights.get_params("flow_completion", allow_download=False, allow_random=True),
        jax_weights.get_params("inpaint_generator", allow_download=False, allow_random=True),
        JaxConfig(**WIDGETS, process_size=(W, H)),
    )
    fnorm, byte = jax_image.prepare_frames(jnp.asarray(runs["frames"]), W, H)
    fm, md = jax_image.prepare_masks(jnp.asarray(runs["masks"]), W, H, DILATES, DILATES)
    ref = np.asarray(jpipe.process(fnorm[None], fm[None], md[None], byte))
    assert ref.shape == runs["out"].shape
    assert np.abs(runs["out"] - ref).max() <= 1.0


class ShapesOnly(Pipeline):
    """A pipeline whose stages keep only the shapes: flows are zero,
    completion and image propagation return their inputs, a window
    composes the input bytes. The streaming loop's chunk plans, caches, tail and
    eviction run as they are; the networks play no part in them."""

    def __init__(self, config: PipelineConfig):
        self.config, self.device, self.cdtype, self.progress = config, torch.device("cpu"), torch.float32, None
        self.raft_params = {"fnet.conv1.weight": torch.zeros(1)}

    def compute_flow(self, frames):
        z = frames.new_zeros(frames.shape[:1] + (frames.shape[1] - 1,) + frames.shape[2:4] + (2,))
        return z, z

    def complete_flow_chunk(self, ff, fb, mk):
        return ff, fb

    def image_prop_chunk(self, fr, mk, ff, fb):
        return fr, mk

    def feature_window(self, frames, masks, upd_masks, flows, old, orig, blend, l_t, n_ref):
        b = blend[:, None, None, None]
        return torch.floor(b * orig + (1.0 - b) * old)


def test_working_set_does_not_grow_with_the_clip():
    """subvideo_length 8, ref_stride 4 (ref_num 2, ref_span 4), neighbor
    stride 2; prepared frames are cached in chunks of 32 at this size.
    A window starting at n0 needs updated chunks (n0 - 4) // 8 ..
    (n0 + 6) // 8 (3 at most); a recomputed updated chunk reads completed
    pairs 10 frames (pad_ip) beyond its bounds, so completed chunks two
    below and two above stay live (7); the prepared frames run from about
    n0 - 32 to n0 + 36 (3 chunks). Every floor leaves 0 once n0 passes
    about 64, so t = 96 is past the plateau, and 2t = 192 must hold no
    more entries."""
    h, w = 32, 48
    cfg = PipelineConfig(ref_stride=4, neighbor_length=4, subvideo_length=8, raft_iter=1, process_size=(w, h))
    peaks = []
    for t in (96, 192):
        frames, masks = moving_box_clip(t, h, w)
        out, writes, _, peak = stream(ShapesOnly(cfg), frames, masks)
        np.testing.assert_array_equal(out, np.floor(frames * 255.0))
        assert [s for s, _ in writes] == [0] + [s + n for s, n in writes[:-1]]
        peaks.append(peak)
    assert peaks[0] == peaks[1] == {"prep": 3, "completed": 7, "updated": 3}
