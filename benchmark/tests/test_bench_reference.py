"""The benchmark's plain reference against the program's plain path, on
the CPU at small sizes, float32: both nodes, one subvideo chunk and
several (flow completion's and image propagation's halos, the windows'
limited reference frames).

The program runs with device="cpu", where every kernel takes its plain
version; the reference shares no code with it. Masks are equal, IMAGE
equals the input outside the dilated mask, and inside it the two agree
but for uint8 floors that a float32 rounding flips: at most one level,
on at most 1e-4 of the values.
"""

import os
import sys
import tempfile

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.core import compare, traffic  # noqa: E402
from benchmark.core import weights as bench_weights  # noqa: E402
from benchmark.reference import pipeline as ref_pipeline  # noqa: E402
from benchmark.reference import resize as ref_resize  # noqa: E402
from benchmark.reference import weights as ref_weights  # noqa: E402

torch.set_num_threads(4)

MIX = {"frames": 7, "box": [0.2, 0.15], "step_px": [1, 3], "margin_px": 4}
BASE = dict(width=160, height=128, mask_dilates=3, flow_mask_dilates=4, ref_stride=2, neighbor_length=4,
            subvideo_length=80, raft_iter=3, fp16="disable")
CASES = {
    "one chunk": dict(BASE),
    "chunks": dict(BASE, subvideo_length=4, ref_stride=3),  # 2 completion and 2 propagation chunks, ref_num 1
}


@pytest.fixture(scope="module")
def weights_dir():
    d = tempfile.mkdtemp(prefix="bench-ref-test-")
    bench_weights.write(bench_weights.draw(2**31 + 5, "cpu"), d)
    old = os.environ.get("PROPAINTER_TPU_WEIGHTS")
    os.environ["PROPAINTER_TPU_WEIGHTS"] = d
    yield d
    if old is None:
        os.environ.pop("PROPAINTER_TPU_WEIGHTS")
    else:
        os.environ["PROPAINTER_TPU_WEIGHTS"] = old


def _program(kind, image, mask, w):
    from comfyui_propainter_nodes_tpu_torch import nodes
    from comfyui_propainter_nodes_tpu_torch.utils import weights as zoo

    for cache in (nodes._PIPELINE_CACHE, nodes._PARAM_CACHE, zoo._PARAM_CACHE):
        cache.clear()
    if kind == "inpaint":
        return nodes.ProPainterInpaint(device="cpu").propainter_inpainting(image, mask, _allow_random_weights=True, **w)
    return nodes.ProPainterOutpaint(device="cpu").propainter_outpainting(image, _allow_random_weights=True, **w)


@pytest.mark.parametrize("kind", ["inpaint", "outpaint"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_matches_the_programs_plain_path(weights_dir, kind, case):
    w = dict(CASES[case])
    if kind == "outpaint":
        w.update(width_scale=1.2, height_scale=1.0)
    image, mask = traffic.comfy_inputs(*traffic.clip(MIX, w["height"], w["width"], 17, 0))
    out = _program(kind, image, mask, w)
    ref = (ref_pipeline.inpaint if kind == "inpaint" else lambda p, i, m, ww: ref_pipeline.outpaint(p, i, ww))(
        ref_weights.load(weights_dir, "cpu"), image, mask, w)
    nums = compare.numbers(kind, out, ref)
    assert nums["masks_mismatch"] == 0 and nums["outside_max"] == 0
    diff = (out[0] - ref[0]).abs().numpy()
    assert diff.max() <= 1 / 255 + 1e-6
    assert np.mean(diff > 0) <= 1e-4
    if kind == "inpaint":  # the masked pixels moved: the comparison is not of the input with itself
        assert np.abs(ref[0].numpy() - image.numpy())[ref[2].numpy() > 0].mean() > 0.01


def test_windows_follow_the_reference_script():
    w = dict(BASE, neighbor_length=10, ref_stride=10, subvideo_length=80)
    wins = ref_pipeline.windows(w, 24)
    assert [n[0] for n, _ in wins] == [0, 0, 5, 10, 15] and [len(n) for n, _ in wins] == [6, 11, 11, 11, 9]
    assert [r for _, r in wins] == [[10, 20], [20], [0, 20], [0], [0, 10]]


@pytest.mark.parametrize("hw", [(96, 120, 64, 80), (64, 80, 96, 120), (135, 240, 45, 80), (37, 53, 37, 29)])
def test_the_resize_is_pils_to_the_byte(hw):
    from PIL import Image

    h, w, oh, ow = hw
    rng = np.random.default_rng(h * w)
    frames = rng.integers(0, 256, (2, h, w, 3), dtype=np.uint8)
    masks = (rng.random((2, h, w)) > 0.7).astype(np.uint8) * 255
    for stack in (frames, masks):
        pil = np.stack([np.asarray(Image.fromarray(f).resize((ow, oh))) for f in stack])
        np.testing.assert_array_equal(ref_resize.resize(torch.from_numpy(stack), oh, ow).numpy(), pil)
