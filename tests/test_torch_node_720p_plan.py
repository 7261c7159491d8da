"""Both nodes under the 1280x720 plan, forced at a small size, against the
benchmark's plain reference (`benchmark/reference/pipeline.py`), on the
CPU in float32 with seeded random weights.

At 1280x720 `Pipeline.compute_flow` runs RAFT in chunks (`raft_chunk_len`
4, the all-pairs volume over `RAFT_ALLPAIRS_BYTES`) and RAFT's lookup
takes the map-dtype blend (w8 = 160 over `PROPAINTER_TPU_LANES_WMAX`).
Here those three are lowered so that a 7-frame 160x128 clip takes the
same branches: two RAFT calls of 3 pairs, the "map" lookup. The default
plan of the same clip (one call, the lanes lookup) is the control of
the counter `raft_form/<form>`.

Tolerances are `benchmark/tests/test_bench_reference.py`'s, for the same
reason: masks equal, IMAGE equal to the input outside the dilated mask,
and inside it at most one level off on at most 1e-4 of the values, the
uint8 floors that a float32 rounding flips.
"""

import os

import numpy as np
import pytest
import torch

from benchmark.core import compare, traffic
from benchmark.core import weights as bench_weights
from benchmark.reference import pipeline as ref_pipeline
from benchmark.reference import weights as ref_weights
from comfyui_propainter_nodes_tpu_torch import nodes
from comfyui_propainter_nodes_tpu_torch.config import PipelineConfig
from comfyui_propainter_nodes_tpu_torch.pipeline import stages
from comfyui_propainter_nodes_tpu_torch.utils import profiling
from comfyui_propainter_nodes_tpu_torch.utils import weights as zoo

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MIX = {"frames": 7, "box": [0.2, 0.15], "step_px": [1, 3], "margin_px": 4}
# the node's defaults but the size and RAFT's iterations: two windows of the 7 frames
WIDGETS = dict(width=160, height=128, mask_dilates=5, flow_mask_dilates=8, ref_stride=10, neighbor_length=10,
               subvideo_length=80, raft_iter=3, fp16="disable")
FORMS = {"720p plan": "chunks", "default": "one call"}
LOOKUPS = {"720p plan": "map", "default": "lanes"}
CASES = [("inpaint", "disable"), ("outpaint", "disable"), ("inpaint", "enable")]
LIMITS = os.path.join(ROOT, "benchmark", "limits", "inpaint-360p.object.json")


@pytest.fixture(scope="module")
def clip_and_reference(tmp_path_factory):
    """The seeded weights written as the nodes' checkpoint caches, and per
    node kind the clip's ComfyUI inputs with the reference's outputs."""
    folder = str(tmp_path_factory.mktemp("node-720p-plan-weights"))
    bench_weights.write(bench_weights.draw(2**31 + 24, "cpu"), folder)
    params = ref_weights.load(folder, "cpu")
    made = {}

    def get(kind, w):
        if kind not in made:
            image, mask = traffic.comfy_inputs(*traffic.clip(MIX, w["height"], w["width"], 24, 0))
            with torch.inference_mode():
                ref = ref_pipeline.inpaint(params, image, mask, w) if kind == "inpaint" else ref_pipeline.outpaint(
                    params, image, w)
            made[kind] = image, mask, ref
        return made[kind]

    return folder, get


@pytest.fixture(autouse=True)
def own_caches_and_threads():
    """The nodes' caches hold this file's seeded weights after a call, and
    a test here sets 4 threads: both are put back after each test, so
    that the worker's next tests draw their own weights at their own
    thread count."""
    threads = torch.get_num_threads()
    _clear_caches()
    yield
    _clear_caches()
    torch.set_num_threads(threads)


def _clear_caches():
    for cache in (nodes._PIPELINE_CACHE, nodes._PARAM_CACHE, zoo._PARAM_CACHE):
        cache.clear()


def _program(kind, image, mask, w):
    if kind == "inpaint":
        return nodes.ProPainterInpaint(device="cpu").propainter_inpainting(image, mask, _allow_random_weights=True, **w)
    return nodes.ProPainterOutpaint(device="cpu").propainter_outpainting(image, _allow_random_weights=True, **w)


def _forms_since(before):
    now = profiling.counters()
    return {k: v - before.get(k, 0) for k, v in now.items() if k.startswith("raft_form/") and v != before.get(k, 0)}


def _plan(monkeypatch, folder, plan):
    torch.set_num_threads(4)
    monkeypatch.setenv("PROPAINTER_TPU_WEIGHTS", folder)
    for var in ("PROPAINTER_TPU_CORR_KERNEL", "PROPAINTER_TPU_LANES_BUDGET", "PROPAINTER_TPU_CLIP_PARALLEL"):
        monkeypatch.delenv(var, raising=False)
    if plan == "720p plan":
        monkeypatch.setattr(PipelineConfig, "raft_chunk_len", lambda self: 4)
        monkeypatch.setattr(stages, "RAFT_ALLPAIRS_BYTES", 1e6)
        monkeypatch.setenv("PROPAINTER_TPU_RAFT_ALLPAIRS_BYTES", "1e6")
        monkeypatch.setenv("PROPAINTER_TPU_LANES_WMAX", "0")


@pytest.mark.parametrize("plan", sorted(FORMS))
def test_compute_flow_counts_its_form(clip_and_reference, monkeypatch, plan):
    """One `raft_form/<form>` a `compute_flow` call: "chunks" with the map
    lookup under the 720p plan, "one call" with the lanes lookup by
    default, at the clip's 160x128."""
    folder, _ = clip_and_reference
    _plan(monkeypatch, folder, plan)
    cfg = PipelineConfig(fp16="disable", raft_iter=1, process_size=(160, 128))
    t = MIX["frames"]
    assert stages.raft_form(cfg, t, (128, 160)) == FORMS[plan]
    assert stages.jax_flow_lookup(cfg, t, (128, 160)) == LOOKUPS[plan]
    pipe = nodes.get_pipeline(cfg, "cpu", allow_random_weights=True)
    frames = torch.rand(1, t, 128, 160, 3, generator=torch.Generator().manual_seed(24)) * 2 - 1
    before = profiling.counters()
    ff, fb = pipe.compute_flow(frames)
    assert _forms_since(before) == {f"raft_form/{FORMS[plan]}": 1}
    assert ff.shape == fb.shape == (1, t - 1, 128, 160, 2)


@pytest.mark.parametrize("kind,fp16", CASES, ids=[" ".join(c) for c in CASES])
def test_node_matches_the_reference_under_the_720p_plan(clip_and_reference, monkeypatch, kind, fp16):
    """float32 (fp16 "disable") is held to the reference's bytes; bf16
    (fp16 "enable") is judged as the benchmark judges `inpaint-360p.object`
    (`compare.judge` against its limits file)."""
    folder, get = clip_and_reference
    _plan(monkeypatch, folder, "720p plan")
    w = dict(WIDGETS, fp16=fp16)
    if kind == "outpaint":
        w.update(width_scale=1.2, height_scale=1.0)
    image, mask, ref = get(kind, w)
    before = profiling.counters()
    out = _program(kind, image, mask, w)
    assert _forms_since(before) == {"raft_form/chunks": 1}

    nums = compare.numbers(kind, out, ref)
    if fp16 == "enable":
        ok, checks = compare.judge([nums], compare.load_limits(LIMITS))
        assert ok, checks
        return
    assert nums["masks_mismatch"] == 0 and nums["outside_max"] == 0
    diff = (out[0] - ref[0]).abs().numpy()
    assert diff.max() <= 1 / 255 + 1e-6
    assert np.mean(diff > 0) <= 1e-4
    if kind == "inpaint":  # the masked pixels moved: the comparison is not of the input with itself
        assert np.abs(ref[0].numpy() - image.numpy())[ref[2].numpy() > 0].mean() > 0.01
