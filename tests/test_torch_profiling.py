"""The port's stage timers, progress sink and run records
(`utils/profiling.py`, `utils/metrics.py`), against the JAX package's
record where they share a contract, and the inpaint node wrapped in
them."""

import json
import sys
import types

import numpy as np
import pytest
import torch

from comfyui_propainter_nodes_tpu.config import PipelineConfig as JaxConfig
from comfyui_propainter_nodes_tpu.utils import metrics as jax_metrics
from comfyui_propainter_nodes_tpu_torch.config import PipelineConfig
from comfyui_propainter_nodes_tpu_torch.nodes import ProPainterInpaint
from comfyui_propainter_nodes_tpu_torch.utils import metrics, profiling
from test_torch_node import synthetic_clip

torch.set_num_threads(1)


def test_record_has_the_jax_records_keys(tmp_path, monkeypatch):
    """A port of tests/test_utils_misc.py::test_metrics_record, and the
    same keys as the JAX package's record, its config's included."""
    path = tmp_path / "metrics.jsonl"
    monkeypatch.setenv("PROPAINTER_TPU_METRICS", str(path))
    with jax_metrics.RunRecorder("inpaint", JaxConfig(), 10):
        pass
    ref = jax_metrics.last_run()
    with metrics.RunRecorder("inpaint", PipelineConfig(), 10):
        pass
    rec = metrics.last_run()
    assert rec["ok"] and rec["video_length"] == 10 and rec["kind"] == "inpaint"
    assert set(rec) == set(ref) and set(rec["config"]) == set(ref["config"])
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    assert len(lines) == 2 and lines[1]["kind"] == "inpaint" and lines[1]["ok"]


def test_record_appends_and_marks_a_failed_run(tmp_path, monkeypatch):
    path = tmp_path / "metrics.jsonl"
    monkeypatch.setenv("PROPAINTER_TPU_METRICS", str(path))
    with metrics.RunRecorder("outpaint", PipelineConfig(), 4):
        pass
    with pytest.raises(RuntimeError):
        with metrics.RunRecorder("inpaint", PipelineConfig(), 5):
            raise RuntimeError("a stage failed")
    assert metrics.last_run()["ok"] is False
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    assert [(r["kind"], r["ok"]) for r in lines] == [("outpaint", True), ("inpaint", False)]


def test_progress_report_swallows_callback_errors():
    seen = []

    def callback(stage, done, total):
        seen.append((stage, done, total))
        raise ValueError("a broken progress bar")

    profiling.progress_report(callback, "compute_flow", 1, 1)
    profiling.progress_report(None, "compute_flow", 1, 1)
    assert seen == [("compute_flow", 1, 1)]


class FakeBar:
    def __init__(self, total):
        self.total = total
        self.values = []

    def update_absolute(self, value):
        self.values.append(value)


def test_node_progress_drives_comfy_and_stays_monotonic(monkeypatch):
    comfy = types.ModuleType("comfy")
    comfy.utils = types.ModuleType("comfy.utils")
    comfy.utils.ProgressBar = FakeBar
    monkeypatch.setitem(sys.modules, "comfy", comfy)
    monkeypatch.setitem(sys.modules, "comfy.utils", comfy.utils)
    prog = profiling.NodeProgress(20)
    for done in (1, 3, 2, 4):
        prog("feature_propagation", done, 4)
    assert prog._comfy_bar.values == [5, 15, 15, 20]


def test_node_progress_falls_back_to_stderr_without_tqdm(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "comfy", None)
    monkeypatch.setitem(sys.modules, "tqdm", None)
    prog = profiling.NodeProgress(8)
    prog("complete_flow", 0, 1)
    prog("complete_flow", 1, 1)
    prog("complete_flow", 0, 1)  # late tick: stays at 1
    err = capsys.readouterr().err
    assert "[propainter] complete_flow: 0/1" in err
    assert err.count("[propainter] complete_flow: 1/1") == 2


@pytest.mark.parametrize("blocking", [False, True])
def test_stage_timer_fills_the_summary(blocking):
    old = profiling.blocking()
    profiling.set_blocking(blocking)
    try:
        profiling.reset()
        with profiling.stage_timer("compute_flow") as tm:
            torch.ones(4).sum()
        with profiling.stage_timer("compute_flow"):
            pass
        rows = profiling.summary()
    finally:
        profiling.set_blocking(old)
        profiling.reset()
    assert set(rows) == {"compute_flow"} and rows["compute_flow"]["calls"] == 2
    assert rows["compute_flow"]["seconds"] >= tm.seconds > 0


def test_inpaint_node_ticks_every_stage_and_records_the_run(monkeypatch):
    ticks = []

    class Recorder:
        def __init__(self, video_length):
            self.video_length = video_length

        def __call__(self, stage, done, total):
            ticks.append((stage, done, total))

    monkeypatch.setattr(profiling, "NodeProgress", Recorder)
    frames, masks = synthetic_clip(t=6, h=48, w=64)
    node = ProPainterInpaint(device="cpu")
    node.propainter_inpainting(
        frames, masks, width=64, height=48, mask_dilates=2, flow_mask_dilates=2, ref_stride=3,
        neighbor_length=4, subvideo_length=80, raft_iter=1, fp16="disable", _allow_random_weights=True,
    )
    # the cached pipeline does not keep the node's progress bar
    assert not isinstance(node.last_pipeline.progress, Recorder)
    rec = metrics.last_run()
    assert rec["ok"] and rec["kind"] == "inpaint" and rec["video_length"] == 6
    stages = ("compute_flow", "complete_flow", "image_propagation", "feature_propagation")
    assert set(rec["stages"]) == set(stages)
    for stage in stages:
        mine = [(d, n) for s, d, n in ticks if s == stage]
        assert mine[0][0] == 0 and mine[-1][0] == mine[-1][1] > 0, (stage, mine)
        assert all(a[0] <= b[0] for a, b in zip(mine, mine[1:])), (stage, mine)
    assert np.isfinite(rec["seconds"])
