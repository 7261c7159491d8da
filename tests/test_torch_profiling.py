"""The port's span record, stage timers, counters, progress sink and run
records (`utils/profiling.py`, `utils/metrics.py`), against the JAX
package's record where they share a contract, and both nodes wrapped in
them."""

import json
import sys
import time
import types

import numpy as np
import pytest
import torch

from comfyui_propainter_nodes_tpu.config import PipelineConfig as JaxConfig
from comfyui_propainter_nodes_tpu.utils import metrics as jax_metrics
from comfyui_propainter_nodes_tpu_torch.config import PipelineConfig
from comfyui_propainter_nodes_tpu_torch.nodes import ProPainterInpaint, ProPainterOutpaint
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


# ------------------------------------------------- the span record


NODE_KW = dict(width=64, height=48, mask_dilates=2, flow_mask_dilates=2, ref_stride=3, neighbor_length=4,
               subvideo_length=80, raft_iter=1, fp16="disable", _allow_random_weights=True)
STAGES = ("compute_flow", "complete_flow", "image_propagation", "feature_propagation")
# each span's parent in a node call (the root's is None); a stage's parent is the root
PARENTS = {
    "node.prepare": "root", "node.to_bytes": "node.prepare", "node.resize": "node.prepare",
    "node.crop_plan": "node.prepare", "node.upload": "node.prepare",
    "raft.encode": "compute_flow", "raft.refine": "compute_flow",
    "feature.encode": "feature_propagation", "feature.propagate": "feature_propagation",
    "feature.transformer": "feature_propagation", "feature.decode": "feature_propagation",
    "node.finish": "root", "node.fetch": "node.finish", "node.paste": "node.finish",
    **{s: "root" for s in STAGES},
}


@pytest.fixture(scope="module")
def node_calls():
    """One 6-frame 48x64 CPU call of each node: its spans, stage table,
    counters and run record."""
    frames, masks = synthetic_clip(t=6, h=48, w=64)
    calls = {}
    for kind in ("inpaint", "outpaint"):
        profiling.reset()
        if kind == "inpaint":
            ProPainterInpaint(device="cpu").propainter_inpainting(frames, masks, **NODE_KW)
        else:
            ProPainterOutpaint(device="cpu").propainter_outpainting(
                frames, width_scale=1.25, height_scale=1.0, **NODE_KW)
        calls[kind] = dict(spans=profiling.spans(), summary=profiling.summary(), counters=profiling.counters(),
                           record=metrics.last_run(), dropped=profiling.dropped())
    profiling.reset()
    return calls


@pytest.mark.parametrize("kind", ["inpaint", "outpaint"])
def test_node_call_span_tree(node_calls, kind):
    """One root, every span under the parent it names, inside its parent's
    times; the node's phases once, RAFT's two spans a call, the feature
    stage's four once each on this clip."""
    recs = node_calls[kind]["spans"]
    assert node_calls[kind]["dropped"] == (0, 0)
    by_id = {r.id: r for r in recs}
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == [f"node.{kind}"]
    expect = {k: v for k, v in PARENTS.items() if kind == "inpaint" or k != "node.crop_plan"}
    for r in recs:
        if r.parent is None:
            continue
        parent = by_id[r.parent]
        assert expect[r.name] == ("root" if parent.parent is None else parent.name), r
        assert parent.start_ns <= r.start_ns <= r.end_ns <= parent.end_ns, (r, parent)
    names = [r.name for r in recs]
    assert set(names) == set(expect) | {f"node.{kind}"}
    for name in expect:
        if not name.startswith("raft."):
            assert names.count(name) == 1, name
    assert names.count("raft.encode") == names.count("raft.refine") >= 1


@pytest.mark.parametrize("kind", ["inpaint", "outpaint"])
def test_node_call_summary_is_the_stage_rows_only(node_calls, kind):
    summary = node_calls[kind]["summary"]
    assert tuple(sorted(summary)) == tuple(sorted(STAGES))
    assert all(row["calls"] == 1 and row["seconds"] > 0 for row in summary.values())


@pytest.mark.parametrize("kind", ["inpaint", "outpaint"])
def test_run_record_covers_the_whole_node_call(node_calls, kind):
    """The record's seconds (rounded to 0.1 ms) hold node.prepare, the
    stages and node.finish, and its stages are the stage table."""
    call = node_calls[kind]
    rec = call["record"]
    took = {r.name: (r.end_ns - r.start_ns) * 1e-9 for r in call["spans"]}
    inside = took["node.prepare"] + sum(took[s] for s in STAGES) + took["node.finish"]
    assert rec["ok"] and rec["kind"] == kind and rec["video_length"] == 6
    assert rec["seconds"] + 5e-5 >= inside
    assert rec["stages"] == call["summary"]


@pytest.mark.parametrize("kind", ["inpaint", "outpaint"])
def test_a_cpu_node_call_launches_no_kernel(node_calls, kind):
    """The plain versions run on the host: no launch counter moves. The
    plan's counter does, as on the card: one RAFT form a call."""
    counters = node_calls[kind]["counters"]
    forms = {k: v for k, v in counters.items() if k.startswith("raft_form/")}
    assert forms == {"raft_form/one call": 1}
    assert all(v == 0 for k, v in counters.items() if k not in forms)


@pytest.mark.parametrize("blocking", [False, True])
def test_span_synchronises_only_in_blocking_mode(monkeypatch, blocking):
    syncs = []
    monkeypatch.setattr(profiling, "_sync", lambda: syncs.append(1))
    monkeypatch.setattr(profiling, "_BLOCKING", blocking)
    profiling.reset()
    with profiling.span("outer") as outer:
        with profiling.span("inner"):
            pass
        with profiling.kernel("k"):
            pass
    assert len(syncs) == (4 if blocking else 0)  # two a span, none a kernel launch
    recs = profiling.spans()
    assert [r.name for r in recs] == ["inner", "outer"]
    assert recs[0].parent == recs[1].id and recs[1].parent is None
    assert outer.seconds == (recs[1].end_ns - recs[1].start_ns) * 1e-9
    assert profiling.summary() == {} and profiling.counters() == {"k": 1}
    profiling.reset()


def test_kernel_counts_a_launch_that_ends_without_an_error():
    profiling.reset()
    with profiling.kernel("deform_conv"):
        pass
    with pytest.raises(RuntimeError):
        with profiling.kernel("deform_conv"):
            raise RuntimeError("the launch failed")
    profiling.count("deform_conv/1x8x8x16", 2)
    assert profiling.counters() == {"deform_conv": 1, "deform_conv/1x8x8x16": 2}
    assert profiling.spans() == []
    profiling.reset()
    assert profiling.counters() == {}


def test_a_span_that_raises_is_recorded_and_leaves_the_tree_whole():
    profiling.reset()
    with pytest.raises(ValueError):
        with profiling.stage_timer("compute_flow"):
            with profiling.span("raft.encode"):
                raise ValueError("bad input")
    with profiling.span("after"):
        pass
    recs = profiling.spans()
    assert [r.name for r in recs] == ["raft.encode", "compute_flow", "after"]
    assert recs[0].parent == recs[1].id and recs[2].parent is None
    assert profiling.summary() == {}  # a stage that raised adds no row
    profiling.reset()


def test_ring_is_bounded_and_counts_what_it_drops():
    profiling.reset()
    extra = 10
    for i in range(profiling.RING_CAPACITY + extra):
        with profiling.span(f"s{i}" if i < extra else "s"):
            pass
    recs = profiling.spans()
    n, end = profiling.dropped()
    assert len(recs) == profiling.RING_CAPACITY and n == extra
    assert recs[0].name == "s" and end <= recs[0].start_ns
    profiling.reset()
    assert profiling.spans() == [] and profiling.dropped() == (0, 0)


def test_run_recorder_restarts_the_stage_table_only():
    profiling.reset()
    with profiling.stage_timer("compute_flow"):
        pass
    profiling.count("corr_lookup")
    with metrics.RunRecorder("inpaint", PipelineConfig(), 2):
        with profiling.stage_timer("feature_propagation"):
            pass
    assert set(metrics.last_run()["stages"]) == {"feature_propagation"}
    assert [r.name for r in profiling.spans()] == ["compute_flow", "feature_propagation"]
    assert profiling.counters() == {"corr_lookup": 1}
    profiling.reset()


def test_trace_us_puts_spans_on_the_profilers_clock(tmp_path):
    """Every span's mapped start and end within 0.5 ms of its range in a
    CPU torch.profiler trace (`ts` + `baseTimeNanoseconds`); a kernel
    launch's range is "kernel.<name>"."""
    from torch.profiler import ProfilerActivity, profile

    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(3):
            with profiling.span("node.prepare"):
                with profiling.span("node.upload"):
                    torch.ones(64).sum()
                    with profiling.kernel("deform_conv"):
                        pass
            with profiling.stage_timer("compute_flow"):
                time.sleep(0.002)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base_us = trace.get("baseTimeNanoseconds", 0) / 1e3
    ranges = {}
    for e in trace["traceEvents"]:
        if e.get("cat") == "user_annotation":
            ranges.setdefault(e["name"], []).append((e["ts"] + base_us, e["ts"] + e["dur"] + base_us))
    assert len(ranges.get("kernel.deform_conv", [])) == 3
    recs = profiling.spans()
    assert len(recs) == 9
    for name in ("node.prepare", "node.upload", "compute_flow"):
        mine = sorted((profiling.trace_us(r.start_ns), profiling.trace_us(r.end_ns)) for r in recs if r.name == name)
        theirs = sorted(ranges[name])
        assert len(mine) == len(theirs) == 3
        for (s, e), (ts, te) in zip(mine, theirs):
            assert abs(s - ts) < 500 and abs(e - te) < 500, (name, s - ts, e - te)
    profiling.reset()
