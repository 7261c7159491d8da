"""The `program_span` readers of the program's span record
(benchmark/core/spans.py; metrics node_ms.prepare, node_ms.finish,
raft_ms.encode, raft_ms.refine, feature_ms.transformer) on tiny CPU
node calls in blocking mode, with the window's clips on the host clock
as the session takes them.

    python -m pytest benchmark/tests/test_bench_spans.py -q
"""

import collections
import os
import sys
import time
import types

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.core import session, spans, traffic  # noqa: E402
from comfyui_propainter_nodes_tpu_torch import nodes  # noqa: E402
from comfyui_propainter_nodes_tpu_torch.utils import profiling  # noqa: E402

METRICS = {"node_ms.prepare": "node.prepare", "node_ms.finish": "node.finish", "raft_ms.encode": "raft.encode",
           "raft_ms.refine": "raft.refine", "feature_ms.transformer": "feature.transformer"}
WIDGETS = dict(width=64, height=48, mask_dilates=2, flow_mask_dilates=2, ref_stride=3, neighbor_length=4,
               subvideo_length=80, raft_iter=1, fp16="disable")
CELLS = {"inpaint": ("object", {}), "outpaint": ("sides", {"width_scale": 1.25, "height_scale": 1.0})}
CLIPS = 2


@pytest.fixture(scope="module")
def windows():
    """A window of CLIPS clips for each node, one after the other in one
    ring, blocking as in a traced run: {kind: ctx}."""
    torch.set_num_threads(1)
    old = profiling.blocking()
    profiling.reset()
    profiling.set_blocking(True)
    ctxs = {}
    try:
        for kind, (mix_name, extra) in CELLS.items():
            mix = dict(traffic.load(os.path.join(ROOT, "benchmark", "traffic", mix_name + ".json")),
                       frames=6, margin_px=4)
            w = dict(WIDGETS, **extra)
            node = (nodes.ProPainterInpaint if kind == "inpaint" else nodes.ProPainterOutpaint)(device="cpu")
            clips = []
            for i in range(CLIPS):
                image, mask = traffic.inputs(mix, w, 2**31 + 99, i)
                c0 = time.perf_counter()
                session.call_node(node, kind, image, mask, w)
                clips.append((c0, time.perf_counter()))
            ctxs[kind] = types.SimpleNamespace(clips=clips)
    finally:
        profiling.set_blocking(old)
    yield ctxs
    profiling.reset()


def read_all(ctx):
    return {m: session.reader(m)(ctx) for m in METRICS}


@pytest.fixture
def ring_copy(monkeypatch):
    """The ring as the window left it, in a copy the test may add to."""
    monkeypatch.setattr(profiling, "_RING", collections.deque(profiling.spans(), maxlen=profiling.RING_CAPACITY))
    monkeypatch.setattr(profiling, "_DROPPED", list(profiling.dropped()))


@pytest.mark.parametrize("kind", list(CELLS))
def test_each_reader_reads_its_spans_in_the_window(windows, kind):
    """Positive and no more than a clip's wall; the exact sum of the
    window's spans of its name over the clips."""
    ctx = windows[kind]
    lo, hi = ctx.clips[0][0] * 1e9, ctx.clips[-1][1] * 1e9
    wall_ms = max(c1 - c0 for c0, c1 in ctx.clips) * 1e3
    for metric, value in read_all(ctx).items():
        assert value is not None and 0 < value <= wall_ms, (metric, value, wall_ms)
        mine = [r.end_ns - r.start_ns for r in profiling.spans() if r.name == METRICS[metric] and lo <= r.start_ns <= hi]
        assert value == pytest.approx(sum(mine) / 1e6 / CLIPS, rel=1e-12)
    readings = read_all(ctx)
    assert readings["raft_ms.encode"] + readings["raft_ms.refine"] < wall_ms


def test_a_span_outside_the_window_is_not_counted(windows, ring_copy):
    """The outpaint window's spans lie after the inpaint window's, and
    spans of every name opened now lie after both."""
    before = {kind: read_all(ctx) for kind, ctx in windows.items()}
    for name in METRICS.values():
        with profiling.span(name):
            time.sleep(0.01)
    assert {kind: read_all(ctx) for kind, ctx in windows.items()} == before


def test_a_ring_that_dropped_records_in_the_window_reads_none(windows, ring_copy):
    for _ in range(profiling.RING_CAPACITY):
        with profiling.span("later"):
            pass
    assert profiling.dropped()[0] > 0
    for ctx in windows.values():
        assert read_all(ctx) == {m: None for m in METRICS}


def test_records_dropped_before_the_window_still_read(windows, ring_copy):
    profiling._DROPPED[:] = [3, round(windows["inpaint"].clips[0][0] * 1e9) - 1]
    assert all(v is not None for v in read_all(windows["inpaint"]).values())


def test_a_program_without_the_span_record_reads_none(windows, monkeypatch):
    """The parent's program: `spans` missing, every reader None, no raise;
    and a window without clips."""
    assert spans.ms_per_clip(types.SimpleNamespace(clips=[]), "node.prepare") is None
    monkeypatch.delattr(profiling, "spans")
    assert read_all(windows["inpaint"]) == {m: None for m in METRICS}
