"""The benchmark's harness on the CPU: the manifest, the traffic, the
yardstick's counts, the metric readers found by name, the result line,
the JAX import check, and a whole run at a small size with the program's
plain versions.

    python -m pytest benchmark/tests -q
"""

import json
import math
import os
import re
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import run as bench_run  # noqa: E402
from benchmark.core import roofline, session, trace, traffic  # noqa: E402
from benchmark.reference import ops as ref_ops  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def manifest():
    return session.manifest()


def small(spec):
    """The cell at a size a CPU test holds: 6 frames of 160x128, 2 RAFT
    iterations, windows of 5 frames."""
    spec.config = dict(spec.config, widgets=dict(spec.config["widgets"], width=160, height=128, raft_iter=2,
                                                 neighbor_length=4, ref_stride=2, fp16="disable"))
    spec.mix = dict(spec.mix, frames=6, margin_px=4)


# ------------------------------------------------------------- manifest


def test_manifest_names_units_and_files():
    man = manifest()
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert man["paths"] == ["benchmark"] and 1 <= man["run_seconds"] <= 51
    names = [c["name"] for c in man["configs"]] + [w["name"] for w in man["workloads"]]
    names += [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in man["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in man["end_to_end"]}
    e2e = {m["name"] for m in man["end_to_end"]}
    layers = set()
    for m in man["per_layer"]:
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        layers.add(m["layer"])
    for c in man["configs"]:
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(ROOT, c["file"]))
        assert c["reduced"] == []
    for w in man["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert os.path.exists(os.path.join(ROOT, "benchmark", "traffic", w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(ROOT, "benchmark", "limits", w["name"] + ".json"))
    assert len(json.dumps(man)) < 64 * 1024


@pytest.mark.parametrize("workload", [w["name"] for w in manifest()["workloads"]])
def test_every_metric_of_a_cell_is_found_by_name(workload):
    spec = session.cell_spec(manifest(), workload)
    assert {m["name"] for m in spec.end_to_end} >= {"setup_s"} and len(spec.end_to_end) >= 2
    assert spec.per_layer
    for m in spec.per_layer:
        assert callable(session.reader(m["name"], spec.metrics_dir))


def test_a_metric_is_added_by_new_files_only(tmp_path):
    """A dummy per-layer metric: a new reader file and a new entry in a
    copy of the manifest; no existing file changes."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    man = manifest()
    man["per_layer"].append({"name": "dummy_ms", "unit": "ms", "better": "lower", "source": "program_span",
                             "layer": "stages (pipeline/stages.py)", "moves": "frames_per_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    (tmp_path / "benchmark" / "metrics" / "dummy_ms.py").write_text("def read(ctx):\n    return 1.5 * len(ctx.clips)\n")
    before = {p: open(os.path.join(ROOT, "benchmark", p)).read() for p in ("core/session.py", "run.py")}
    spec = session.cell_spec(session.manifest(str(tmp_path)), man["workloads"][0]["name"], str(tmp_path))
    names = [m["name"] for m in spec.per_layer]
    assert names[-1] == "dummy_ms"
    ctx = types.SimpleNamespace(clips=[(0, 1), (1, 2)])
    assert session.reader("dummy_ms", spec.metrics_dir)(ctx) == 3.0
    assert before == {p: open(os.path.join(ROOT, "benchmark", p)).read() for p in before}


# --------------------------------------------------------------- traffic


@pytest.mark.parametrize("mix", ["object", "sides"])
def test_traffic_shapes_and_seeding(mix):
    m = traffic.load(os.path.join(ROOT, "benchmark", "traffic", mix + ".json"))
    f1, m1 = traffic.clip(m, 360, 640, 2**31 + 77, 3)
    f2, m2 = traffic.clip(m, 360, 640, 2**31 + 77, 3)
    f3, m3 = traffic.clip(m, 360, 640, 2**31 + 78, 3)
    assert f1.shape == (24, 360, 640, 3) and m1.shape == (24, 360, 640)
    assert f1.dtype == np.uint8 and m1.dtype == np.uint8
    np.testing.assert_array_equal(f1, f2)
    np.testing.assert_array_equal(m1, m2)
    assert not np.array_equal(m1, m3)
    # the same work for every seed: the box's size and the union of its path
    for seed in range(20):
        _, mk = traffic.clip(m, 360, 640, seed, 0)
        assert (mk[0] > 0).sum() == 60 * 80
        rows, cols = np.nonzero(mk.any(axis=0))
        assert rows.max() - rows.min() + 1 == 60 + 23 and cols.max() - cols.min() + 1 == 80 + 69
        assert rows.min() >= 16 and cols.min() >= 16 and rows.max() < 344 and cols.max() < 624
    image, mask = traffic.comfy_inputs(f1, m1)
    assert image.dtype == torch.float32 and image.shape == (24, 360, 640, 3) and float(image.max()) <= 1.0
    assert mask.shape == (24, 360, 640) and set(torch.unique(mask).tolist()) <= {0.0, 1.0}


def test_a_mix_may_hand_the_node_frames_at_another_size():
    m = dict(traffic.load(os.path.join(ROOT, "benchmark", "traffic", "object.json")), supplied_hw=[1080, 1920])
    assert traffic.size(m, {"height": 360, "width": 640}) == (1080, 1920)
    image, mask = traffic.inputs(dict(m, frames=2), {"height": 360, "width": 640}, 5, 0)
    assert image.shape == (2, 1080, 1920, 3) and mask.shape == (2, 1080, 1920)
    del m["supplied_hw"]
    assert traffic.size(m, {"height": 360, "width": 640}) == (360, 640)


def test_the_sample_is_uniform_and_drawn_from_the_seed():
    def draw(seed, n, k):
        s = session.Sample(seed, k)
        for i in range(n):
            s.offer(i, i)
        assert len(s.kept) == min(k, n) and all(s.kept[i] == i for i in s.kept)
        return sorted(s.kept)

    assert draw(2**31 + 9, 57, 2) == draw(2**31 + 9, 57, 2)
    assert draw(3, 1, 1) == [0]
    counts = np.bincount([draw(seed, 10, 1)[0] for seed in range(4000)], minlength=10)
    assert counts.min() > 320 and counts.max() < 480  # 400 each


def test_outputs_out_of_shape_or_range_are_not_well_formed():
    w = {"height": 16, "width": 24}
    img, m = torch.rand(3, 16, 24, 3), (torch.rand(3, 16, 24) > 0.5).float()
    assert session.shaped("inpaint", (img, m, m), 3, w) and session.well_formed("inpaint", (img, m, m), 3, w)
    assert not session.shaped("inpaint", (img[:2], m[:2], m[:2]), 3, w)
    assert not session.shaped("inpaint", (img.double(), m, m), 3, w)
    for bad in (img.clone().fill_(float("nan")), img + 0.5, img - 0.5):
        assert session.shaped("inpaint", (bad, m, m), 3, w) and not session.well_formed("inpaint", (bad, m, m), 3, w)
    assert not session.well_formed("inpaint", (img, m * 0.5, m), 3, w)


# --------------------------------------------------------- yardstick counts


def test_deform_bound_against_a_hand_count():
    # x [1, 90, 160, 128] bf16: 2 * 14400 * 9 * 128 * 128 = 4.247e9 operations
    # bytes: (14400 * 128 + 14400 * 16 * 27 + 14400 * 128) * 2 + (9 * 128 * 128 + 128) * 2
    ops = 2 * 14400 * 9 * 128 * 128
    nbytes = (14400 * 128 + 14400 * 432 + 14400 * 128) * 2 + (9 * 128 * 128 + 128) * 2
    assert roofline.deform_bound_s(1, 90, 160, 128, 128, "bf16") == pytest.approx(
        max(ops / 989e12, nbytes / 3.35e12), rel=1e-12)
    assert nbytes / 3.35e12 > ops / 989e12  # bound by bytes in bf16
    assert roofline.deform_bound_s(1, 90, 160, 128, 128, "fp32") == pytest.approx(ops / 67e12, rel=1e-12)


def test_flop_counter_against_hand_counts():
    from torch.utils.flop_counter import FlopCounterMode

    x = torch.randn(2, 12, 16, 8)
    w = torch.randn(4, 8, 3, 3)
    with FlopCounterMode(display=False) as fc:
        ref_ops.conv2d(x, w, padding=(1, 1))
    assert fc.get_total_flops() == 2 * (2 * 12 * 16) * 4 * 8 * 9
    with FlopCounterMode(display=False) as fc:
        ref_ops.matmul(torch.randn(5, 7), torch.randn(7, 3))
    assert fc.get_total_flops() == 2 * 5 * 7 * 3


@pytest.mark.parametrize("workload", [w["name"] for w in manifest()["workloads"]])
def test_deform_roofline_bound_counts_the_models_alignments(workload):
    spec = session.cell_spec(manifest(), workload)
    reader = session.reader("deform_conv_roofline", spec.metrics_dir)
    mod = types.SimpleNamespace(**reader.__globals__)
    ctx = types.SimpleNamespace(widgets=session.widgets(spec), frames=24, kind=spec.mix["node"], config=spec.config)
    h, w = mod.canvas_hw(ctx)
    # flow completion: 2 directions x 2 modules x 22 alignments; windows at
    # frames 0, 5, ..., 20 with 6, 11, 11, 11, 9 local frames: 2 x 43
    dt = spec.config["precision"]
    expect = 88 * roofline.deform_bound_s(1, h // 8, w // 8, 256, 128, dt)
    expect += 86 * roofline.deform_bound_s(1, h // 4, w // 4, 128, 128, dt)
    assert mod.bound_s(ctx) == pytest.approx(expect, rel=1e-12)


def test_trace_reduction_union_and_gaps(tmp_path):
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "bench.clip", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "compute_flow", "ts": 10, "dur": 40},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 5, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 12, "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 60, "dur": 5},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "compute_flow", "ts": 10, "dur": 40},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    tr = trace.Trace.from_chrome(str(path))
    lo, hi = tr.span("bench.clip")
    assert (lo, hi) == (0, 100)
    assert tr.busy_us(lo, hi) == 22  # [5, 22) and [60, 65)
    gaps = tr.idle_gaps(lo, hi)
    assert [g[0] for g in gaps] == ["compute_flow", "bench.clip", "bench.clip"]  # [22, 60), [65, 100), [0, 5)
    assert [g[1] for g in gaps] == pytest.approx([38e-6, 35e-6, 5e-6])
    assert tr.top_ops(lo, hi)[0] == ["k1", 10e-6]


# ------------------------------------------------------------ the result


def test_last_line_keys_from_a_fake_run(capsys):
    result = {"correct": True, "attempted": 3, "failed": 0,
              "metrics": {"frames_per_s": {"value": 40.1, "unit": "frames/s"}},
              "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1, "memory_peak_bytes": 5}}
    checks = {"share_off3": {"value": 0.001, "limit": 0.01}}
    line = bench_run.last_line(result, checks)
    err = capsys.readouterr().err.strip().splitlines()
    assert err[-1] == "check share_off3: 0.001 (limit 0.01)"
    obj = json.loads(line)
    assert list(obj)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(obj)
    assert obj["device"]["kind"] == "NVIDIA H100 80GB HBM3"


def test_jax_import_check_compares_whole_top_level_names():
    assert session.forbidden_modules(["comfyui_propainter_nodes_tpu_torch", "comfyui_propainter_nodes_tpu_torch.nodes",
                                      "jaxtyping", "numpy"]) == []
    assert session.forbidden_modules(["comfyui_propainter_nodes_tpu", "jax", "jax.numpy", "jaxlib", "flax.linen"]) == [
        "comfyui_propainter_nodes_tpu", "flax.linen", "jax", "jax.numpy", "jaxlib"]


def test_the_harness_and_the_port_import_no_jax():
    """In a fresh interpreter: the harness, the reference and the port's
    nodes load, and no module of JAX or the JAX package comes with them."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark.core import session, compare, trace, traffic, weights\n"
            "from benchmark.reference import pipeline\n"
            "import comfyui_propainter_nodes_tpu_torch.nodes\n"
            "print(session.forbidden_modules(sys.modules))\n") % ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True, cwd=ROOT)
    assert out.stdout.strip() == "[]"


def test_the_reference_imports_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark.reference import pipeline, weights, ops\n"
            "print(sorted(n for n in sys.modules if n.split('.')[0].startswith('comfyui_propainter')))\n") % ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True, cwd=ROOT)
    assert out.stdout.strip() == "[]"
    for name in os.listdir(os.path.join(ROOT, "benchmark", "reference")):
        if name.endswith(".py"):
            src = open(os.path.join(ROOT, "benchmark", "reference", name)).read()
            assert "comfyui_propainter" not in src and "import jax" not in src, name


def test_without_a_card_the_run_prints_no_result(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = bench_run.main(["--workload", manifest()["workloads"][0]["name"], "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "no CUDA device" in out.err


# ------------------------------------------------------------- a CPU run


def test_a_mix_of_another_kind_is_added_by_new_files_only(tmp_path):
    """A cell whose clips come at another size than the widgets', which the
    node resizes on the host: a new traffic file, a new limits file and a
    new entry in a copy of the manifest, then a whole small run from that
    copy, correct against the reference's own resize."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    man = manifest()
    cell = dict(man["workloads"][0], name="inpaint-small.resized", traffic="resized")
    man["workloads"].append(cell)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    mix = dict(traffic.load(os.path.join(ROOT, "benchmark", "traffic", man["workloads"][0]["traffic"] + ".json")),
               supplied_hw=[200, 248])
    (tmp_path / "benchmark" / "traffic" / "resized.json").write_text(json.dumps(mix))
    shutil.copy(os.path.join(ROOT, "benchmark", "limits", man["workloads"][0]["name"] + ".json"),
                tmp_path / "benchmark" / "limits" / "inpaint-small.resized.json")
    before = {p: open(os.path.join(ROOT, "benchmark", p)).read() for p in ("core/session.py", "core/traffic.py")}
    args = types.SimpleNamespace(workload=cell["name"], seed=2**31 + 4322, seconds=0.1, trace=0)
    result, checks = session.run(args, device="cpu", adjust=small, root=str(tmp_path))
    assert result["correct"] and result["failed"] == 0, checks
    assert checks["masks_mismatch"]["value"] == 0
    assert before == {p: open(os.path.join(ROOT, "benchmark", p)).read() for p in before}


@pytest.mark.parametrize("workload", ["inpaint-360p-fp32.object", "outpaint-360p.sides"])
def test_a_whole_run_at_a_small_size_on_the_cpu(workload):
    args = types.SimpleNamespace(workload=workload, seed=2**31 + 4321, seconds=0.1, trace=0)
    result, checks = session.run(args, device="cpu", adjust=small)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] == 1
    assert set(result["metrics"]) == {"frames_per_s", "clip_s_p90", "peak_mem_gib", "setup_s"}
    assert all(math.isfinite(m["value"]) for m in result["metrics"].values())
    assert {"masks_mismatch", "outside_max"} < set(checks) <= {"masks_mismatch", "outside_max", "share_off3", "mean_levels"}
    assert checks["masks_mismatch"]["value"] == 0 and checks["outside_max"]["value"] == 0
