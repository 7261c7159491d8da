"""One run of one cell: set-up, the measured window, the traced clips,
the comparison. The cell, its configuration, its traffic mix, its
metrics and its limits are found by name from `BENCHMARK.json` and the
files under `benchmark/`; nothing here knows one by name.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
PACKAGE = "comfyui_propainter_nodes_tpu_torch"
# top-level module names no run may hold: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "comfyui_propainter_nodes_tpu")
CLIP_RANGE = "bench.clip"
PROFILED_CLIPS = 2
POOL = 4  # distinct clips made in set-up; the window cycles through them


class NoResult(Exception):
    """The run cannot give a result: it exits non-zero and prints none."""


def forbidden_modules(names) -> list:
    """The module names whose top-level name (before the first dot) is
    one of FORBIDDEN, compared whole."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def manifest(root: str = ROOT) -> dict:
    path = os.path.join(root, "BENCHMARK.json")
    if not os.path.exists(path):
        raise NoResult(f"no BENCHMARK.json at {root}")
    with open(path) as f:
        return json.load(f)


def cell_spec(man: dict, workload: str, root: str = ROOT) -> SimpleNamespace:
    """The cell's entry, its configuration (file read), its traffic mix,
    its limits and the metrics it reports, all found by name under the
    checkout `root`."""
    from . import traffic

    bench = os.path.join(root, "benchmark")

    cells = {w["name"]: w for w in man["workloads"]}
    if workload not in cells:
        raise NoResult(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf_entry = {c["name"]: c for c in man["configs"]}[cell["config"]]
    with open(os.path.join(root, conf_entry["file"])) as f:
        config = json.load(f)
    mix = traffic.load(os.path.join(bench, "traffic", cell["traffic"] + ".json"))

    def mine(m):
        return "workloads" not in m or workload in m["workloads"]

    return SimpleNamespace(
        name=workload, cell=cell, config=config, mix=mix,
        limits_path=os.path.join(bench, "limits", workload + ".json"),
        counts_path=os.path.join(bench, "counts", workload + ".json"),
        metrics_dir=os.path.join(bench, "metrics"),
        end_to_end=[m for m in man["end_to_end"] if mine(m)],
        per_layer=[m for m in man["per_layer"] if mine(m)],
    )


def reader(metric: str, metrics_dir: str = os.path.join(BENCH, "metrics")):
    """The `read(ctx)` function of `benchmark/metrics/<metric>.py`."""
    path = os.path.join(metrics_dir, metric + ".py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# the control of each configured precision: the reference one step below it
CONTROL = {"bf16": "fp8", "fp32": "tf32"}


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the program builds its kernels into build/kernels/ itself)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = os.path.join(ROOT, "build", sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def process_start() -> float:
    """The process's start on the `time.time()` clock (Linux /proc)."""
    with open("/proc/self/stat") as f:
        start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - uptime + start_ticks / os.sysconf("SC_CLK_TCK")


def widgets(spec) -> dict:
    return {**spec.config["widgets"], **spec.mix["widgets"]}


def call_node(node, kind: str, image, mask, w: dict):
    """One ComfyUI call of the cell's node; never downloads weights."""
    if kind == "inpaint":
        return node.propainter_inpainting(image, mask, _allow_random_weights=True, **w)
    if kind == "outpaint":
        return node.propainter_outpainting(image, _allow_random_weights=True, **w)
    raise NoResult(f"unknown node kind {kind!r}")


def shaped(kind: str, out, t: int, w: dict) -> bool:
    """Types, dtypes and shapes of a node's return values: the check each
    clip of the window gets, which reads no values."""
    import torch

    h, wd = w["height"] - w["height"] % 8, w["width"] - w["width"] % 8
    if kind == "outpaint":
        wd = int(w["width_scale"] * w["width"]) // 8 * 8
        h = int(w["height_scale"] * w["height"]) // 8 * 8
    img = out[0]
    if not (isinstance(img, torch.Tensor) and img.dtype == torch.float32 and tuple(img.shape) == (t, h, wd, 3)):
        return False
    masks = out[1:3] if kind == "inpaint" else out[1:2]
    return all(isinstance(m, torch.Tensor) and tuple(m.shape) == (t, h, wd) for m in masks)


def well_formed(kind: str, out, t: int, w: dict) -> bool:
    """`shaped`, and the values' ranges: IMAGE finite in 0..1, masks 0 or
    1. Read after the window, on the clips the comparison keeps."""
    import torch

    if not shaped(kind, out, t, w):
        return False
    lo, hi = torch.aminmax(out[0])  # NaN propagates and fails both tests
    if not (float(lo) >= 0.0 and float(hi) <= 1.0):
        return False
    masks = out[1:3] if kind == "inpaint" else out[1:2]
    return all(bool(((m == 0) | (m == 1)).all()) for m in masks)


class Sample:
    """A uniform sample of k of the window's clips, drawn from the seed as
    the clips come (reservoir sampling), so that the window holds k
    outputs and not all of them."""

    def __init__(self, seed: int, k: int):
        self.k, self.seen, self.kept = k, 0, {}
        self.rng = np.random.default_rng([int(seed) % (1 << 63), 11])

    def offer(self, index: int, out) -> None:
        if self.seen < self.k:
            self.kept[index] = out
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                del self.kept[sorted(self.kept)[j]]
                self.kept[index] = out
        self.seen += 1


def clear_program_caches() -> None:
    """Drop the program's cached pipelines and parameters, and give their
    memory back to the card."""
    import importlib

    import torch

    nodes = importlib.import_module(PACKAGE + ".nodes")
    zoo = importlib.import_module(PACKAGE + ".utils.weights")
    for cache in (nodes._PIPELINE_CACHE, nodes._PARAM_CACHE, zoo._PARAM_CACHE):
        cache.clear()
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def write_seed_weights(seed: int, dev, folder: str) -> None:
    """The seed's weights written into `folder` as the nodes' checkpoint
    caches, and the program pointed at them."""
    from . import weights as bench_weights

    bench_weights.write(bench_weights.draw(seed, dev), folder)
    os.environ["PROPAINTER_TPU_WEIGHTS"] = folder


def run(args, device=None, adjust=None, root=ROOT) -> tuple[dict, dict]:
    """One run; returns (result, checks). Raises NoResult where the run
    can give none. `device`, `adjust` (a function of the cell's spec) and
    `root` (a checkout's root) are for the harness's own tests, which run
    it on the CPU at a small size; the command line passes none."""
    t_start = process_start()
    set_cache_dirs()
    import torch

    if device is None and not torch.cuda.is_available():
        raise NoResult("no CUDA device: this benchmark measures the card and never falls back to the CPU")
    man = manifest(root)
    spec = cell_spec(man, args.workload, root)
    if adjust is not None:
        adjust(spec)
    if device is None and torch.cuda.device_count() < spec.cell["chips"]:
        raise NoResult(f"the cell asks for {spec.cell['chips']} cards, {torch.cuda.device_count()} found")
    from . import compare, traffic

    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    weights_dir = tempfile.mkdtemp(prefix="propainter-bench-weights-")
    try:
        return _run(args, spec, t_start, weights_dir, dev, torch, compare, traffic)
    finally:
        shutil.rmtree(weights_dir, ignore_errors=True)


def _run(args, spec, t_start, weights_dir, dev, torch, compare, traffic):
    write_seed_weights(args.seed, dev, weights_dir)
    import importlib

    nodes = importlib.import_module(PACKAGE + ".nodes")
    profiling = importlib.import_module(PACKAGE + ".utils.profiling")
    kind = spec.mix["node"]
    node = (nodes.ProPainterInpaint if kind == "inpaint" else nodes.ProPainterOutpaint)(device=dev)
    cuda = dev.type == "cuda"
    w = widgets(spec)
    t = spec.mix["frames"]

    def inputs(index):
        return traffic.inputs(spec.mix, w, args.seed, index)

    # the window's clips, made before it opens: clip i is pool[i % POOL]
    pool = [inputs(i) for i in range(POOL)]
    for index in (POOL, POOL + 1):  # warm-up: two more clips of the same shapes
        call_node(node, kind, *inputs(index), w)
    if cuda:
        torch.cuda.synchronize()
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    trace = bool(args.trace)
    profiling.set_blocking(trace)
    profiling.reset()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    gc.collect()
    setup_s = time.time() - t_start
    clips, failed = [], 0
    sample = Sample(args.seed, spec.mix["check_clips"])
    stages = {}  # the stage timers summed over the window (the node resets them each call)
    clip_stages = []  # the stage timers' sum of each clip (traced runs)
    w0 = time.perf_counter()
    while True:
        image, mask = pool[len(clips) % POOL]
        c0 = time.perf_counter()
        try:
            if trace:
                with torch.profiler.record_function(CLIP_RANGE):
                    out = call_node(node, kind, image, mask, w)
            else:
                out = call_node(node, kind, image, mask, w)
        except Exception as e:  # noqa: BLE001 - a clip that raises counts as failed
            print(f"clip {len(clips)} raised {type(e).__name__}: {e}", file=sys.stderr)
            out = None
        c1 = time.perf_counter()
        if trace:
            summary = profiling.summary()
            for name, row in summary.items():
                acc = stages.setdefault(name, {"seconds": 0.0, "calls": 0})
                acc["seconds"] += row["seconds"]
                acc["calls"] += row["calls"]
            clip_stages.append(sum(row["seconds"] for row in summary.values()))
        if out is None or not shaped(kind, out, t, w):
            failed += 1
        sample.offer(len(clips), out)
        clips.append((c0, c1))
        if c1 - w0 >= args.seconds:
            break
    window_s = clips[-1][1] - clips[0][0]
    window_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    profiling.set_blocking(False)
    found = forbidden_modules(sys.modules)
    if found:
        raise NoResult(f"the run holds modules of JAX or the JAX package: {found}")

    # the values of the clips the comparison keeps (every clip's shapes were checked in the window)
    kept = sample.kept
    failed += sum(1 for out in kept.values() if out is not None and shaped(kind, out, t, w)
                  and not well_formed(kind, out, t, w))
    walls = [c1 - c0 for c0, c1 in clips]
    result = {
        "correct": False, "attempted": len(clips), "failed": failed, "metrics": {},
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu", "count": 1,
                   "memory_peak_bytes": int(max(setup_peak, window_peak))},
    }
    e2e = {
        "frames_per_s": t * len(clips) / window_s,
        "clip_s_p90": float(np.percentile(walls, 90)),
        "peak_mem_gib": window_peak / 2**30,
        "setup_s": setup_s,
    }
    if not trace:
        for m in spec.end_to_end:
            if m["name"] in e2e:
                result["metrics"][m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        ctx = _profile(spec, node, kind, inputs, w, t, clips, window_s, stages, torch, dev)
        result["device"]["busy_s"] = ctx.busy_s
        result["device"]["window_s"] = ctx.span_s
        result["breakdown"] = {"device_ops": ctx.top_ops, "idle_gaps": ctx.idle_gaps}
        for m in spec.per_layer:
            value = reader(m["name"], spec.metrics_dir)(ctx)
            if value is not None:
                result["metrics"][m["name"]] = {"value": float(value), "unit": m["unit"]}
    print(f"window: {len(clips)} clips in {window_s:.4f} s, walls {[round(x, 4) for x in walls]}", file=sys.stderr)
    if clip_stages:
        host = [round(1e3 * (wall - st), 1) for wall, st in zip(walls, clip_stages)]
        print(f"window: node host ms a clip (wall less the blocking stage timers) {host}", file=sys.stderr)

    # the comparison, after the window: the program's state freed first
    picks = sorted(kept)
    del node
    clear_program_caches()
    limits = compare.load_limits(spec.limits_path)
    readings = []
    r0 = time.perf_counter()
    ref_params = reference_params(weights_dir, dev)
    for i in picks:
        if kept[i] is None:
            readings.append({n: float("inf") for n in compare.NAMES})  # a clip that raised
            continue
        ref = reference(kind, ref_params, *pool[i % POOL], w, dev)
        readings.append(compare.numbers(kind, kept[i], ref))
    print(f"reference: {len(picks)} clip(s) {picks} in {time.perf_counter() - r0:.2f} s", file=sys.stderr)
    ok, checks = compare.judge(readings, limits)
    result["correct"] = ok and failed == 0
    found = forbidden_modules(sys.modules)
    if found:
        raise NoResult(f"the run holds modules of JAX or the JAX package: {found}")
    return result, checks


def reference_params(weights_dir: str, dev):
    from ..reference import weights as ref_weights

    return ref_weights.load(weights_dir, dev)


def reference(kind: str, params, image, mask, w: dict, dev, precision: str = "fp32"):
    """The plain reference's outputs for one clip, on the card, float32
    with TF32 off; or a control: "tf32" (float32 convs and products on
    TF32, the control of a float32 configuration) or "fp8" (every
    product's operands and results in float8 e4m3, the control of a bf16
    one)."""
    import torch

    from ..reference import ops as ref_ops
    from ..reference import pipeline as ref_pipeline

    # cuDNN's heuristics pick FFT convolutions for some float32 shapes
    # (15 s a RAFT pair at 1280x720 on an H100); timing the algorithms picks GEMMs
    flags = torch.backends.cuda.matmul, torch.backends.cudnn
    old = flags[0].allow_tf32, flags[1].allow_tf32, flags[1].benchmark
    flags[0].allow_tf32 = flags[1].allow_tf32 = precision == "tf32"
    flags[1].benchmark = True
    try:
        with torch.inference_mode(), ref_ops.operand_precision("fp32" if precision == "tf32" else precision):
            if kind == "inpaint":
                return ref_pipeline.inpaint(params, image.to(dev), mask.to(dev), w)
            return ref_pipeline.outpaint(params, image.to(dev), w)
    finally:
        flags[0].allow_tf32, flags[1].allow_tf32, flags[1].benchmark = old


def _profile(spec, node, kind, inputs, w, t, clips, window_s, stages, torch, dev):
    """PROFILED_CLIPS more clips under torch.profiler with CUDA activity
    only (so the profiler adds little host time), each opened and closed
    by a one-element fill on the card that bounds its span; then one more
    clip with CPU activity too, whose host ranges name the idle gaps.
    Each trace is read back from TMPDIR and removed. Returns the context
    the per-layer readers take."""
    from torch.profiler import ProfilerActivity

    marker = torch.empty(1, device=dev)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]) as prof:
        for k in range(PROFILED_CLIPS):
            image, mask = inputs(POOL + 2 + k)
            marker.fill_(1.0)
            call_node(node, kind, image, mask, w)
            marker.fill_(2.0)
        torch.cuda.synchronize()
    tr = _read_trace(prof)
    lo, hi = tr.device[0][1], max(s + d for _, s, d, _ in tr.device)
    busy = tr.busy_us(lo, hi)
    if busy <= 0:
        raise NoResult("the profiler recorded no device operation")
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        image, mask = inputs(POOL + 2 + PROFILED_CLIPS)
        with torch.profiler.record_function(CLIP_RANGE):
            call_node(node, kind, image, mask, w)
        torch.cuda.synchronize()
    labelled = _read_trace(prof)
    glo, ghi = labelled.span(CLIP_RANGE)
    return SimpleNamespace(
        spec=spec, config=spec.config, mix=spec.mix, widgets=w, frames=t, kind=kind,
        clips=clips, window_s=window_s, stages=stages,
        trace=tr, lo=lo, hi=hi, profiled_clips=PROFILED_CLIPS,
        busy_s=busy / 1e6, span_s=(hi - lo) / 1e6,
        top_ops=tr.top_ops(lo, hi), idle_gaps=labelled.idle_gaps(glo, ghi),
        counts=json.load(open(spec.counts_path)) if os.path.exists(spec.counts_path) else None,
    )


def _read_trace(prof):
    from .trace import Trace

    fd, path = tempfile.mkstemp(prefix="propainter-bench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return Trace.from_chrome(path)
    finally:
        os.remove(path)
