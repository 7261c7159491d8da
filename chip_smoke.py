"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises; the exit code is then nonzero):
  1. build the CUDA kernels (csrc/*.cu, sm_90a) and print the build time;
  2. hold each kernel against its plain PyTorch version at the main-path
     shapes of a 24-frame 640x360 node run, in fp32 (TF32 off) and bf16,
     and time kernel, plain version and, where one exists, the one
     PyTorch call that computes the same function;
  3. run ProPainterInpaint(device="cuda") on a synthetic 24-frame 640x360
     clip at default widgets with seeded random weights (a warm-up run,
     then a timed run with the launch counters reset just before it), and
     check the output; then check the card against the host on a small
     clip;
  4. print the card's name and power limit, a `kernels` JSON line, and
     the result JSON as the last line.
Needs a CUDA card; exits nonzero without one.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # bf16 dense, fp32 non-tensor


def log(*a):
    print(*a, flush=True)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of one call, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def require(cond, msg) -> None:
    """A check that stays under `python -O`."""
    if not cond:
        raise RuntimeError(str(msg))


def rel_err(out, ref) -> tuple[float, float]:
    d = (out.float() - ref.float()).abs().max().item()
    return d, d / max(1e-6, ref.float().abs().max().item())


# ------------------------------------------------------------------ phase 2


def check_corr_lookup(dt, gen):
    from comfyui_propainter_nodes_tpu_torch.models.raft import build_corr_pyramids
    from comfyui_propainter_nodes_tpu_torch.ops.cuda import corr_lookup as mod

    im, h8, w8, c = 23, 45, 80, 256
    f1 = torch.randn(im, h8, w8, c, generator=gen, device="cuda").to(dt)
    f2 = torch.randn(im, h8, w8, c, generator=gen, device="cuda").to(dt)
    pyr, _ = build_corr_pyramids(f1, f2)
    yy, xx = torch.meshgrid(
        torch.arange(h8, device="cuda", dtype=torch.float32),
        torch.arange(w8, device="cuda", dtype=torch.float32), indexing="ij",
    )
    flow = torch.randn(im, h8, w8, 2, generator=gen, device="cuda") * 6.0
    coords = (torch.stack([xx, yy], -1)[None] + flow).contiguous()
    out = mod.corr_lookup(pyr, coords)
    torch.cuda.synchronize()
    ref = mod.corr_lookup_plain(pyr, coords)
    err, rel = rel_err(out, ref)
    tol = 1e-5 if dt == torch.float32 else 1e-3  # same fp32 taps; bf16 maps
    log(f"  B1 corr_lookup {str(dt)[6:]}: max_abs_err {err:.3e} rel {rel:.3e} (tol rel {tol})")
    require(rel <= tol, "corr_lookup disagrees with its plain version")
    ms = time_ms(lambda: mod.corr_lookup(pyr, coords))
    plain_ms = time_ms(lambda: mod.corr_lookup_plain(pyr, coords), reps=5, warmup=1)
    # bytes this data needs: in-range part of each 10x10 window, coords, output
    esz = pyr[0].element_size()
    need = 0
    for lvl, m in enumerate(pyr):
        cl = coords / 2**lvl
        x0 = torch.floor(cl[..., 0]) - 4
        y0 = torch.floor(cl[..., 1]) - 4
        cols = ((x0 + 10).clamp(max=m.shape[2]) - x0.clamp(min=0)).clamp(min=0)
        rows = ((y0 + 10).clamp(max=m.shape[1]) - y0.clamp(min=0)).clamp(min=0)
        need += float((rows * cols).sum()) * esz
    n_pix = im * h8 * w8
    nbytes = need + n_pix * 8 + n_pix * 324 * 4
    flops = n_pix * 324 * 6
    bound = max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[torch.float32]) * 1e3
    log(f"    ms {ms:.4f}  plain_ms {plain_ms:.4f}  bound_ms {bound:.4f} (bytes)  library_ms null")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by="bytes", library_ms=None)


def check_deform_conv(dt, gen, shape):
    from comfyui_propainter_nodes_tpu_torch.ops.cuda import deform_conv as mod

    n, h, w, cin = shape
    g, cout = 16, 128
    x = torch.randn(n, h, w, cin, generator=gen, device="cuda").to(dt)
    off = (torch.randn(n, h, w, g, 9, 2, generator=gen, device="cuda") * 3.0).to(dt)
    mask = torch.rand(n, h, w, g, 9, generator=gen, device="cuda").to(dt)
    wt = (torch.randn(cout, cin, 3, 3, generator=gen, device="cuda") / math.sqrt(9 * cin)).to(dt)
    bias = (torch.randn(cout, generator=gen, device="cuda") * 0.05).to(dt)
    out = mod.deform_conv2d(x, off, mask, wt, bias)
    torch.cuda.synchronize()
    ref = mod.deform_conv2d_plain(x, off, mask, wt, bias)
    err, rel = rel_err(out, ref)
    tol = 1e-4 if dt == torch.float32 else 1e-2  # 9*Cin-term fp32 sums; bf16 output rounding
    log(f"  B2 deform_conv {str(dt)[6:]} x{list(shape)}: max_abs_err {err:.3e} rel {rel:.3e} (tol rel {tol})")
    require(rel <= tol, "deform_conv2d disagrees with its plain version")
    ms = time_ms(lambda: mod.deform_conv2d(x, off, mask, wt, bias))
    plain_ms = time_ms(lambda: mod.deform_conv2d_plain(x, off, mask, wt, bias), reps=5, warmup=1)
    m = n * h * w
    flops = 2.0 * m * 9 * cin * cout
    esz = x.element_size()
    nbytes = (m * cin + m * g * 27 + m * cout) * esz + 9 * cin * cout * esz + cout * esz
    t_ops, t_bytes = flops / PEAK_FLOPS[dt], nbytes / HBM_BYTES_PER_S
    bound = max(t_ops, t_bytes) * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    log(f"    ms {ms:.4f}  plain_ms {plain_ms:.4f}  bound_ms {bound:.4f} ({by})  library_ms null")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=None)


def check_window_attention(dt, gen, t_sel, occ):
    from comfyui_propainter_nodes_tpu_torch.ops.cuda import window_attention as mod

    b, n_win, nh, t, wsz, ch = 5, 36, 4, 13, 45, 128
    rl, pl_len = t_sel * 148, t_sel * 91
    nw = b * n_win

    def rnd(*s):
        return torch.randn(*s, generator=gen, device="cuda").to(dt)

    q, k, v = rnd(nw, nh, t, wsz, ch), rnd(nw, nh, t, wsz, ch), rnd(nw, nh, t, wsz, ch)
    rk, rv = rnd(nw, nh, rl, ch), rnd(nw, nh, rl, ch)
    pk, pv = rnd(b, nh, pl_len, ch), rnd(b, nh, pl_len, ch)
    # t_ind frames (every other one) and one padded ref frame in batch row 1
    tv = torch.ones(b, t, dtype=torch.bool, device="cuda")
    tv[1, -1] = False
    in_tind = (torch.arange(t, device="cuda") % 2) == (0 if t_sel == 7 else 1)
    bias_w = torch.where(in_tind[None] & tv, 0.0, -1e9).repeat_interleave(wsz, 1).float().contiguous()
    sel = tv[:, in_tind]
    bias_r = torch.where(sel, 0.0, -1e9).repeat_interleave(148, 1).float().contiguous()
    bias_p = torch.where(sel, 0.0, -1e9).repeat_interleave(91, 1).float().contiguous()
    args = (q, k, v, rk, rv, pk, pv, occ, bias_w, bias_r, bias_p)
    out = mod.window_attention(*args, n_win_per_b=n_win)
    torch.cuda.synchronize()
    ref = mod.window_attention_plain(*args, n_win)
    err, rel = rel_err(out, ref)
    tol = 1e-4 if dt == torch.float32 else 2e-2  # softmax over ~2k keys; bf16 output rounding
    n_occ = int(occ.sum())
    log(f"  B3 window_attention {str(dt)[6:]} t_sel={t_sel}: occupied {n_occ}/{nw}; "
        f"max_abs_err {err:.3e} rel {rel:.3e} (tol rel {tol})")
    require(rel <= tol, "window_attention disagrees with its plain version")
    ms = time_ms(lambda: mod.window_attention(*args, n_win_per_b=n_win))
    plain_ms = time_ms(lambda: mod.window_attention_plain(*args, n_win), reps=3, warmup=1)

    # the same function as ONE library call: SDPA over [window|rolled|pooled]
    # keys with an additive mask (block-diagonal per frame for clean windows)
    qt = t * wsz
    k_all = torch.cat([k.reshape(nw, nh, qt, ch), rk, pk.repeat_interleave(n_win, 0)], 2)
    v_all = torch.cat([v.reshape(nw, nh, qt, ch), rv, pv.repeat_interleave(n_win, 0)], 2)
    bias = torch.cat([bias_w, bias_r, bias_p], 1).repeat_interleave(n_win, 0)  # [W, L]
    fid = torch.arange(qt, device="cuda") // wsz
    clean = torch.full((qt, k_all.shape[2]), -1e9, device="cuda")
    clean[:, :qt] = torch.where(fid[:, None] == fid[None, :], 0.0, -1e9)
    amask = torch.where(occ[:, None, None], bias[:, None, :], clean[None]).to(dt)[:, None]
    qs = q.reshape(nw, nh, qt, ch)
    lib = torch.nn.functional.scaled_dot_product_attention(qs, k_all, v_all, attn_mask=amask)
    lib_err, _ = rel_err(lib.reshape(out.shape), ref)
    library_ms = time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(qs, k_all, v_all, attn_mask=amask),
        reps=5, warmup=1,
    )
    flops = nh * (n_occ * 4.0 * qt * (qt + rl + pl_len) * ch + (nw - n_occ) * 4.0 * qt * wsz * ch)
    esz = q.element_size()
    occ_rows = int(occ.reshape(b, n_win).any(1).sum())
    nbytes = esz * ch * nh * (nw * qt * 4 + n_occ * rl * 2 + occ_rows * pl_len * 2) + 4 * b * (qt + rl + pl_len)
    t_ops, t_bytes = flops / PEAK_FLOPS[dt], nbytes / HBM_BYTES_PER_S
    bound = max(t_ops, t_bytes) * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    log(f"    ms {ms:.4f}  plain_ms {plain_ms:.4f}  bound_ms {bound:.4f} ({by})  "
        f"library_ms {library_ms:.4f} (SDPA, err vs plain {lib_err:.3e})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=library_ms, occupied_share=n_occ / nw)


def main_path_occupancy():
    """Which of the 5 x 36 token windows of the node run below are occupied:
    the clip's dilated masks at 1/4 res, pooled 7x7/3 to the 30x54 token
    grid, any touch in a window's local frames (ops/attention.py)."""
    from comfyui_propainter_nodes_tpu_torch.config import PipelineConfig
    from comfyui_propainter_nodes_tpu_torch.models import propainter as pp
    from comfyui_propainter_nodes_tpu_torch.ops.dilation import binary_dilation
    from comfyui_propainter_nodes_tpu_torch.ops.pool import max_pool2d
    from comfyui_propainter_nodes_tpu_torch.pipeline.stages import _window_tables

    t, h, w = 24, 360, 640
    _, masks = synthetic_clip(t, h, w)
    md = binary_dilation(torch.from_numpy(masks != 0).float().cuda(), WIDGETS["mask_dilates"])
    pool = pp.attention_pool_mask(pp.downsample_mask(md[None, ..., None], h // 4, w // 4))[0]
    sels, valids, _, _, _, _, l_t_max, _ = _window_tables(PipelineConfig(), t)
    occ = []
    for wi in range(sels.shape[0]):
        vl = torch.as_tensor(valids[wi, :l_t_max], device="cuda")[:, None, None, None]
        loc = pool[torch.as_tensor(sels[wi, :l_t_max], device="cuda")] * vl
        occ.append(max_pool2d(loc, (5, 9), (5, 9)).sum(0).reshape(-1) > 0)
    return torch.cat(occ)


# ------------------------------------------------------------------ phase 3


def synthetic_clip(t: int, h: int, w: int):
    """Moving box over a gradient (the JAX package's bench clip)."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([yy / h, xx / w, (yy + xx) / (h + w)], axis=-1).astype(np.float32)
    frames = np.repeat(base[None], t, axis=0)
    masks = np.zeros((t, h, w), dtype=np.float32)
    for i in range(t):
        x0 = int(w * 0.2) + 3 * i
        y0 = int(h * 0.3) + i
        frames[i, y0 : y0 + h // 6, x0 : x0 + w // 8] = [1.0, 0.2, 0.2]
        masks[i, y0 : y0 + h // 6, x0 : x0 + w // 8] = 1.0
    return (frames * 255).astype(np.uint8), (masks * 255).astype(np.uint8)


WIDGETS = dict(
    mask_dilates=5, flow_mask_dilates=8, ref_stride=10, neighbor_length=10,
    subvideo_length=80, raft_iter=20, fp16="enable", _allow_random_weights=True,
)


def node_run(kernel_mods):
    from comfyui_propainter_nodes_tpu_torch.nodes import ProPainterInpaint

    t, h, w = 24, 360, 640
    frames, masks = synthetic_clip(t, h, w)
    node = ProPainterInpaint(device="cuda")

    def run():
        return node.propainter_inpainting(frames, masks, width=w, height=h, **WIDGETS)

    t0 = time.perf_counter()
    run()
    log(f"  warm-up run {time.perf_counter() - t0:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    for m in kernel_mods:
        m.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img, fm, md = run()
    wall = time.perf_counter() - t0
    counts = {m.__name__.rsplit(".", 1)[1]: m.launches for m in kernel_mods}
    stages = node.last_pipeline.stage_seconds
    peak = torch.cuda.max_memory_allocated()
    log(f"  timed run {wall:.3f} s = {t / wall:.3f} frames/s; stages (s): "
        + ", ".join(f"{k} {v:.4f}" for k, v in stages.items()))
    log(f"  max_memory_allocated {peak / 2**30:.3f} GiB; launches {counts}")

    require(all(c > 0 for c in counts.values()), f"a kernel was not launched on the main path: {counts}")
    require(tuple(img.shape) == (t, h, w, 3) and img.dtype == torch.float32, (img.shape, img.dtype))
    require(tuple(fm.shape) == (t, h, w) and tuple(md.shape) == (t, h, w), (fm.shape, md.shape))
    img_np, md_np = img.numpy(), md.numpy()
    require(np.isfinite(img_np).all() and img_np.min() >= 0.0 and img_np.max() <= 1.0, "IMAGE must be finite and in [0, 1]")
    require(set(np.unique(fm.numpy())) <= {0.0, 1.0} and set(np.unique(md_np)) <= {0.0, 1.0}, "masks must be binary")
    outside = md_np == 0
    orig = frames.astype(np.float32) / 255.0
    err_out = float(np.abs(img_np - orig)[outside].max())
    require(err_out < 1e-6, f"output differs from the input outside the dilated mask: {err_out}")
    require(md_np.sum() > 0 and (np.abs(img_np - orig)[~outside]).max() > 0, "the masked region must be inpainted")
    return dict(seconds=wall, fps=t / wall, stages=stages, peak_bytes=peak, launches=counts,
                profile=profile_run(run, wall))


def profile_run(run, timed_wall_s):
    """One more node run under torch.profiler: device time by kernel, and
    the device's busy share of the (unprofiled) timed run's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue  # host ops: their device time is their kernels'
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0.0)
        if dev > 0:
            rows.append((dev / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    if busy == 0:
        log("  profiler: no device time recorded (not measured)")
        return None
    mine = {k: sum(r[0] for r in rows if k in r[2]) for k in
            ("corr_lookup_kernel", "deform_conv_kernel", "window_attention_kernel")}
    share = busy / (timed_wall_s * 1e3)
    log(f"  profiled run: device kernels {busy:.1f} ms = {100 * share:.1f}% of the timed run's "
        f"wall; port kernels (ms): " + ", ".join(f"{k} {v:.2f}" for k, v in mine.items()))
    with open(os.path.join(HERE, "chiprun_out", "profile.txt"), "w") as f:
        for dev, cnt, key in rows:
            f.write(f"{dev:12.3f} ms {cnt:7d}  {key}\n")
    for dev, cnt, key in rows[:10]:
        log(f"    {dev:10.3f} ms {cnt:6d}x  {key[:90]}")
    return dict(device_kernels_ms=busy, busy_share=share, kernels_ms=mine)


def card_vs_host():
    """The same small node run (fp32, 2 RAFT iterations) on the card and on
    the host, whose kernels are the plain versions."""
    from comfyui_propainter_nodes_tpu_torch.nodes import ProPainterInpaint

    frames, masks = synthetic_clip(8, 120, 160)
    kw = dict(width=96, height=64, mask_dilates=4, flow_mask_dilates=4, ref_stride=4,
              neighbor_length=4, subvideo_length=80, raft_iter=2, fp16="disable",
              _allow_random_weights=True)
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    gpu = ProPainterInpaint(device="cuda").propainter_inpainting(frames, masks, **kw)
    cpu = ProPainterInpaint(device="cpu").propainter_inpainting(frames, masks, **kw)
    diff = (gpu[0] - cpu[0]).abs()
    share = float((diff > 1.5 / 255).float().mean())
    log(f"  card vs host (8x64x96 fp32): IMAGE max diff {float(diff.max()):.5f}, "
        f"share > 1/255: {share:.6f}; masks equal: {bool(torch.equal(gpu[1], cpu[1]) and torch.equal(gpu[2], cpu[2]))}")
    require(torch.equal(gpu[1], cpu[1]) and torch.equal(gpu[2], cpu[2]), "card and host masks differ")
    # the uint8 floor can flip one level; a flipped image-propagation mask
    # bit can move a few pixels further
    require(share < 1e-3 and float(diff.mean()) < 1e-3, f"card and host IMAGE differ: share {share}, mean {float(diff.mean())}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from comfyui_propainter_nodes_tpu_torch.ops.cuda import _build
    from comfyui_propainter_nodes_tpu_torch.ops.cuda import corr_lookup, deform_conv, window_attention

    name = torch.cuda.get_device_name(0)
    log(f"device: {name}, torch {torch.__version__}, cuda {torch.version.cuda}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    log("phase 1: build")
    t0 = time.perf_counter()
    _build.build(verbose=True)
    _build.library()
    log(f"  kernels built in {time.perf_counter() - t0:.2f} s")
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "ptxas.log"), "w") as f:
        f.write(_build.build_log)
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log("  " + line.strip())

    log("phase 2: kernels vs plain versions")
    gen = torch.Generator(device="cuda").manual_seed(0)
    occ = main_path_occupancy()
    log(f"  main-path window occupancy: {int(occ.sum())}/{occ.numel()} windows")
    res = {}
    for dt in (torch.float32, torch.bfloat16):
        key = str(dt)[6:]
        res[("B1", key)] = check_corr_lookup(dt, gen)
        res[("B2fc", key)] = check_deform_conv(dt, gen, (2, 45, 80, 256))
        res[("B2fp", key)] = check_deform_conv(dt, gen, (5, 90, 160, 128))
        res[("B3e", key)] = check_window_attention(dt, gen, 7, occ)
        res[("B3o", key)] = check_window_attention(dt, gen, 6, occ)

    log("phase 3: ProPainterInpaint 24x640x360, default widgets, random weights")
    mods = [corr_lookup, deform_conv, window_attention]
    node = node_run(mods)
    card_vs_host()

    log("phase 4: report")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    pkg = "comfyui_propainter_nodes_tpu_torch"
    rows = [
        ("corr_lookup", f"{pkg}/csrc/corr_lookup.cu",
         "comfyui_propainter_nodes_tpu/ops/pallas/corr_lanes.py:55", "B1", "corr_lookup"),
        ("deform_conv", f"{pkg}/csrc/deform_conv.cu",
         "comfyui_propainter_nodes_tpu/ops/pallas/deform_conv.py:52", "B2fp", "deform_conv"),
        ("window_attention", f"{pkg}/csrc/window_attention.cu",
         "comfyui_propainter_nodes_tpu/ops/pallas/window_attention.py:52", "B3e", "window_attention"),
    ]
    kernels = []
    for name_k, src, repl, rk, cnt in rows:
        r = res[(rk, "bfloat16")]
        kernels.append({
            "name": name_k, "route": "cuda", "source": src, "replaces": repl,
            "launches": node["launches"][cnt], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"], "dtype": "bf16",
            "max_abs_err_fp32": res[(rk, "float32")]["max_abs_err"],
        })
    log(json.dumps({"kernels": kernels}))
    detail = {f"{k}_{d}": v for (k, d), v in res.items()}
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"device": name, "nvidia_smi": smi, "kernels": detail, "node": node}, f, indent=1)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
