"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises; the exit code is then nonzero). First the
three models' seeded random weights are written as `.jax.npz` caches in a
temporary directory named by PROPAINTER_TPU_WEIGHTS, so that every
weights lookup of the run takes the cache and nothing is downloaded.
  1. build the CUDA kernels (csrc/*.cu, sm_90a); print the build time and,
     for each kernel, its registers, spills and static shared memory
     (ptxas) and its count of tensor-core HMMA instructions (cuobjdump
     -sass); the three bf16 attention kernels and the four instances of
     the bf16 deformable conv kernel must have some, and the six of the
     fp32 attention loop (B3's, B4's and B5's, 16- and 4-byte copies) and
     the two of the fp32 deformable conv kernel no spills;
  2. hold each kernel against its plain PyTorch version in fp32 (TF32 off)
     and bf16, and time kernel, plain version and, where one exists, the
     one PyTorch call that computes the same function (B3 and B5 also
     with every window clean, the share of their time clean windows set):
       B1 (both RAFT directions in one launch, output in the maps' type,
       bit-equal) and B3 at the main-path shapes of a 24-frame 640x360
       node run; in bf16 B1 also with the map-dtype blend
       (`corr_lookup_map_kernel`, path A's), both blends at the main
       path's M = 165600 and at path A's per-call shape (3 pairs of
       90x160), and the lanes blend (fp32 too) at the outpaint canvas's
       call (23 pairs of 45x96); B2 at the node's two shapes at 640x360,
       1280x720 and on the 768x360 outpaint canvas and at path T's
       x[2,60,108,128], bf16 also with each pixel tile (64 and 32 pixels a
       block), fp32 with each tap split (1, 3, 9; each also held against
       the plain version, and two calls bit-equal); B3 also
       at the outpaint canvas's shapes (30x72 token grid, the ring's
       occupancy);
       B4 (segment-tiled attention) at the 1280x720 shapes, path A's
       (5 windows of 13 frames) and path S's (one window of 19 frames,
       t_sel 10 and 9, the middle window's occupancy), and in bf16 at
       path H's (one window of 19 frames at 1920x1080), with B3 timed on
       the same inputs; B1's map blend and B2 bf16 also at path H's shapes
       (a RAFT call of 2 pairs of 135x240; x[2,135,240,256] and
       x[1,270,480,128]); B5 (halo attention) at the 640x360 and
       1280x720 token grids; B6 (four-level padded-map lookup) on the
       main path's padded pyramid and B7 (one level) on its level 0;
       and at paths C and M's shapes, in both dtypes: B1 on path C's
       108-pair call of 45x80 (the map blend; fp32 maps the fp32
       kernel) and path M (1, 2)'s 12-pair calls (lanes), B2 at
       x[4,45,80,256], x[8,90,160,128] and x[4,90,160,128], and B4 at
       path C's middle window group (8 windows of 19 frames, t_sel 10
       and 9, 36 token windows a row, its occupancy); image propagation's
       step (`prop_fill`) at the outpaint cell's clip (24 frames on the
       768x360 canvas), the main path's, path A's 720p clip, path C's
       batch of two 100-frame chunks with per-row restarts and an odd
       size (bilinear), both directions bit-equal to the plain steps;
       at the outpaint clip one step and a whole direction (23 steps)
       timed both ways; RAFT's pyramid build (`corr_pyramid`, bf16) at the
       main path's and the outpaint canvas's one call (23 pairs of 45x80,
       45x96) and 1280x720's calls of 4 and 3 pairs of 90x160: level 0
       within one bf16 ulp and the sums' slack of the eager build, the
       backward level 0 its forward one transposed and levels 1-3 the
       plain pooling of its level 0, bit for bit; kernel and eager build
       timed;
     then the gradients (fp32) at path T's shapes: B2 at x[2,60,108,128],
     B3 and B4 at a layer's attention (2 clips x 16 windows of 16 frames,
     t_sel 8, path T's occupancy), B5 on the same 20x36 token grid: each
     Function's output has a grad_fn, its input gradients are within 1e-4
     of the plain version's largest, and its backward (the plain
     version's forward and backward) is timed beside, for B3/B4, SDPA's
     forward and backward on the same inputs; then the conv sites of
     one float32 clip of the benchmark's `inpaint-360p-fp32.object`
     (24 frames at 640x360) that GEMM_SITES names, at their shapes, fp32:
     each stride 1 and its GEMM path (`conv2d_gemm`) within 1e-3 of
     cuDNN; one iteration of RAFT's update block on GEMM_SITES and on
     cuDNN, with its `conv_gemm` count; and a float32 and a bf16 clip of
     that cell: `conv_gemm` launches (0 in bf16) and no cuDNN FFT kernel
     in the float32 clip's profile (`check_conv_gemm`);
  3. run ProPainterInpaint(device="cuda") on synthetic 24-frame clips at
     default widgets with seeded random weights, each a warm-up run, a
     timed run with the launch counters reset just before it, and a
     profiled run (each kernel of the path must show device time, and
     no kernel off it; B2's launches are also counted by shape; the
     device-to-host copy's time is read from the profile), and check the
     output (the node decodes and fetches only the mask's crop):
       the main path, 640x360 (B1 with the lanes blend, B2, B3);
       path A, 1280x720 (B1 with the map-dtype blend, B2, B4);
       path B, 640x360 with PROPAINTER_TPU_ATTN=halo and
       PROPAINTER_TPU_CORR_KERNEL=pallas (B2, B5, B6);
     then ProPainterOutpaint(device="cuda") the same way, path O: 24
     frames of 640x360 on the default 768x360 canvas (B1 with the lanes
     blend, B2, B3; its bands, all the card computes there, held against
     the same node at fp16="disable"); then path S: the long-video
     entry point `process_streaming` over 240 frames at 1280x720 read from
     .npy files through `VideoSource`, twice: with blocking stage timers
     and each stage's peak memory, then as a user runs it, with the launch
     counters reset just before it (B1 with the map-dtype blend, B2, B4;
     every frame written once, in order, uint8-exact, equal to the input
     outside its dilated mask; wall, frames/s, time to the first write,
     peak memory and memory after each window's eviction, which must not
     grow between chunk fills); then, at 1920x1080, each memory plan that
     no path takes forced on 20 frames against the path's forms (also
     path H's warm-up), and path H: `process_streaming` over 120 frames
     at 1920x1080, one run with blocking stage timers (B1 with the
     map-dtype blend, B2, B4; the form of each RAFT call and completion
     chunk; the output checked as path S's; peak at most 64 GiB; the live
     set flat between chunk fills); the five earlier paths' launches are
     held to `EARLIER_LAUNCHES`; the `conv_gemm` count (the fp32
     convs of GEMM_SITES on cuBLAS, grad mode off) must be 0 on every
     bf16 run and above 0 on the fp32
     legs of paths C, M and MH;
     then check the card against the host on a small
     clip, the inpaint node with the default kernels and with both
     switches, and the outpaint node; and streaming against the
     in-memory run on the card (48 frames at 640x360, subvideo_length 16,
     fp32 and bf16, differing bytes counted); then path C:
     `Pipeline.process` on 100 frames at 640x360 (default widgets) with
     PROPAINTER_TPU_CLIP_PARALLEL=1 and no mesh, RAFT's 9 chunks in one
     108-pair call, 2 completion and 2 image-propagation chunks batched
     (B1 with the map-dtype blend, B2, B4: its 19-frame windows pass the
     JAX size estimate's 12e6; a warm-up and a timed bf16 run;
     fp32 held against the chunks in turn within the card-against-host
     tolerance); and path M: the same clip on two ranks, processes of
     their own (one card over gloo when the machine shows one, a card
     each over NCCL otherwise), with meshes (2, 1) (clip-parallel stages
     1-3, window data parallelism: B1 map, B2, B4) and (1, 2) (the
     sequence-parallel transformer, which takes no kernel: B1 map, B2),
     each in fp32, held against path C's fp32 output, and in bf16 timed
     (on (1, 2) once more with the gathers and the gathered-KV
     attention timed apart);
     every rank's output is the whole video, integral and the input
     outside its dilated mask (the fp32 legs of paths C, M and MH at
     FP32_RAFT_ITER RAFT iterations, a depth cut);
     then path MH (path A's clip on mesh (1, 2), the H split), and path T:
     the training step (training/train_step.py) on 2 clips of 10 local +
     6 reference frames at 432x240 (ProPainter's training recipe), flows
     from the port's compute_flow and complete_flow, fp32, AdamW: the
     first step against the same step with the plain versions of B2 and
     B3/B4 (loss rtol 1e-5, gradients 1e-4 of their largest), 5 timed
     steps (B2 and B4 in each, nothing else; forward / backward / update
     split; peak), one more with the plain versions' backward timed
     apart; then on mesh (1, 2), two ranks on one card, its first step
     held to the single card's (loss rtol 2e-5; two weights within atol
     1e-5, rtol 1e-4) and its second timed;
  4. print the card's name and power limit, a `kernels` JSON line, and
     the result JSON as the last line.
Needs a CUDA card; exits nonzero without one. Details land in
chiprun_out/ (ptxas log, profiles, chip_smoke.json).

    python3 chip_smoke.py --conv-gemm

times path T's training step as the port runs it (cuDNN under autograd)
and with the conv sites of `ops/conv.py::GEMM_SITES` on GEMMs there too,
in turns, then phase 2's conv checks with every conv site of the float32
clip timed both ways (`check_conv_gemm`; one JSON line, the sites' table
also in chiprun_out/conv_gemm.json).
"""

from __future__ import annotations

import collections
import contextlib
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

# the nodes' progress bars (tqdm, on stderr) off; tqdm reads this when it is
# first imported, which importing torch does
os.environ["TQDM_DISABLE"] = "1"

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
OUT_DIR = os.path.join(HERE, "chiprun_out")

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # bf16 dense, fp32 non-tensor
SWITCHES = {"PROPAINTER_TPU_ATTN": "halo", "PROPAINTER_TPU_CORR_KERNEL": "pallas"}


def log(*a):
    print(*a, flush=True)


def time_ms(fn, reps: int = 20, warmup: int = 3, batch: int = 10) -> float:
    """Median over `reps` samples of the CUDA-event time of `batch` calls
    launched back to back, divided by `batch`, after warm-up. Back to back
    the card does not wait for the host between calls, so a call is timed
    at its device time unless the host takes longer to enqueue it. With
    batch=1 (one call a sample) the card also waits for the host to
    enqueue the call: that time is in it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(batch):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / batch)
    return statistics.median(times)


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def require(cond, msg) -> None:
    """A check that stays under `python -O`."""
    if not cond:
        raise RuntimeError(str(msg))


def rel_err(out, ref) -> tuple[float, float]:
    d = (out.float() - ref.float()).abs().max().item()
    return d, d / max(1e-6, ref.float().abs().max().item())


def bound_ms(flops: float, nbytes: float, dt) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FLOPS[dt], nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


@contextlib.contextmanager
def switches(on: bool):
    """The JAX package's kernel switches, set for the block (the port
    reads them at call time)."""
    old = {k: os.environ.get(k) for k in SWITCHES}
    if on:
        os.environ.update(SWITCHES)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# ------------------------------------------------------------------ phase 1


def kernel_name(mangled: str) -> str:
    """`window_attention_kernel<bf16>` or `deform_conv_mma_kernel<64,1>`
    from a mangled entry name: the length-prefixed identifier ending in
    `_kernel`, and its template arguments where it has them (a type, or
    integer and bool constants)."""
    found = []
    for m in re.finditer(r"\d+", mangled):
        for i in range(len(m.group())):  # a hash's digits may run into the length
            ident = mangled[m.end() : m.end() + int(m.group()[i:])]
            if ident.endswith("_kernel") and re.fullmatch(r"[A-Za-z_]\w*", ident):
                found.append((len(ident), ident, mangled[m.end() + len(ident) :]))
    if not found:
        return mangled
    _, ident, rest = min(found)
    consts = re.match(r"I((?:L[ib]\d+E)+)E", rest)
    if consts:
        return ident + "<" + ",".join(re.findall(r"L[ib](\d+)E", consts.group(1))) + ">"
    return ident + ("<bf16>" if rest.startswith("I13__nv_bfloat16") else "<fp32>" if rest.startswith("If") else "")


def kernel_resources(ptxas_log: str, lib_path: str) -> dict:
    """Per kernel: registers, spill bytes and static shared memory from
    ptxas's output, and the count of tensor-core (HMMA) instructions in
    the library's SASS (`cuobjdump -sass`)."""
    res, cur = {}, None
    for line in ptxas_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = res.setdefault(kernel_name(m.group(1)), dict(registers=0, spill_stores=0, spill_loads=0, smem=0, hmma=0))
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(sm.group(1)) if sm else 0
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True, check=True).stdout
    cur = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            cur = res.setdefault(kernel_name(m.group(1)), dict(registers=0, spill_stores=0, spill_loads=0, smem=0, hmma=0))
        elif cur is not None and "HMMA" in line:
            cur["hmma"] += 1
    return res


# ------------------------------------------------------------------ phase 2


def corr_coords(gen, im, h8, w8):
    yy, xx = torch.meshgrid(
        torch.arange(h8, device="cuda", dtype=torch.float32),
        torch.arange(w8, device="cuda", dtype=torch.float32), indexing="ij",
    )
    flow = torch.randn(im, h8, w8, 2, generator=gen, device="cuda") * 6.0
    return (torch.stack([xx, yy], -1)[None] + flow).contiguous()


def grid_sample_taps(maps, xs, ys):
    """The library call for one level: grid_sample (zeros, align_corners)
    of [M, Hl, Wl] maps at tap positions xs/ys [M, 9, 9]."""
    hl, wl = maps.shape[1], maps.shape[2]
    xs, ys = torch.broadcast_tensors(xs, ys)
    grid = torch.stack([2.0 * xs / max(wl - 1, 1) - 1.0, 2.0 * ys / max(hl - 1, 1) - 1.0], -1).to(maps.dtype)
    return lambda: F.grid_sample(maps[:, None], grid, mode="bilinear", padding_mode="zeros", align_corners=True)


def corr_lookup_inputs(dt, gen, im=23, h8=45, w8=80):
    """Both directions of one RAFT call: by default the main path's, 23
    frame pairs of 45x80 1/8-res features, coords [46, 45, 80, 2] (M =
    165600); path A's is 3 pairs of 90x160 (M = 86400)."""
    from comfyui_propainter_nodes_tpu_torch.models.raft import build_corr_pyramids

    c = 256
    f1 = torch.randn(im, h8, w8, c, generator=gen, device="cuda").to(dt)
    f2 = torch.randn(im, h8, w8, c, generator=gen, device="cuda").to(dt)
    fwd, bwd = build_corr_pyramids(f1, f2)
    return fwd, bwd, corr_coords(gen, 2 * im, h8, w8)


def check_corr_lookup(dt, gen, blend="lanes", shape=(23, 45, 80)):
    """B1 on both directions in one launch, output in the maps' type, with
    the lanes blend (fp32, one rounding) or the map-dtype blend (each step
    rounded to bf16), for one RAFT call of `shape` = (pairs, H8, W8)."""
    from comfyui_propainter_nodes_tpu_torch.ops.cuda import corr_lookup as mod
    from comfyui_propainter_nodes_tpu_torch.utils import profiling

    fwd, bwd, coords = corr_lookup_inputs(dt, gen, *shape)
    counter = "corr_lookup_map" if blend == "map" and dt == torch.bfloat16 else "corr_lookup"
    before = profiling.counters().get(counter, 0)
    out = mod.corr_lookup(fwd, coords, bwd, blend=blend)
    torch.cuda.synchronize()
    require(profiling.counters().get(counter, 0) == before + 1,
            f"corr_lookup blend={blend} did not count its launch on {counter}")
    ref = mod.corr_lookup_plain(fwd, coords, bwd, blend=blend)
    err, rel = rel_err(out, ref)
    # the same products and sums, each rounded as in the plain version:
    # equal bit for bit
    log(f"  B1 corr_lookup {str(dt)[6:]} blend={blend} (both directions, {shape[0]} pairs of {shape[1]}x{shape[2]}, "
        f"M {coords.numel() // 2}): out {str(out.dtype)[6:]}, max_abs_err {err:.3e} rel {rel:.3e} (must be bit-equal)")
    require(out.dtype == dt and torch.equal(out, ref), f"corr_lookup blend={blend} disagrees with its plain version")
    ms = time_ms(lambda: mod.corr_lookup(fwd, coords, bwd, blend=blend))
    ms_single = time_ms(lambda: mod.corr_lookup(fwd, coords, bwd, blend=blend), batch=1)
    plain_ms = time_ms(lambda: mod.corr_lookup_plain(fwd, coords, bwd, blend=blend), reps=5, warmup=1, batch=1)
    # library: RAFT's own bilinear_sampler in the maps' type, one
    # grid_sample per level and direction, taps in the kernel's (dx, dy) order
    n = fwd[0].shape[0]
    d = torch.arange(-4, 5, device="cuda", dtype=torch.float32)
    calls = []
    for pyr, flat in ((fwd, coords[: coords.shape[0] // 2].reshape(-1, 2)), (bwd, coords[coords.shape[0] // 2 :].reshape(-1, 2))):
        calls += [grid_sample_taps(m, flat[:, 0, None, None] / 2**lvl + d[:, None], flat[:, 1, None, None] / 2**lvl + d[None, :])
                  for lvl, m in enumerate(pyr)]

    def library():
        return torch.cat([torch.cat([f().reshape(n, 81) for f in calls[i : i + 4]], 1) for i in (0, 4)]).reshape(out.shape)

    cudnn = True
    try:
        lib = library()
    except RuntimeError as e:  # cuDNN's sampler refuses maps this large (path C's call): grid_sample's own kernel
        if "CUDNN_STATUS_NOT_SUPPORTED" not in str(e):
            raise
        cudnn = False
    with torch.backends.cudnn.flags(enabled=cudnn):
        if not cudnn:
            lib = library()
        lib_err, _ = rel_err(lib, ref)
        library_ms = time_ms(lambda: [f() for f in calls])
    # bytes this data needs: in-range part of each 10x10 window, coords, output
    esz = fwd[0].element_size()
    need = 0
    for lvl, m in enumerate(fwd):
        cl = coords / 2**lvl
        x0 = torch.floor(cl[..., 0]) - 4
        y0 = torch.floor(cl[..., 1]) - 4
        cols = ((x0 + 10).clamp(max=m.shape[2]) - x0.clamp(min=0)).clamp(min=0)
        rows = ((y0 + 10).clamp(max=m.shape[1]) - y0.clamp(min=0)).clamp(min=0)
        need += float((rows * cols).sum()) * esz
    n_pix = coords.numel() // 2
    bound, by = bound_ms(n_pix * 324 * 6, need + n_pix * 8 + n_pix * 324 * out.element_size(), torch.float32)
    log(f"    ms {ms:.4f} (one call a sample {ms_single:.4f})  plain_ms {plain_ms:.4f}  bound_ms {bound:.4f} ({by})  "
        f"library_ms {library_ms:.4f} (grid_sample in {str(dt)[6:]}, 8 calls, one per level and direction"
        f"{'' if cudnn else ', cuDNN off: it refuses these maps'}; err vs plain {lib_err:.3e})")
    return dict(max_abs_err=err, ms=ms, ms_single=ms_single, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=library_ms, library_cudnn=cudnn, blend=blend)


def check_corr_window(dt, gen):
    """B6 on the padded [fwd ++ bwd] pyramid of the main path's RAFT call
    (M = 2 * 23 * 45 * 80) and B7 on its level 0."""
    from comfyui_propainter_nodes_tpu_torch.models.raft import build_padded_pyramid_bi, padded_starts
    from comfyui_propainter_nodes_tpu_torch.ops.cuda import corr_window as mod

    im, h8, w8, c = 23, 45, 80, 256
    f1 = torch.randn(im, h8, w8, c, generator=gen, device="cuda").to(dt)
    f2 = torch.randn(im, h8, w8, c, generator=gen, device="cuda").to(dt)
    pyr = build_padded_pyramid_bi(f1, f2)
    del f1, f2
    coords = corr_coords(gen, 2 * im, h8, w8)
    sy, sx, fy, fx = padded_starts(pyr, coords)
    m = sy.shape[1]
    esz = pyr[0].element_size()
    taps = torch.arange(9, device="cuda", dtype=torch.float32)
    res = {}
    for name, levels in (("B6", 4), ("B7", 1)):
        if levels == 4:
            run = lambda: mod.corr_window_lookup4(pyr, sy, sx, fy, fx)  # noqa: E731
            plain = lambda: mod.corr_window_lookup4_plain(pyr, sy, sx, fy, fx)  # noqa: E731
        else:
            run = lambda: mod.corr_window_lookup(pyr[0], sy[0], sx[0], fy[0], fx[0])  # noqa: E731
            plain = lambda: mod.corr_window_lookup_plain(pyr[0], sy[0], sx[0], fy[0], fx[0])  # noqa: E731
        out = run()
        torch.cuda.synchronize()
        ref = plain()
        err, rel = rel_err(out, ref)
        # the same products and sums, each rounded: equal bit for bit
        log(f"  {name} corr_window ({levels} level{'s' * (levels > 1)}) {str(dt)[6:]}: M {m}, "
            f"max_abs_err {err:.3e} rel {rel:.3e} (must be bit-equal)")
        require(torch.equal(out, ref), f"{name} disagrees with its plain version")
        ms = time_ms(run)
        ms_single = time_ms(run, batch=1)
        plain_ms = time_ms(plain, reps=5, warmup=1, batch=1)
        calls = [grid_sample_taps(pyr[lvl], sx[lvl, :, None, None] + fx[lvl, :, None, None] + taps[None, :],
                                  sy[lvl, :, None, None] + fy[lvl, :, None, None] + taps[:, None])
                 for lvl in range(levels)]
        lib = torch.stack([f()[:, 0] for f in calls], 1).reshape(out.shape)
        lib_err, _ = rel_err(lib, ref)
        library_ms = time_ms(lambda: [f() for f in calls])
        # each pixel's 10x10 window per level, its starts and fractions, the taps
        bound, by = bound_ms(m * levels * 81 * 6, m * levels * (100 * esz + 16 + 81 * 4), torch.float32)
        log(f"    ms {ms:.4f} (one call a sample {ms_single:.4f})  plain_ms {plain_ms:.4f}  bound_ms {bound:.4f} ({by})  "
            f"library_ms {library_ms:.4f} (grid_sample, {levels} call{'s' * (levels > 1)}, one per level; "
            f"err vs plain {lib_err:.3e}); kernel / library {ms / library_ms:.3f}, kernel / bound {ms / bound:.2f}")
        res[name] = dict(max_abs_err=err, ms=ms, ms_single=ms_single, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                         library_ms=library_ms)
    log(f"    padded level-0 maps {pyr[0].numel() * esz / 2**30:.3f} GiB")
    return res


# image propagation's directions: (batch rows, frames, height, width,
# first index, interpolation) at the outpaint cell's clip (timed), the
# main path's, path A's 720p clip, path C's batch of two 100-frame chunks
# with per-row restarts, and an odd frame whose 23x37 pixels end each row
# in a part-filled block (the kernel's tail guard), bilinear
PROP_FILL_CLIPS = {
    "path_o": (1, 24, 360, 768, 0, "nearest"),
    "main": (1, 24, 360, 640, 0, "nearest"),
    "path_a": (1, 24, 720, 1280, 0, "nearest"),
    "path_c": (2, 100, 360, 640, "per_row", "nearest"),
    "odd": (3, 5, 23, 37, 2, "bilinear"),
}


def prop_fill_inputs(n, t, h, w, dt, gen):
    """Frames zero inside the masks, binary masks (a box moving over the
    frames and the outpaint bands at both edges), flows of a few pixels."""
    mask = torch.zeros(n, t, h, w, 1, device="cuda")
    for j in range(t):
        y0, x0 = (h // 6 + j) % (h // 2), (w // 4 + 3 * j) % (w // 2)
        mask[:, j, y0 : y0 + h // 3, x0 : x0 + w // 3] = 1.0
    band = max(1, w // 12)
    mask[:, :, :, :band] = mask[:, :, :, -band:] = 1.0
    x = ((torch.rand(n, t, h, w, 3, generator=gen, device="cuda") * 2 - 1) * (1 - mask)).to(dt)
    fp, fc = (torch.randn(n, t - 1, h, w, 2, generator=gen, device="cuda").mul(3).to(dt) for _ in range(2))
    return x, mask.to(dt), fp, fc


def check_prop_fill(dt, gen):
    """Image propagation's step (prop_fill) on each of PROP_FILL_CLIPS:
    both directions against the plain steps, bit for bit (signed zeros
    too), `max_abs_err` the largest difference over both. At the outpaint
    clip, one step timed (kernel: `ms`, ten back to back, and `ms_single`,
    one launch a sample with its enqueue; the plain step) and a whole
    direction of 23 steps both ways, one call a sample. The bound: each
    input element read once (the pixel's flow, frame and mask, the
    previous slot's mask, frame and the check flow) and the slot written,
    16 elements a pixel."""
    from comfyui_propainter_nodes_tpu_torch.ops.cuda import prop_fill as mod

    res = {}
    for tag, (n, t, h, w, first, interp) in PROP_FILL_CLIPS.items():
        x, mask, fp, fc = prop_fill_inputs(n, t, h, w, dt, gen)
        fi = torch.tensor([0, t // 2 + 1, 1][:n], device="cuda") if first == "per_row" else first
        err = 0.0
        for reverse in (False, True):
            got = mod.prop_fill(x, mask, fp, fc, interp, fi, reverse)
            want = mod.prop_fill_plain(x, mask, fp, fc, interp, fi, reverse)
            for a, b in zip(got, want):
                require(torch.equal(a, b) and torch.equal(torch.signbit(a), torch.signbit(b)),
                        f"prop_fill {dt} {tag} reverse={reverse}: {int((a != b).sum())} values differ from the "
                        "plain steps")
                err = max(err, float((a.float() - b.float()).abs().max()))
        res[tag] = dict(clip=(n, t, h, w), first_index=fi.tolist() if first == "per_row" else first,
                        interpolation=interp, max_abs_err=err)
        log(f"  prop_fill {str(dt)[6:]} {tag} at [{n}, {t}, {h}, {w}] {interp}, first index "
            f"{res[tag]['first_index']}: both directions bit-equal to the plain steps (max abs err {err})")
        if tag == "path_o":
            feats, masks = got
            step = mod._kernel_launcher(x, mask, fp, fc, feats, masks, interp)
            run = lambda: step(t - 2, t - 1, t - 2, None)  # noqa: E731  (the backward pass's first step)
            plain = lambda: mod.prop_step_plain(  # noqa: E731
                feats[:, t - 1], masks[:, t - 1], x[:, t - 2], mask[:, t - 2], fp[:, t - 2], fc[:, t - 2], interp)
            ms, ms_single = time_ms(run), time_ms(run, batch=1)
            plain_ms = time_ms(plain, reps=10, warmup=2, batch=1)
            direction_ms = time_ms(lambda: mod.prop_fill(x, mask, fp, fc), reps=10, warmup=2, batch=1)
            plain_direction_ms = time_ms(lambda: mod.prop_fill_plain(x, mask, fp, fc), reps=5, warmup=1, batch=1)
            bound, by = bound_ms(0, n * h * w * 16 * x.element_size(), dt)
            log(f"  prop_fill {str(dt)[6:]} {tag}: a step: ms {ms:.4f} (one launch a sample {ms_single:.4f})  "
                f"plain_ms {plain_ms:.4f}  bound_ms {bound:.4f} ({by}), kernel / bound {ms / bound:.2f}; a direction "
                f"of {t - 1} steps: {direction_ms:.4f} ms, plain {plain_direction_ms:.4f} ms")
            res[tag].update(ms=ms, ms_single=ms_single, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                            library_ms=None, direction_ms=direction_ms, plain_direction_ms=plain_direction_ms)
        del x, mask, fp, fc, got, want
        torch.cuda.empty_cache()
    return res


# RAFT's update loop on the main path: one call of 23 pairs, both
# directions, at 640x360's 1/8-res grid (rows, height, width)
MAIN_RAFT_ROWS = (46, 45, 80)

# the float32 benchmark cell whose clip `clip_conv_sites` records, and the
# names of cuDNN's FFT convolution kernels
CONV_GEMM_CELL = "inpaint-360p-fp32.object"
FFT_KERNELS = ("fft", "cf32", "DSE::", "pointwise_mult_and_sum_complex")


def clip_conv_sites() -> dict:
    """Every 2D conv of one float32 inpaint node clip of CONV_GEMM_CELL (the
    benchmark's traffic and widgets, 24 frames at 640x360, seed 0), run with
    GEMM_SITES emptied, so each goes through `ops/conv.py::conv2d` on cuDNN,
    synchronised around each call: {(site, x shape, w shape, stride,
    padding, dilation, groups): [calls, host ms in the clip, the most bytes
    a call held above what was allocated before it]}."""
    from comfyui_propainter_nodes_tpu_torch.ops import attention, conv

    calls = collections.defaultdict(lambda: [0, 0.0, 0])
    base = conv.conv2d

    def recorded(x, w, b=None, stride=(1, 1), padding=(0, 0), dilation=(1, 1), groups=1, site=None):
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        y = base(x, w, b, stride, padding, dilation, groups, site)
        torch.cuda.synchronize()
        rec = calls[(site, tuple(x.shape), tuple(w.shape), tuple(stride), tuple(padding), tuple(dilation), groups)]
        rec[0] += 1
        rec[1] += (time.perf_counter() - t0) * 1e3
        rec[2] = max(rec[2], torch.cuda.max_memory_allocated() - held)
        return y

    run = conv_gemm_clip()
    saved = conv.GEMM_SITES
    conv.GEMM_SITES, conv.conv2d, attention.conv2d = frozenset(), recorded, recorded
    try:
        run("disable")
    finally:
        conv.GEMM_SITES, conv.conv2d, attention.conv2d = saved, base, base
    return calls


def conv_gemm_clip():
    """`run(fp16)`: one inpaint node call on CONV_GEMM_CELL's clip (seed 0)
    at its widgets but fp16, synchronised."""
    from benchmark.core import session, traffic
    from comfyui_propainter_nodes_tpu_torch.nodes import ProPainterInpaint

    spec = session.cell_spec(session.manifest(), CONV_GEMM_CELL)
    w = session.widgets(spec)
    image, mask = traffic.inputs(spec.mix, w, 0, 0)
    node = ProPainterInpaint()

    def run(fp16):
        out = session.call_node(node, "inpaint", image, mask, dict(w, fp16=fp16))
        torch.cuda.synchronize()
        return out

    return run


def clip_fft_check() -> dict:
    """One float32 and one bf16 node clip of CONV_GEMM_CELL as the port runs
    them (after a warm-up each): `conv_gemm` launches a clip (0 in bf16),
    and the float32 clip profiled: no cuDNN FFT kernel (FFT_KERNELS) may
    run; its conv and GEMM kernels' device ms."""
    from comfyui_propainter_nodes_tpu_torch.utils import profiling

    run = conv_gemm_clip()
    res = {}
    for fp16 in ("disable", "enable"):
        run(fp16)
        before = profiling.counters().get("conv_gemm", 0)
        run(fp16)
        res["conv_gemm_" + fp16] = profiling.counters().get("conv_gemm", 0) - before
    require(res["conv_gemm_disable"] > 0 and res["conv_gemm_enable"] == 0, f"conv_gemm launches a clip: {res}")
    kernels = cudnn_kernels(lambda: run("disable"))
    fft = {k: v for k, v in kernels.items() if any(p in k for p in FFT_KERNELS)}
    require(not fft, f"a float32 clip ran cuDNN FFT kernels: {fft}")
    res["fp32_conv_kernels_ms"] = {k: v for k, v in sorted(kernels.items(), key=lambda kv: -kv[1])
                                   if "gemm" in k or "conv" in k or "fprop" in k}
    log(f"  float32 clip: conv_gemm {res['conv_gemm_disable']} launches (bf16 {res['conv_gemm_enable']}), no FFT "
        f"kernel; conv / GEMM kernels (ms): " + ", ".join(f"{k} {v:.1f}" for k, v in
                                                         list(res["fp32_conv_kernels_ms"].items())[:8]))
    return res


def cudnn_kernels(run) -> dict:
    """Device ms by kernel name of one `run`, profiled."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return {e.key[:96]: e.device_time_total / 1e3 for e in prof.key_averages() if e.device_time_total > 0}


def check_conv_gemm(gen, table: bool = True) -> dict:
    """Every conv site of one float32 inpaint clip (`clip_conv_sites`), fp32
    with TF32 off, at its shapes: each site that GEMM_SITES names must be
    stride 1 and undilated, and its GEMM output (`ops/conv.py::conv2d_gemm`)
    within 1e-3 of cuDNN's at the whole shape. Then one iteration of RAFT's
    update block (no lookup) and the mask head at MAIN_RAFT_ROWS, on
    GEMM_SITES (8 `conv_gemm` launches) and on cuDNN (none), within 1e-3 of
    each other; and `clip_fft_check`. With `table` (`--conv-gemm`) every
    site, also those on cuDNN, is timed: cuDNN's heuristic (`cudnn_ms`, its
    kernels and whether one is an FFT convolution's), the GEMM path
    (`gemm_ms`) and the bound (its FLOPs over 67 TFLOP/s), each a call and
    times the clip's calls, with both outputs against float64 on the first
    two images and the rule GEMM_SITES was set by; and the update block
    both ways."""
    from comfyui_propainter_nodes_tpu_torch.models import raft as traft
    from comfyui_propainter_nodes_tpu_torch.ops import conv
    from comfyui_propainter_nodes_tpu_torch.utils import profiling
    from comfyui_propainter_nodes_tpu_torch.utils.params import from_jax_params
    from comfyui_propainter_nodes_tpu_torch.utils.weights import random_params

    t0 = time.perf_counter()
    calls = clip_conv_sites()
    log(f"  conv sites of one float32 {CONV_GEMM_CELL} clip: {len(calls)} shapes, "
        f"{sum(c[0] for c in calls.values())} calls ({time.perf_counter() - t0:.1f} s)")
    sites = []
    for (site, xs, ws, stride, pad, dil, groups), (n_calls, clip_ms, clip_peak) in calls.items():
        gemm_site = site in conv.GEMM_SITES
        if not (table or gemm_site):
            continue
        x = torch.randn(xs, generator=gen, device="cuda")
        w = torch.randn(ws, generator=gen, device="cuda") / math.sqrt(ws[1] * ws[2] * ws[3])
        b = torch.randn(ws[0], generator=gen, device="cuda")
        row = dict(site=site, calls=n_calls, x=xs, w=ws, stride=stride, padding=pad, dilation=dil, groups=groups,
                   in_clip_ms=clip_ms, in_clip_extra_bytes=clip_peak, gemm_site=gemm_site)
        with torch.no_grad():
            ref = conv.conv2d(x, w, b, stride, pad, dil, groups)
            if table:
                row["cudnn_ms"] = time_ms(lambda: conv.conv2d(x, w, b, stride, pad, dil, groups), reps=5, warmup=1,
                                          batch=2)
                kernels = cudnn_kernels(lambda: conv.conv2d(x, w, b, stride, pad, dil, groups))
                row.update(cudnn_kernels=kernels, fft=any(k in name for name in kernels for k in FFT_KERNELS),
                           bound_ms=2.0 * ref.numel() * ws[1] * ws[2] * ws[3] / PEAK_FLOPS[torch.float32] * 1e3)
            if stride == (1, 1) and dil == (1, 1) and (groups == 1 or min(xs[3], ws[0]) >= conv.FEW_CHANNELS):
                wt = conv.gemm_weight(w)
                got = conv.conv2d_gemm(x, wt, b, ws[2:], pad, groups)
                row["max_abs_err"] = (got - ref).abs().max().item()
                row["out_max"] = ref.abs().max().item()
                if table:
                    row["gemm_ms"] = time_ms(lambda: conv.conv2d_gemm(x, wt, b, ws[2:], pad, groups), reps=5,
                                             warmup=1, batch=2)
                    f64 = conv.conv2d(x[:2].double(), w.double(), b.double(), stride, pad, dil, groups)
                    row["gemm_vs_f64"] = (got[:2] - f64).abs().max().item()
                    row["cudnn_vs_f64"] = (ref[:2] - f64).abs().max().item()
                    del f64
                del got, wt
        if gemm_site:
            require("max_abs_err" in row, f"GEMM site {site} is not a stride-1 undilated conv: {row}")
            require(row["max_abs_err"] < 1e-3, f"GEMM site {site} against cuDNN: {row['max_abs_err']:.3e}")
        shape = f"conv {site} x{list(xs)} w{list(ws)} s{stride[0]} g{groups} x{n_calls}"
        err = (f"max abs err {row['max_abs_err']:.2e} of {row['out_max']:.2e}" if "max_abs_err" in row else "")
        if table:
            # the rule GEMM_SITES was set by: FFT, 1.5x the GEMMs' time, or 4 GiB held in the clip
            row["rule"] = "gemm_ms" in row and (row["fft"] or row["cudnn_ms"] >= 1.5 * row["gemm_ms"]
                                                or clip_peak >= 4 << 30)
            log(f"  {shape} (in the clip {clip_ms:.2f} ms, {clip_peak / 2**30:.2f} GiB above): cuDNN "
                f"{row['cudnn_ms']:.4f} ms{' (FFT)' if row['fft'] else ''}, GEMM "
                + (f"{row['gemm_ms']:.4f}" if "gemm_ms" in row else "-") + f", bound {row['bound_ms']:.4f}"
                + (f"; {err} (vs float64: GEMM {row['gemm_vs_f64']:.2e}, cuDNN {row['cudnn_vs_f64']:.2e})"
                   if "gemm_ms" in row else "")
                + (" [GEMM site]" if gemm_site else "") + (" [rule: GEMM]" if row["rule"] else ""))
        else:
            log(f"  GEMM site {shape}: {err} against cuDNN")
        sites.append(row)
        del x, w, b, ref
        torch.cuda.empty_cache()
    res = dict(sites=sites)
    if table:
        clip = {k: sum(r.get(k + "_ms", 0.0) * r["calls"] for r in sites) for k in ("cudnn", "bound")}
        clip["path"] = sum(r["calls"] * (r["gemm_ms"] if r["gemm_site"] else r["cudnn_ms"]) for r in sites)
        clip["fft_sites_off_gemm"] = sorted({r["site"] for r in sites if r["fft"] and not r["gemm_site"]})
        clip["rule_disagrees"] = sorted({r["site"] for r in sites if r["rule"] != r["gemm_site"]})
        log(f"  a clip's convs: cuDNN {clip['cudnn']:.1f} ms, as GEMM_SITES runs them {clip['path']:.1f} ms, bound "
            f"{clip['bound']:.1f} ms; FFT sites left on cuDNN: {clip['fft_sites_off_gemm']}; sites where this run's "
            f"reading of the rule differs from GEMM_SITES: {clip['rule_disagrees']}")
        res["clip_ms"] = clip
    rows, h8, w8 = MAIN_RAFT_ROWS
    params = {k: v.cuda() for k, v in from_jax_params(random_params("raft", seed=3)).items()}
    net = torch.tanh(torch.randn(rows, h8, w8, 128, generator=gen, device="cuda"))
    inp = torch.relu(torch.randn(rows, h8, w8, 128, generator=gen, device="cuda"))
    corr = torch.randn(rows, h8, w8, 324, generator=gen, device="cuda")
    flow = torch.randn(rows, h8, w8, 2, generator=gen, device="cuda") * 4
    block = {}
    with torch.no_grad():
        for tag in ("gemm", "cudnn"):
            with cudnn_convs() if tag == "cudnn" else contextlib.nullcontext():
                def step():
                    n_, d_ = traft._update_block(params, net, inp, corr, flow)
                    return n_, d_, traft._upsample_mask(params, n_)
                before = profiling.counters().get("conv_gemm", 0)
                block[tag] = step()
                counted = profiling.counters().get("conv_gemm", 0) - before
                require(counted == (8 if tag == "gemm" else 0), f"conv_gemm counted {counted} on the {tag} path")
                if table:
                    block[tag + "_ms"] = time_ms(lambda: traft._update_block(params, net, inp, corr, flow), reps=7,
                                                 batch=2)
    errs = [(g - c).abs().max().item() for g, c in zip(block["gemm"], block["cudnn"])]
    require(max(errs) < 1e-3, f"update block on GEMMs against cuDNN: max abs err {errs}")
    res["update_block"] = dict(rows=MAIN_RAFT_ROWS, max_abs_err_net_delta_mask=errs)
    if table:
        res["update_block"].update(ms=block["gemm_ms"], cudnn_ms=block["cudnn_ms"])
        log(f"  update block, one iteration at {MAIN_RAFT_ROWS}: GEMMs {block['gemm_ms']:.3f} ms, cuDNN "
            f"{block['cudnn_ms']:.3f} ms")
    log(f"  update block at {MAIN_RAFT_ROWS}, GEMMs against cuDNN: max abs err (net, delta, mask) {errs}")
    res["clip"] = clip_fft_check()
    return res


@contextlib.contextmanager
def cudnn_convs():
    """Every conv on cuDNN: `ops/conv.py::GEMM_SITES` emptied."""
    from comfyui_propainter_nodes_tpu_torch.ops import conv

    saved = conv.GEMM_SITES
    conv.GEMM_SITES = frozenset()
    try:
        yield
    finally:
        conv.GEMM_SITES = saved


@contextlib.contextmanager
def gemm_under_autograd():
    """GEMM_SITES on `conv2d_gemm` with grad mode on too (the port keeps
    cuDNN there), the weights laid out in the graph each call."""
    from comfyui_propainter_nodes_tpu_torch.ops import conv

    saved = conv.gemm_site, conv.laid_weight
    conv.gemm_site = lambda site, x: site in conv.GEMM_SITES and x.is_cuda and x.dtype == torch.float32
    conv.laid_weight = lambda layout, ws, dtype: layout(*ws, dtype=dtype)
    try:
        yield
    finally:
        conv.gemm_site, conv.laid_weight = saved


def conv_gemm_times() -> int:
    """`--conv-gemm`: path T's training step (`tree_path_t_steps`) as the
    port runs it (cuDNN under autograd) and with GEMM_SITES on GEMMs there
    too (`gemm_under_autograd`), in turns, then `check_conv_gemm` (one
    JSON line; the sites' table also to chiprun_out/conv_gemm.json)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    weights_dir = weights_cache()
    steps = {"cudnn": [], "gemm": []}
    for tag in ("cudnn", "gemm", "gemm", "cudnn"):
        with gemm_under_autograd() if tag == "gemm" else contextlib.nullcontext():
            steps[tag] += tree_path_t_steps()
    path_t = {k: dict(steps=v, median=statistics.median(v)) for k, v in steps.items()}
    log(f"  path T's step, median s: cuDNN under autograd (the port) {path_t['cudnn']['median']:.4f}, GEMM_SITES on GEMMs "
        f"{path_t['gemm']['median']:.4f}")
    res = dict(check_conv_gemm(torch.Generator(device="cuda").manual_seed(0)), path_t_step_s=path_t)
    weights_dir.cleanup()
    line = dict(card=nvidia_smi(), torch=torch.__version__, conv_gemm=res)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "conv_gemm.json"), "w") as f:
        json.dump(line, f, indent=1)
    print(json.dumps(dict(line, conv_gemm={k: v for k, v in res.items() if k != "sites"})), flush=True)
    return 0


# path A's RAFT call: 4-frame clips at 1280x720, 3 pairs of 90x160 1/8-res maps
PATH_A_RAFT_CALL = (3, 90, 160)

# the outpaint canvas's RAFT call: 24 frames at 768x360, 23 pairs of 45x96
PATH_O_RAFT_CALL = (23, 45, 96)
PATH_O_CANVAS = (360, 768)

# path S: process_streaming over the synthetic clip at 1280x720, 240 frames
# (frames, height, width), default widgets
PATH_S = (240, 720, 1280)

# streaming against in-memory on the card: (frames, height, width)
STREAM_CLIP = (48, 360, 640)

# path S's RAFT calls: 4-frame clips, 3 or 4 pairs of 90x160 (path A's is 3)
PATH_S_RAFT_CALL = (4, 90, 160)

# RAFT's pyramid builds (corr_pyramid), bf16, (pairs, H8, W8): the main
# path's and the outpaint canvas's one call, and 1280x720's chunked calls
# of 4 and 3 pairs (the benchmark's 720p cell runs 5 of 4 and 1 of 3)
CORR_PYRAMID_CALLS = {"main": (23, 45, 80), "path_o": PATH_O_RAFT_CALL, "720p_4": PATH_S_RAFT_CALL,
                      "path_a": PATH_A_RAFT_CALL}


def check_corr_pyramid(gen):
    """The pyramid kernel against its plain version (the eager build) at
    each of CORR_PYRAMID_CALLS, both directions, 256 channels: level 0
    within one bf16 ulp of the plain value plus 2^-16 of sum |f1 f2| /
    sqrt(C) (the float32 sums' order), `max_abs_err` its largest
    difference; the backward level 0 bit for bit the transpose of the
    forward one; levels 1-3 bit for bit `pool_pyramid` of the kernel's
    level 0. Each call timed (kernel: ten back to back a sample; plain:
    one a sample). The bound: the maps read once and both directions'
    four levels written, against the product's operations."""
    from comfyui_propainter_nodes_tpu_torch.ops.cuda import corr_pyramid as mod

    res = {}
    c = 256
    for tag, (n, h, w) in CORR_PYRAMID_CALLS.items():
        f1, f2 = (torch.randn(n, h, w, c, generator=gen, device="cuda").to(torch.bfloat16) for _ in range(2))
        fwd, bwd = mod.corr_pyramids(f1, f2)
        want, _ = mod.corr_pyramids_plain(f1, f2, backward=False)
        a1, a2 = (f.reshape(n, h * w, c).float().abs() for f in (f1, f2))
        slack = torch.matmul(a1, a2.transpose(1, 2)).reshape(n * h * w, h, w) / math.sqrt(c) * 2.0**-16
        _, e = torch.frexp(want[0].float())
        err = (fwd[0].float() - want[0].float()).abs()
        beyond = int((err > torch.ldexp(torch.ones_like(err), e - 8) + slack).sum())
        require(beyond == 0, f"corr_pyramid {tag}: {beyond} level-0 values beyond one bf16 ulp and the sums' slack")
        max_err = float(err.max())
        del want, a1, a2, slack, e, err
        require(torch.equal(bwd[0].reshape(n, h * w, h * w), fwd[0].reshape(n, h * w, h * w).transpose(1, 2)),
                f"corr_pyramid {tag}: the backward level 0 is not the forward one transposed")
        for d, pyr in (("forward", fwd), ("backward", bwd)):
            pooled = mod.pool_pyramid(pyr[0])
            for lvl in range(1, 4):
                require(torch.equal(pyr[lvl], pooled[lvl]),
                        f"corr_pyramid {tag}: {d} level {lvl} is not the plain pooling of the kernel's level 0")
        del fwd, bwd, pooled
        torch.cuda.empty_cache()
        ms = time_ms(lambda: mod.corr_pyramids(f1, f2))
        plain_ms = time_ms(lambda: mod.corr_pyramids_plain(f1, f2), reps=5, warmup=1, batch=1)
        hw = h * w
        written = 2 * sum(n * hw * (h >> lvl) * (w >> lvl) for lvl in range(4)) * 2
        bound, by = bound_ms(2.0 * n * hw * hw * c, written + 2 * n * hw * c * 2, torch.bfloat16)
        res[tag] = dict(call=(n, h, w), max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                        library_ms=None, written_bytes=written)
        log(f"  corr_pyramid bf16 {tag} ({n} pairs of {h}x{w}): level 0 within tolerance (max abs err {max_err:.3g}), "
            f"levels 1-3 and the transpose bit-equal; ms {ms:.4f}  plain_ms {plain_ms:.4f}  bound_ms {bound:.4f} "
            f"({by}, {written / 1e9:.3f} GB written), kernel / bound {ms / bound:.2f}")
        del f1, f2
        torch.cuda.empty_cache()
    return res


# path H: process_streaming over the synthetic clip at 1920x1080, 120 frames
# (the JAX package's scripts/bench_configs.py config 5), default widgets;
# its RAFT calls: 3-frame clips, 1 or 2 pairs of 135x240
PATH_H = (120, 1080, 1920)
PATH_H_RAFT_CALL = (2, 135, 240)

# paths C and M at 640x360: path C's one clip-parallel RAFT call (9 chunks
# of 12 pairs of 45x80) and path M (1, 2)'s, one chunk a call
PATH_C_RAFT_CALL = (108, 45, 80)
PATH_M_RAFT_CALL = (12, 45, 80)

# B2's shapes: the node's feature propagation (x [5, H/4, W/4, 128], cg 8)
# and flow completion (x [2, H/8, W/8, 256], cg 16), at 640x360, 1280x720 and
# on the 768x360 outpaint canvas; path S's feature propagation, one window a
# call (x [1, ...]); path H's completion and feature propagation at 1920x1080;
# path C's batched completion (2 chunks, both directions) and window groups
# of 8 and 4 at 640x360 (path M (2, 1)'s: fc and fpC4); path T's feature
# propagation (2 clips of 10 local frames at 432x240)
B2_SHAPES = {
    "fp": (5, 90, 160, 128), "fc": (2, 45, 80, 256), "fp720": (5, 180, 320, 128), "fc720": (2, 90, 160, 256),
    "fpO": (5, 90, 192, 128), "fcO": (2, 45, 96, 256), "fpS": (1, 180, 320, 128),
    "fcH": (2, 135, 240, 256), "fpH": (1, 270, 480, 128),
    "fcC": (4, 45, 80, 256), "fpC": (8, 90, 160, 128), "fpC4": (4, 90, 160, 128), "fpT": (2, 60, 108, 128),
}
# the shapes a path also runs in fp32 (fp720 and fc720: path MH's single card)
B2_FP32 = ("fp", "fc", "fp720", "fc720", "fpO", "fcO", "fcC", "fpC", "fpC4", "fpT")
# B2's row form at path MH's per-rank shapes (both dtypes): x [5, 180, 320,
# 128] whole, each rank's 96 output rows (its 90 widened by 6, clamped)
B2_ROWS = {"fpMH0": ((5, 180, 320, 128), (0, 96)), "fpMH1": ((5, 180, 320, 128), (84, 96))}


def deform_inputs(dt, gen, shape, rows=None):
    """B2's inputs at x's shape; offsets and mask for rows[1] output rows
    where rows = (row0, Ho) is given."""
    n, h, w, cin = shape
    ho = h if rows is None else rows[1]
    g, cout = 16, 128
    x = torch.randn(n, h, w, cin, generator=gen, device="cuda").to(dt)
    off = (torch.randn(n, ho, w, g, 9, 2, generator=gen, device="cuda") * 3.0).to(dt)
    mask = torch.rand(n, ho, w, g, 9, generator=gen, device="cuda").to(dt)
    wt = (torch.randn(cout, cin, 3, 3, generator=gen, device="cuda") / math.sqrt(9 * cin)).to(dt)
    bias = (torch.randn(cout, generator=gen, device="cuda") * 0.05).to(dt)
    return x, off, mask, wt, bias


def deform_bound(shape, m: int, cout: int, dt) -> tuple[float, str]:
    """B2's bound for x's shape and m output pixels: its operations, and x,
    the offsets and mask (16 groups), the output, weights and bias each
    moved once."""
    n, h, w, cin = shape
    esz = torch.finfo(dt).bits // 8
    nbytes = (n * h * w * cin + m * 16 * 27 + m * cout) * esz + 9 * cin * cout * esz + cout * esz
    return bound_ms(2.0 * m * 9 * cin * cout, nbytes, dt)


def check_deform_conv(dt, gen, shape, rows=None):
    """B2 against its plain version; bf16 is also timed with each pixel
    tile of the tensor-core kernel (64 and 32 pixels a block), fp32 with
    each tap split of the CUDA-core kernel (1, 3 and 9 blocks over the
    taps), each held against the plain version first. rows = (row0, Ho):
    the row form, Ho output rows from x's row row0."""
    from comfyui_propainter_nodes_tpu_torch.ops.cuda import deform_conv as mod

    args = deform_inputs(dt, gen, shape, rows)
    row0 = 0 if rows is None else rows[0]
    x, cout = args[0], args[3].shape[0]
    out = mod.deform_conv2d(*args, row0=row0)
    torch.cuda.synchronize()
    ref = mod.deform_conv2d_plain(*args, row0=row0)
    err, rel = rel_err(out, ref)
    tol = 1e-4 if dt == torch.float32 else 1e-2  # 9*Cin-term fp32 sums; bf16 samples and output rounding
    form = "" if rows is None else f" rows [{row0}, {row0 + rows[1]})"
    log(f"  B2 deform_conv {str(dt)[6:]} x{list(shape)}{form}: max_abs_err {err:.3e} rel {rel:.3e} (tol rel {tol})")
    require(rel <= tol, "deform_conv2d disagrees with its plain version")
    n, h, w, cin = shape
    ho = h if rows is None else rows[1]
    tiles, splits = {}, {}
    if dt == torch.bfloat16:
        chosen = mod.block_rows(n * ho * w, cout, x.device)
        pick = mod.block_rows
        try:
            for bm in (64, 32):
                mod.block_rows = lambda m, c, d, bm=bm: bm  # noqa: E731
                tiles[bm] = time_ms(lambda: mod.deform_conv2d(*args, row0=row0))
        finally:
            mod.block_rows = pick
    else:
        chosen = mod.tap_splits(n * ho * w, cout, x.device)
        pick = mod.tap_splits
        try:
            for sp in mod.TAP_SPLITS:
                mod.tap_splits = lambda m, c, d, sp=sp: sp  # noqa: E731
                once = mod.deform_conv2d(*args, row0=row0)
                _, r = rel_err(once, ref)
                require(r <= tol, f"deform_conv2d fp32 in {sp} tap splits disagrees with its plain version: rel {r:.3e}")
                require(torch.equal(once, mod.deform_conv2d(*args, row0=row0)), f"B2 fp32 in {sp} tap splits: two calls differ")
                splits[sp] = time_ms(lambda: mod.deform_conv2d(*args, row0=row0))
        finally:
            mod.tap_splits = pick
    del ref
    ms = time_ms(lambda: mod.deform_conv2d(*args, row0=row0))
    ms_single = time_ms(lambda: mod.deform_conv2d(*args, row0=row0), batch=1)
    plain_ms = time_ms(lambda: mod.deform_conv2d_plain(*args, row0=row0), reps=5, warmup=1, batch=1)
    bound, by = deform_bound(shape, n * ho * w, cout, dt)
    log(f"    ms {ms:.4f} (one call a sample {ms_single:.4f})  plain_ms {plain_ms:.4f}  bound_ms {bound:.4f} ({by}, "
        f"{100 * bound / ms:.1f}% of it)  library_ms null"
        + (f"; by pixel tile: 64 {tiles[64]:.4f}, 32 {tiles[32]:.4f} (the wrapper picks {chosen})" if tiles else "")
        + (f"; by tap split: " + ", ".join(f"{sp} {v:.4f}" for sp, v in splits.items())
           + f" (the wrapper picks {chosen})" if splits else ""))
    res = dict(max_abs_err=err, ms=ms, ms_single=ms_single, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
               library_ms=None)
    if tiles:
        res.update(ms_tile64=tiles[64], ms_tile32=tiles[32], tile=chosen)
    if splits:
        res.update(ms_by_tap_split={str(sp): v for sp, v in splits.items()}, tap_split=chosen)
    return res


def attention_biases(b, t, t_sel, per_key):
    """t_ind frames (every other one: from frame 0 when t_sel is ceil(t / 2),
    else from frame 1) and one padded ref frame, the last, in batch row 1
    (row 0 when b is 1): bias_w [B, T*45] and one [B, T_sel*n] bias per
    segment length n."""
    tv = torch.ones(b, t, dtype=torch.bool, device="cuda")
    tv[min(1, b - 1), -1] = False
    in_tind = (torch.arange(t, device="cuda") % 2) == (0 if t_sel == (t + 1) // 2 else 1)
    bias_w = torch.where(in_tind[None] & tv, 0.0, -1e9).repeat_interleave(45, 1).float().contiguous()
    sel = tv[:, in_tind]
    return [bias_w] + [torch.where(sel, 0.0, -1e9).repeat_interleave(n, 1).float().contiguous() for n in per_key]


def sdpa_library(qs, k_all, v_all, bias, occ, wsz, grad=False):
    """The same function as ONE library call: SDPA over each window's
    [window | rolled (or halo) | pooled] keys with an additive mask
    (block-diagonal per frame for clean windows). qs [W, head, QT, ch],
    k_all/v_all [W, head, L, ch], bias [W, L]. grad: the call's forward
    and backward (the gradients of q, k and v for a seeded output
    gradient)."""
    qt = qs.shape[2]
    fid = torch.arange(qt, device="cuda") // wsz
    clean = torch.full((qt, k_all.shape[2]), -1e9, device="cuda")
    clean[:, :qt] = torch.where(fid[:, None] == fid[None, :], 0.0, -1e9)
    amask = torch.where(occ[:, None, None], bias[:, None, :], clean[None]).to(qs.dtype)[:, None]
    if not grad:
        return lambda: F.scaled_dot_product_attention(qs, k_all, v_all, attn_mask=amask)
    leaves = [a.detach().requires_grad_() for a in (qs, k_all, v_all)]
    gout = torch.randn(qs.shape, generator=torch.Generator(device="cuda").manual_seed(1), device="cuda").to(qs.dtype)
    return lambda: torch.autograd.grad(F.scaled_dot_product_attention(*leaves, attn_mask=amask), leaves, gout)


def attention_bound(dt, nh, qt, wsz, ch, rl, pl_len, occ, n_win):
    """Flops of occupied windows over all their keys and of clean windows
    within frames; bytes of q/k/v/out, occupied windows' rolled (or
    survivor halo) keys, pooled keys of rows with an occupied window, biases."""
    nw = occ.numel()
    n_occ = int(occ.sum())
    flops = nh * (n_occ * 4.0 * qt * (qt + rl + pl_len) * ch + (nw - n_occ) * 4.0 * qt * wsz * ch)
    esz = 2 if dt == torch.bfloat16 else 4
    occ_rows = int(occ.reshape(-1, n_win).any(1).sum())
    b = nw // n_win
    nbytes = esz * ch * nh * (nw * qt * 4 + n_occ * rl * 2 + occ_rows * pl_len * 2) + 4 * b * (qt + rl + pl_len)
    return bound_ms(flops, nbytes, dt)


def attention_inputs(dt, gen, n_win, t_sel, pl_per, occ, b=5, t=13):
    """A layer's attention inputs: b batch rows (windows of the sliding
    window loop) of t frames, n_win token windows a row; by default a
    24-frame node's group of 5 windows of 13 frames."""
    nh, wsz, ch = 4, 45, 128
    rl, pl_len = t_sel * 148, t_sel * pl_per
    nw = b * n_win

    def rnd(*s):
        return torch.randn(*s, generator=gen, device="cuda").to(dt)

    arrays = [rnd(nw, nh, t, wsz, ch), rnd(nw, nh, t, wsz, ch), rnd(nw, nh, t, wsz, ch),
              rnd(nw, nh, rl, ch), rnd(nw, nh, rl, ch), rnd(b, nh, pl_len, ch), rnd(b, nh, pl_len, ch)]
    return arrays + [occ] + attention_biases(b, t, t_sel, (148, pl_per))


def attention_library(args, n_win, grad=False):
    q, k, v, rk, rv, pk, pv, occ, bias_w, bias_r, bias_p = args
    nw, nh, t, wsz, ch = q.shape
    qt = t * wsz
    k_all = torch.cat([k.reshape(nw, nh, qt, ch), rk, pk.repeat_interleave(n_win, 0)], 2)
    v_all = torch.cat([v.reshape(nw, nh, qt, ch), rv, pv.repeat_interleave(n_win, 0)], 2)
    bias = torch.cat([bias_w, bias_r, bias_p], 1).repeat_interleave(n_win, 0)
    return sdpa_library(q.reshape(nw, nh, qt, ch), k_all, v_all, bias, occ, wsz, grad)


def check_window_attention(dt, gen, t_sel, occ, n_win=36, pl_per=91, grid="30x54"):
    """B3 at a token grid's shapes: the main path's 30x54 (640x360; 36
    windows a row, 91 pooled keys a frame) by default, or path O's 30x64
    padded to 30x72 (768x360; 48 windows, 126 pooled keys)."""
    from comfyui_propainter_nodes_tpu_torch.ops.cuda import window_attention as mod

    args = attention_inputs(dt, gen, n_win, t_sel, pl_per, occ)
    tiled = mod.uses_tiled(args[0], args[3], args[5])
    require(dt != torch.bfloat16 or not tiled, f"B3's bf16 shapes at grid {grid} must take the single-pass kernel")
    out = mod.window_attention(*args, n_win_per_b=n_win)
    torch.cuda.synchronize()
    ref = mod.window_attention_plain(*args, n_win)
    err, rel = rel_err(out, ref)
    tol = 1e-4 if dt == torch.float32 else 2e-2  # softmax over ~2k keys; bf16 output rounding
    nw = occ.numel()
    log(f"  B3 window_attention {str(dt)[6:]} grid {grid} t_sel={t_sel}: occupied {int(occ.sum())}/{nw}; "
        f"max_abs_err {err:.3e} rel {rel:.3e} (tol rel {tol}); the dispatcher's choice here: "
        f"{'tiled (B4)' if tiled else 'single pass (B3)'}")
    require(rel <= tol, "window_attention disagrees with its plain version")
    ms = time_ms(lambda: mod.window_attention(*args, n_win_per_b=n_win))
    clean = args[:7] + [torch.zeros_like(occ)] + args[8:]
    clean_ms = time_ms(lambda: mod.window_attention(*clean, n_win_per_b=n_win))
    plain_ms = time_ms(lambda: mod.window_attention_plain(*args, n_win), reps=3, warmup=1, batch=1)
    lib = attention_library(args, n_win)
    lib_err, _ = rel_err(lib().reshape(out.shape), ref)
    library_ms = time_ms(lib, reps=5, warmup=1)
    bound, by = attention_bound(dt, 4, 13 * 45, 45, 128, t_sel * 148, t_sel * pl_per, occ, n_win)
    log(f"    ms {ms:.4f}  plain_ms {plain_ms:.4f}  bound_ms {bound:.4f} ({by})  "
        f"library_ms {library_ms:.4f} (SDPA, err vs plain {lib_err:.3e}); every window clean {clean_ms:.4f}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=library_ms, occupied_share=int(occ.sum()) / nw, all_clean_ms=clean_ms,
                grid=grid, t_sel=t_sel)


def check_window_attention_tiled(dt, gen, t_sel, occ, b=5, t=13, n_win=144, pl_per=405):
    """B4 and B3 on the same inputs, by default at the 1280x720 shapes (144
    windows per batch row, pooled segment t_sel * 405 keys) of path A's 5
    windows of 13 frames; path S's is one window of 19 (b=1, t=19), path
    H's one window of 19 at 1920x1080 (324 windows, t_sel * 880 keys)."""
    from comfyui_propainter_nodes_tpu_torch.ops.cuda import window_attention as mod

    args = attention_inputs(dt, gen, n_win, t_sel, pl_per, occ, b, t)
    require(mod.uses_tiled(args[0], args[3], args[5]), f"the shapes of {n_win} windows must take the tiled kernel")
    out = mod.window_attention_tiled(*args, n_win_per_b=n_win)
    torch.cuda.synchronize()
    ref = mod.window_attention_tiled_plain(*args, n_win)
    err, rel = rel_err(out, ref)
    tol = 1e-4 if dt == torch.float32 else 2e-2  # softmax over ~4.5k keys; bf16 output rounding
    nw = occ.numel()
    log(f"  B4 window_attention_tiled {str(dt)[6:]} b={b} t={t} t_sel={t_sel} windows {n_win}: occupied {int(occ.sum())}/{nw}; "
        f"max_abs_err {err:.3e} rel {rel:.3e} (tol rel {tol})")
    require(rel <= tol, "window_attention_tiled disagrees with its plain version")
    del ref
    ms = time_ms(lambda: mod.window_attention_tiled(*args, n_win_per_b=n_win))
    b3_ms = time_ms(lambda: mod.window_attention(*args, n_win_per_b=n_win))
    plain_ms = time_ms(lambda: mod.window_attention_tiled_plain(*args, n_win), reps=3, warmup=1, batch=1)
    lib = attention_library(args, n_win)
    lib_err, _ = rel_err(lib().reshape(out.shape), out)
    library_ms = time_ms(lib, reps=5, warmup=1)
    bound, by = attention_bound(dt, 4, t * 45, 45, 128, t_sel * 148, t_sel * pl_per, occ, n_win)
    log(f"    ms {ms:.4f}  B3 on the same inputs {b3_ms:.4f}  plain_ms {plain_ms:.4f}  bound_ms {bound:.4f} ({by})  "
        f"library_ms {library_ms:.4f} (SDPA, err vs kernel {lib_err:.3e})")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=library_ms, b3_ms=b3_ms, occupied_share=int(occ.sum()) / nw, b=b, t=t, t_sel=t_sel,
                n_win=n_win)


def halo_inputs(dt, gen, b, t, t_sel, grid, occ):
    """B5's inputs on a window-padded token grid [b, t, Hp, Wp, 512], 4
    heads, t_ind every other frame from frame 0, t_sel of them, pooled keys
    (Hp / 4) x (Wp / 4) a frame, occ [b * windows]."""
    c, nh = 512, 4
    hp, wp = grid
    pl_per = (hp // 4) * (wp // 4)

    def rnd(*s):
        return torch.randn(*s, generator=gen, device="cuda").to(dt)

    q, k, v = rnd(b, t, hp, wp, c), rnd(b, t, hp, wp, c), rnd(b, t, hp, wp, c)
    ti = torch.arange(0, 2 * t_sel, 2, device="cuda")

    def cpad(a):
        a = a.index_select(1, ti)
        a = torch.cat([a[:, :, -3:], a, a[:, :, :3]], 2)
        return torch.cat([a[:, :, :, -5:], a, a[:, :, :, :5]], 3).contiguous()

    pk, pv = rnd(b, nh, t_sel * pl_per, c // nh), rnd(b, nh, t_sel * pl_per, c // nh)
    bias_w, bias_hv, bias_p = attention_biases(b, t, t_sel, (1, pl_per))
    return (q, k, v, cpad(k), cpad(v), pk, pv, occ.reshape(b, hp // 5, wp // 9), bias_w, bias_hv, bias_p)


def check_window_attention_halo(dt, gen, grid, occ):
    """B5 at a window-padded token grid [5, 13, Hp, Wp, 512], t_sel 7."""
    from comfyui_propainter_nodes_tpu_torch.ops.cuda import window_attention_halo as mod

    b, t, t_sel, nh = 5, 13, 7, 4
    hp, wp = grid
    wh, ww = 5, 9
    nwh, nww = hp // wh, wp // ww
    pl_per = (hp // 4) * (wp // 4)
    args = halo_inputs(dt, gen, b, t, t_sel, grid, occ)
    q, k, v, _, _, pk, pv, occ3, bias_w, bias_hv, bias_p = args
    kw = dict(window_size=(wh, ww), n_head=nh)
    out = mod.window_attention_halo(*args, **kw)
    torch.cuda.synchronize()
    ref = mod.window_attention_halo_plain(*args, **kw)
    err, rel = rel_err(out, ref)
    tol = 1e-4 if dt == torch.float32 else 2e-2
    log(f"  B5 window_attention_halo {str(dt)[6:]} grid {hp}x{wp}: occupied {int(occ.sum())}/{occ.numel()}; "
        f"max_abs_err {err:.3e} rel {rel:.3e} (tol rel {tol})")
    require(rel <= tol, "window_attention_halo disagrees with its plain version")
    del ref
    ms = time_ms(lambda: mod.window_attention_halo(*args, **kw))
    clean = args[:7] + (torch.zeros_like(occ3),) + args[8:]
    clean_ms = time_ms(lambda: mod.window_attention_halo(*clean, **kw))
    plain_ms = time_ms(lambda: mod.window_attention_halo_plain(*args, **kw), reps=3, warmup=1, batch=1)
    # library: SDPA over [window | halo | pooled] keys per window
    qw = mod._windows(q, (wh, ww), nh)
    nw, _, _, wsz, ch = qw.shape
    qt = t * wsz
    kw_, vw_ = mod._windows(k, (wh, ww), nh), mod._windows(v, (wh, ww), nh)
    k_all = torch.cat([kw_.reshape(nw, nh, qt, ch), mod._halo_windows(args[3], (wh, ww), nh),
                       pk.repeat_interleave(nwh * nww, 0)], 2)
    v_all = torch.cat([vw_.reshape(nw, nh, qt, ch), mod._halo_windows(args[4], (wh, ww), nh),
                       pv.repeat_interleave(nwh * nww, 0)], 2)
    bias = torch.cat([bias_w, mod._halo_bias(bias_hv, (wh, ww)).reshape(b, -1), bias_p], 1)
    lib = sdpa_library(qw.reshape(nw, nh, qt, ch), k_all, v_all, bias.repeat_interleave(nwh * nww, 0), occ, wsz)
    lib_out = lib().reshape(b, nwh, nww, nh, t, wh, ww, ch).permute(0, 4, 1, 5, 2, 6, 3, 7).reshape(out.shape)
    lib_err, _ = rel_err(lib_out, out)
    library_ms = time_ms(lib, reps=5, warmup=1)
    bound, by = attention_bound(dt, nh, qt, wsz, ch, t_sel * 148, t_sel * pl_per, occ, nwh * nww)
    log(f"    ms {ms:.4f}  plain_ms {plain_ms:.4f}  bound_ms {bound:.4f} ({by})  "
        f"library_ms {library_ms:.4f} (SDPA over the halo, err vs kernel {lib_err:.3e}); every window clean {clean_ms:.4f}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                library_ms=library_ms, occupied_share=int(occ.sum()) / occ.numel(), all_clean_ms=clean_ms)


def token_pool(md):
    """The dilated masks md [t, h, w] at 1/4 res, pooled 7x7/3 to the
    token grid and padded to whole 5x9 windows: [t, Hp, Wp, 1]."""
    from comfyui_propainter_nodes_tpu_torch.models import propainter as pp

    t, h, w = md.shape
    pool = pp.attention_pool_mask(pp.downsample_mask(md[None, ..., None], h // 4, w // 4))[0]
    fh, fw = pool.shape[1], pool.shape[2]
    return F.pad(pool, (0, 0, 0, -fw % 9, 0, -fh % 5))


def occupied(loc):
    """[n_win] bool: the token windows any of a sliding window's local
    frames touches, loc [l_t, Hp, Wp, 1] (ops/attention.py)."""
    from comfyui_propainter_nodes_tpu_torch.ops.pool import max_pool2d

    return max_pool2d(loc, (5, 9), (5, 9)).sum(0).reshape(-1) > 0


def window_occupancy(md):
    """Which 5x9 token windows of a 24-frame node run are occupied, for
    each of its 5 sliding windows, from the dilated masks md [24, h, w]."""
    from comfyui_propainter_nodes_tpu_torch.config import PipelineConfig
    from comfyui_propainter_nodes_tpu_torch.pipeline.stages import _window_tables

    pool = token_pool(md)
    sels, valids, _, _, _, _, l_t_max, _ = _window_tables(PipelineConfig(), md.shape[0])
    occ = []
    for wi in range(sels.shape[0]):
        vl = torch.as_tensor(valids[wi, :l_t_max], device="cuda")[:, None, None, None]
        occ.append(occupied(pool[torch.as_tensor(sels[wi, :l_t_max], device="cuda")] * vl))
    return torch.cat(occ)


def clip_occupancy(h: int, w: int, t: int = 24):
    """The inpaint node's occupancy on the synthetic t-frame h x w clip."""
    from comfyui_propainter_nodes_tpu_torch.ops.dilation import binary_dilation

    _, masks = synthetic_clip(t, h, w)
    return window_occupancy(binary_dilation(torch.from_numpy(masks != 0).float().cuda(), WIDGETS["mask_dilates"]))


def stream_window(t: int):
    """(frames of one streaming window's attention, t_sel of its even and
    odd layers, its local frames): the middle window of a t-frame clip at
    default widgets (for 120 and 240 frames, 11 local and 8 reference
    slots)."""
    from comfyui_propainter_nodes_tpu_torch.config import PipelineConfig
    from comfyui_propainter_nodes_tpu_torch.pipeline.stages import _window_tables

    sels, _, starts, lts, _, _, l_t_max, ref_max = _window_tables(PipelineConfig(), t)
    wi = sels.shape[0] // 2
    t_win = l_t_max + ref_max
    return t_win, ((t_win + 1) // 2, t_win // 2), list(range(int(starts[wi]), int(starts[wi] + lts[wi])))


def stream_occupancy(path):
    """A streaming path's occupancy: the middle window's local frames of
    its (t, h, w) clip (144 token windows of the 60x108 grid at 1280x720,
    324 of the 90x162 grid at 1920x1080)."""
    from comfyui_propainter_nodes_tpu_torch.ops.dilation import binary_dilation

    t, h, w = path
    base = clip_base(h, w)
    masks = np.stack([clip_frame(base, i)[1] for i in stream_window(t)[2]])
    md = binary_dilation(torch.from_numpy(masks != 0).float().cuda(), WIDGETS["mask_dilates"])
    return occupied(token_pool(md))


def group_occupancy(path):
    """Path C's middle window group on its (t, h, w) clip: (the windows in
    the group, their occupancy [b * n_win]); 100 frames hold 20 sliding
    windows, batched 8, 8 and 4 a transformer call."""
    from comfyui_propainter_nodes_tpu_torch.config import PipelineConfig
    from comfyui_propainter_nodes_tpu_torch.pipeline.stages import _window_group_size, _window_tables

    t, h, w = path
    occ = clip_occupancy(h, w, t)
    n_windows = _window_tables(PipelineConfig(), t)[0].shape[0]
    g = _window_group_size(n_windows, 1)
    starts = list(range(0, n_windows, g))
    lo = starts[len(starts) // 2]
    b, n_win = min(g, n_windows - lo), occ.numel() // n_windows
    return b, occ[lo * n_win : (lo + b) * n_win]


def ring_occupancy():
    """Path O's occupancy: the outpaint ring of 640x360 frames on the
    768x360 canvas, every frame (a 30x64 token grid padded to 30x72)."""
    from comfyui_propainter_nodes_tpu_torch.utils.image import ring_masks

    ring = ring_masks((360, 640), PATH_O_CANVAS, "cuda")[1]
    return window_occupancy(ring[None].expand(24, *PATH_O_CANVAS).contiguous())


# ------------------------------------------------------------------ phase 3


def clip_base(h: int, w: int):
    """The synthetic clip's gradient background [h, w, 3] in [0, 1]."""
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([yy / h, xx / w, (yy + xx) / (h + w)], axis=-1).astype(np.float32)


def clip_frame(base, i: int):
    """Frame i of the synthetic clip and its mask, uint8: a box moving 3 px
    right and 1 px down a frame over the gradient."""
    h, w = base.shape[:2]
    frame = base.copy()
    mask = np.zeros((h, w), dtype=np.float32)
    x0 = int(w * 0.2) + 3 * i
    y0 = int(h * 0.3) + i
    frame[y0 : y0 + h // 6, x0 : x0 + w // 8] = [1.0, 0.2, 0.2]
    mask[y0 : y0 + h // 6, x0 : x0 + w // 8] = 1.0
    return (frame * 255).astype(np.uint8), (mask * 255).astype(np.uint8)


def synthetic_clip(t: int, h: int, w: int):
    """Moving box over a gradient (the JAX package's bench clip): frames
    [t, h, w, 3] and masks [t, h, w], uint8."""
    base = clip_base(h, w)
    pairs = [clip_frame(base, i) for i in range(t)]
    return np.stack([f for f, _ in pairs]), np.stack([m for _, m in pairs])


WIDGETS = dict(
    mask_dilates=5, flow_mask_dilates=8, ref_stride=10, neighbor_length=10,
    subvideo_length=80, raft_iter=20, fp16="enable", _allow_random_weights=True,
)


# every launch counter of the port (utils/profiling.py::kernel): the kernels'
# by their rows' names, and `conv_gemm`, the float32 convs of GEMM_SITES on cuBLAS
KERNELS = ("corr_lookup", "corr_lookup_map", "deform_conv", "window_attention", "window_attention_tiled",
           "window_attention_halo", "corr_window4", "corr_window", "conv_gemm", "prop_fill", "corr_pyramid")


# each counter's kernel as the profiler names it on the node's bf16 paths
PROFILED = {
    "corr_lookup": "corr_lookup_kernel", "corr_lookup_map": "corr_lookup_map_kernel",
    "deform_conv": "deform_conv_mma_kernel",
    "window_attention": "window_attention_mma_kernel", "window_attention_tiled": "window_attention_split_mma_kernel",
    "window_attention_halo": "window_attention_halo_mma_kernel", "corr_window4": "corr_window4_kernel",
    "corr_window": "corr_window_kernel", "prop_fill": "prop_fill_kernel", "corr_pyramid": "corr_pyramid_kernel",
}


def drive(tag, node, run, t, need, forbid, switched=False, profile_name=None):
    """Warm-up, timed run (counters reset just before it, read just
    after), profiled run of a node's `run`. `need` kernels must have
    launched in the timed run, `forbid` kernels must not. Returns the
    timed run's outputs and its summary."""
    from comfyui_propainter_nodes_tpu_torch.utils import profiling

    with switches(switched):
        t0 = time.perf_counter()
        run()
        log(f"  warm-up run {time.perf_counter() - t0:.3f} s")
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        profiling.reset_stages()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        wall = time.perf_counter() - t0
        counts, b2_shapes = read_counters()
        card_io = card_io_since()
        forms = raft_forms_since()
        stages = stage_seconds()
        peak = torch.cuda.max_memory_allocated()
        log(f"  [{tag}] timed run {wall:.3f} s = {t / wall:.3f} frames/s; stages (s): "
            + ", ".join(f"{k} {v:.4f}" for k, v in stages.items()))
        log(f"  [{tag}] max_memory_allocated {peak / 2**30:.3f} GiB; launches {counts}; B2 launches by x shape {b2_shapes}")
        prof = profile_run(run, wall, profile_name)

    require_kernels(tag, counts, need, forbid)
    require(card_io == 1, f"{tag}: node_card_io counted {card_io} in one call of a clip at the process size")
    if prof is not None:
        require(all(prof["kernels_ms"][PROFILED[k]] > 0 for k in need),
                f"{tag}: a kernel of the path has no device time in the profile: {prof['kernels_ms']}")
        # `conv_gemm` runs cuBLAS's kernels, which no profiled name singles out
        require(all(prof["kernels_ms"][PROFILED[k]] == 0 for k in forbid if k in PROFILED),
                f"{tag}: a kernel off the path has device time in the profile: {prof['kernels_ms']}")
    summary = dict(frames=t, switches=switched, seconds=wall, fps=t / wall, stages=stages,
                   peak_bytes=peak, launches=counts, b2_launches_by_shape=b2_shapes, card_io=card_io,
                   raft_forms=forms, profile=prof)
    return out, summary


def node_run(tag, h, w, need, forbid, switched=False, profile_name=None):
    """The inpaint node on a 24-frame h x w clip (`drive`), and its output
    checks: outside the dilated mask the output is the input, exactly."""
    from comfyui_propainter_nodes_tpu_torch.nodes import ProPainterInpaint
    from comfyui_propainter_nodes_tpu_torch.pipeline.stages import crop_decode_ok

    t = 24
    frames, masks = synthetic_clip(t, h, w)
    node = ProPainterInpaint(device="cuda")

    def run():
        return node.propainter_inpainting(frames, masks, width=w, height=h, **WIDGETS)

    (img, fm, md), summary = drive(tag, node, run, t, need, forbid, switched, profile_name)
    require(tuple(img.shape) == (t, h, w, 3) and img.dtype == torch.float32, (img.shape, img.dtype))
    require(tuple(fm.shape) == (t, h, w) and tuple(md.shape) == (t, h, w), (fm.shape, md.shape))
    img_np, md_np = img.numpy(), md.numpy()
    require(np.isfinite(img_np).all() and img_np.min() >= 0.0 and img_np.max() <= 1.0, "IMAGE must be finite and in [0, 1]")
    require(set(np.unique(fm.numpy())) <= {0.0, 1.0} and set(np.unique(md_np)) <= {0.0, 1.0}, "masks must be binary")
    outside = md_np == 0
    orig = frames.astype(np.float32) / 255.0
    err_out = float(np.abs(img_np - orig)[outside].max())
    require(err_out < 1e-6, f"{tag}: output differs from the input outside the dilated mask: {err_out}")
    require(md_np.sum() > 0 and (np.abs(img_np - orig)[~outside]).max() > 0, "the masked region must be inpainted")
    log(f"  [{tag}] crop (y0, x0, ch, cw) {node.last_crop}, decoded alone: {crop_decode_ok((h, w), node.last_crop)}")
    summary.update(size=f"{w}x{h}", crop=node.last_crop)
    return summary, img_np, md_np


# path O's bf16 bands against the same node's fp32 bands on the card:
# mean and 99th percentile of |bf16 - fp32| over the band pixels, in
# [0, 1] units; about 5x the H100's readings of 0.00109 and 0.00392
# (PERF.md), a fifteenth of the fp32 bands' own spread
BAND_TOL_MEAN, BAND_TOL_P99 = 0.005, 0.02


def outpaint_run(need, forbid):
    """Path O: the outpaint node at default widgets on 24 frames of
    640x360 (a 768x360 canvas, `drive`), and its output checks: the
    interior is the input exactly, both bands are painted, the mask is
    the ring and the size is the canvas's. The interior is the input's
    bytes (the composite keeps them), so the bands are all the card
    computes: they are held
    against the same node at fp16="disable" on the card (fp32 RAFT and
    B2, attention through B4's fp32 loop, which the dispatcher's
    estimate picks for fp32 at these shapes)."""
    from comfyui_propainter_nodes_tpu_torch.nodes import ProPainterOutpaint

    t, h, w = 24, 360, 640
    frames, _ = synthetic_clip(t, h, w)
    node = ProPainterOutpaint(device="cuda")

    def run(widgets=WIDGETS):
        return node.propainter_outpainting(frames, width=w, height=h, width_scale=1.2, height_scale=1.0, **widgets)

    tag = "path O outpaint 768x360"
    (img, mask, ow, oh), summary = drive(tag, node, run, t, need, forbid, profile_name="profile_outpaint.txt")
    require((ow, oh) == (768, 360), f"{tag}: output size {(ow, oh)}")
    require(tuple(img.shape) == (t, oh, ow, 3) and img.dtype == torch.float32, (img.shape, img.dtype))
    img_np = img.numpy()
    require(np.isfinite(img_np).all() and img_np.min() >= 0.0 and img_np.max() <= 1.0, "IMAGE must be finite and in [0, 1]")
    w_start = (ow - w) // 2
    require(np.array_equal(img_np[:, :, w_start : w_start + w], frames.astype(np.float32) / 255.0),
            f"{tag}: the interior differs from the input")
    bands = (img_np[:, :, :w_start], img_np[:, :, w_start + w :])
    require(all(b.max() > 0 for b in bands), f"{tag}: a band is all zero")
    ref_np = run(dict(WIDGETS, fp16="disable"))[0].numpy()
    ref_bands = (ref_np[:, :, :w_start], ref_np[:, :, w_start + w :])
    d = np.concatenate([np.abs(a - b).ravel() for a, b in zip(bands, ref_bands)])
    spread = float(np.mean([np.abs(b - b.mean()).mean() for b in ref_bands]))
    vs_fp32 = dict(mean=float(d.mean()), p99=float(np.quantile(d, 0.99)), max=float(d.max()),
                   share_over_1_255=float((d > 1.5 / 255).mean()), fp32_band_spread=spread)
    log(f"  [{tag}] bands vs the fp32 node on the card: mean |d| {vs_fp32['mean']:.5f} (tol {BAND_TOL_MEAN}), "
        f"p99 {vs_fp32['p99']:.5f} (tol {BAND_TOL_P99}), max {vs_fp32['max']:.5f}, share > 1/255 "
        f"{vs_fp32['share_over_1_255']:.4f}; the fp32 bands' mean |x - mean| {spread:.5f}")
    require(vs_fp32["mean"] <= BAND_TOL_MEAN and vs_fp32["p99"] <= BAND_TOL_P99,
            f"{tag}: the bf16 bands differ from the fp32 node's: {vs_fp32}")
    ring = np.ones((t, oh, ow), np.float32)
    ring[:, :, w_start : w_start + w] = 0.0
    require(tuple(mask.shape) == ring.shape and np.array_equal(mask.numpy(), ring), f"{tag}: OUTPAINT_MASK is not the ring")
    summary.update(size=f"{w}x{h} on {ow}x{oh}", band_mean=[float(b.mean()) for b in bands], bands_vs_fp32=vs_fp32)
    return summary


# the port's profiler ranges (utils/profiling.py): the stage timers', and
# the spans' and kernel launches' by their prefixes
STAGE_RANGES = {"compute_flow", "complete_flow", "image_propagation", "feature_propagation", "stream_prep", "stream_write"}
RANGE_PREFIXES = ("node.", "raft.", "feature.", "kernel.")


def _device_rows(prof):
    """(device ms, count, name) of every device-side event of a profile."""
    from torch.autograd import DeviceType

    rows = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue  # host ops: their device time is their kernels'
        if getattr(e, "is_user_annotation", False) or e.key in STAGE_RANGES or e.key.startswith(RANGE_PREFIXES):
            continue  # a range of the port's: its device span holds kernels counted on their own
        dev = getattr(e, "self_device_time_total", None)
        if dev is None:
            dev = getattr(e, "self_cuda_time_total", 0.0)
        if dev > 0:
            rows.append((dev / 1e3, e.count, e.key))
    return sorted(rows, reverse=True)


def profile_run(run, timed_wall_s, name):
    """One more node run under torch.profiler: device time by kernel, the
    device-to-host copies' time, and the device's busy share of the
    (unprofiled) timed run's wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        own_wall_s = time.perf_counter() - t0
    rows = _device_rows(prof)
    busy = sum(r[0] for r in rows)
    if busy == 0:
        log("  profiler: no device time recorded (not measured)")
        return None
    mine = {k: sum(r[0] for r in rows if k in r[2]) for k in (
        "corr_lookup_kernel", "corr_lookup_map_kernel", "deform_conv_mma_kernel", "deform_conv_kernel",
        "window_attention_mma_kernel",
        "window_attention_kernel",
        "window_attention_split_mma_kernel", "window_attention_split_kernel", "window_attention_combine_kernel",
        "window_attention_halo_mma_kernel", "window_attention_halo_kernel", "corr_window4_kernel",
        "corr_window_kernel", "prop_fill_kernel", "corr_pyramid_kernel")}
    dtoh = sum(r[0] for r in rows if "DtoH" in r[2])
    share = busy / (timed_wall_s * 1e3)
    own = busy / (own_wall_s * 1e3)
    log(f"  profiled run: device kernels {busy:.1f} ms = {100 * share:.1f}% of the timed run's "
        f"wall, {100 * own:.1f}% of its own {own_wall_s:.3f} s; device-to-host copies {dtoh:.2f} ms; port kernels (ms): "
        + ", ".join(f"{k} {v:.2f}" for k, v in mine.items() if v > 0))
    with open(os.path.join(OUT_DIR, name), "w") as f:
        for dev, cnt, key in rows:
            f.write(f"{dev:12.3f} ms {cnt:7d}  {key}\n")
    for dev, cnt, key in rows[:10]:
        log(f"    {dev:10.3f} ms {cnt:6d}x  {key[:90]}")
    return dict(device_kernels_ms=busy, busy_share=share, profiled_wall_s=own_wall_s,
                busy_share_profiled=own, kernels_ms=mine, dtoh_ms=dtoh)


SMALL_INPAINT = dict(width=96, height=64, mask_dilates=4, flow_mask_dilates=4, ref_stride=4,
                     neighbor_length=4, subvideo_length=80, raft_iter=2, fp16="disable",
                     _allow_random_weights=True)


def card_vs_host(switched: bool, outpaint: bool = False):
    """The same small node run (fp32, 2 RAFT iterations) on the card and on
    the host, whose kernels are the plain versions: the inpaint node, or
    the outpaint node on a 120x96 canvas (all four bands)."""
    from comfyui_propainter_nodes_tpu_torch.nodes import ProPainterInpaint, ProPainterOutpaint

    frames, masks = synthetic_clip(8, 120, 160)
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    reset_counters()
    if outpaint:
        kw = dict(SMALL_INPAINT, width_scale=1.25, height_scale=1.5)
        runs = [ProPainterOutpaint(device=d).propainter_outpainting(frames, **kw) for d in ("cuda", "cpu")]
    else:
        with switches(switched):
            runs = [ProPainterInpaint(device=d).propainter_inpainting(frames, masks, **SMALL_INPAINT)
                    for d in ("cuda", "cpu")]
    gpu, cpu = runs
    # 120x160 clips at a 96x64 process size: the host resizes, the card makes no bytes
    require(card_io_since() == 0, f"card vs host: node_card_io counted {card_io_since()} for resized clips")
    diff = (gpu[0] - cpu[0]).abs()
    share = float((diff > 1.5 / 255).float().mean())
    same = all(torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b for a, b in zip(gpu[1:], cpu[1:]))
    tag = "outpaint node" if outpaint else "with both switches" if switched else "default kernels"
    log(f"  card vs host (8 frames, {tuple(gpu[0].shape[1:3])} fp32, {tag}): IMAGE max diff {float(diff.max()):.5f}, "
        f"share > 1/255: {share:.6f}; masks (and size) equal: {same}")
    require(same, f"card and host masks differ ({tag})")
    # the uint8 floor can flip one level; a flipped image-propagation mask
    # bit can move a few pixels further
    require(share < 1e-3 and float(diff.mean()) < 1e-3, f"card and host IMAGE differ ({tag}): share {share}, mean {float(diff.mean())}")


def write_clip_npy(folder: str, t: int, h: int, w: int):
    """synthetic_clip(t, h, w), written frame by frame as uint8 .npy files
    in folder: frames [t, h, w, 3] and masks [t, h, w, 1]."""
    paths = os.path.join(folder, "frames.npy"), os.path.join(folder, "masks.npy")
    frames = np.lib.format.open_memmap(paths[0], "w+", np.uint8, (t, h, w, 3))
    masks = np.lib.format.open_memmap(paths[1], "w+", np.uint8, (t, h, w, 1))
    base = clip_base(h, w)
    for i in range(t):
        frames[i], masks[i, ..., 0] = clip_frame(base, i)
    frames.flush()
    masks.flush()
    return paths


def node_widgets() -> dict:
    """The pipeline's share of WIDGETS (PipelineConfig's fields)."""
    return {k: WIDGETS[k] for k in ("ref_stride", "neighbor_length", "subvideo_length", "raft_iter", "fp16")}


# the pipeline methods whose peaks the blocking streaming runs read
WATCHED = ("compute_flow", "complete_flow_chunk", "image_prop_chunk", "feature_window")


def stream_clip(pipe, frames, masks, t: int, out, tag: str, stage_peaks=None) -> dict:
    """One process_streaming run over `t` frames read by the VideoSources
    `frames` and `masks`, written into `out`: its wall, first write,
    writes (start, n), memory after each window's eviction and peak, and
    before each window's tick the count of chunks that entered a cache
    (frames fetched, completion and image-propagation chunks). With
    stage_peaks, each watched method's peak is read and reset around its
    calls; what the counter holds between them goes under "outside"."""
    from comfyui_propainter_nodes_tpu_torch.pipeline.streaming import process_streaming

    st = dict(first=None, writes=[], live=[], fills=[])
    fills = [0]

    def counted(fn):
        def run(*args):
            fills[0] += 1
            return fn(*args)

        return run

    def write(start, arr):
        if st["first"] is None:
            st["first"] = time.perf_counter() - st["t0"]
        st["writes"].append((start, arr.shape[0]))
        out[start : start + arr.shape[0]] = arr

    def progress(stage, done, total):
        if stage == "feature_windows":
            st["live"].append(torch.cuda.memory_allocated())
            st["fills"].append(fills[0])

    def peak_of(name, fn):
        def run(*args):
            stage_peaks["outside"] = max(stage_peaks.get("outside", 0), torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            res = fn(*args)
            stage_peaks[name] = max(stage_peaks.get(name, 0), torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()
            return res

        return run

    pipe.progress = progress
    for m in ("complete_flow_chunk", "image_prop_chunk"):
        setattr(pipe, m, counted(getattr(pipe, m)))
    if stage_peaks is not None:
        for m in WATCHED:
            setattr(pipe, m, peak_of(m, getattr(pipe, m)))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        st["t0"] = t0 = time.perf_counter()
        st["caches"] = process_streaming(
            pipe, counted(frames.fetch), lambda s, c: masks.fetch(s, c)[..., 0], t, write,
            WIDGETS["mask_dilates"], WIDGETS["flow_mask_dilates"], prefetch=frames.prefetch,
        )
        torch.cuda.synchronize()
        st["wall"] = time.perf_counter() - t0
    finally:
        pipe.progress = None
        for m in WATCHED:
            pipe.__dict__.pop(m, None)
    st["peak"] = torch.cuda.max_memory_allocated()
    if stage_peaks is not None:
        stage_peaks["outside"] = max(stage_peaks.get("outside", 0), st["peak"])
        st["peak"] = max(stage_peaks.values())
    starts = [s0 for s0, _ in st["writes"]]
    require(starts == [0] + [s0 + n for s0, n in st["writes"][:-1]] and all(n > 0 for _, n in st["writes"])
            and sum(n for _, n in st["writes"]) == t, f"{tag}: writes {st['writes']}")
    return st


def check_streamed(frames, masks, out, t: int, h: int, w: int, tag: str) -> dict:
    """Every streamed frame integral in 0..255 and equal to the input bytes
    outside its dilated mask (streaming pastes nothing on the host: these
    are the card's bytes), and the masked region painted."""
    from comfyui_propainter_nodes_tpu_torch.utils import image as image_utils

    err_out, painted, bad = 0.0, 0.0, 0
    with torch.inference_mode():
        for s0 in range(0, t, 16):
            n = min(16, t - s0)
            _, byte = image_utils.prepare_frames(torch.from_numpy(frames.fetch(s0, n)).cuda(), w, h)
            m = torch.from_numpy(masks.fetch(s0, n)[..., 0]).cuda()
            md = image_utils.prepare_masks(m, w, h, WIDGETS["flow_mask_dilates"], WIDGETS["mask_dilates"])[1]
            o = torch.from_numpy(out[s0 : s0 + n]).cuda()
            bad += int((~torch.isfinite(o) | (o != o.floor()) | (o < 0) | (o > 255)).sum())
            d = (o - byte).abs()
            err_out = max(err_out, float((d * (1 - md)).max()))
            painted = max(painted, float((d * md).max()))
    log(f"  [{tag}] output vs input outside the dilated mask: max |d| {err_out} (must be 0); inside: max |d| "
        f"{painted}; values not integral in 0..255: {bad}")
    require(bad == 0, f"{tag}: {bad} values not integral in 0..255")
    require(err_out == 0.0, f"{tag}: output differs from the input outside the dilated mask: {err_out}")
    require(painted > 0, f"{tag}: the masked region must be inpainted")
    return dict(max_abs_outside=err_out, max_abs_inside=painted)


def streaming_pipeline(h: int, w: int):
    from comfyui_propainter_nodes_tpu_torch.config import PipelineConfig
    from comfyui_propainter_nodes_tpu_torch.nodes import get_pipeline

    return get_pipeline(PipelineConfig(**node_widgets(), process_size=(w, h)), torch.device("cuda"), True)


_COUNTER_BASE: dict = {}  # the program's counters at the last `reset_counters`


def reset_counters():
    from comfyui_propainter_nodes_tpu_torch.utils import profiling

    _COUNTER_BASE.clear()
    _COUNTER_BASE.update(profiling.counters())


def read_counters():
    """(launches by kernel, B2's launches by x shape) since `reset_counters`."""
    from comfyui_propainter_nodes_tpu_torch.ops.cuda.deform_conv import SHAPE_COUNTER
    from comfyui_propainter_nodes_tpu_torch.utils import profiling

    since = {k: v - _COUNTER_BASE.get(k, 0) for k, v in profiling.counters().items()}
    return ({name: since.get(name, 0) for name in KERNELS},
            {k[len(SHAPE_COUNTER):]: c for k, c in since.items() if k.startswith(SHAPE_COUNTER) and c})


def stage_seconds() -> dict:
    """Each stage's seconds in the stage table (`profiling.summary()`)
    since the last `profiling.reset_stages()`."""
    from comfyui_propainter_nodes_tpu_torch.utils import profiling

    return {k: v["seconds"] for k, v in profiling.summary().items()}


def raft_forms_since() -> dict:
    """The RAFT forms `Pipeline.compute_flow` counted ("raft_form/<form>",
    one a call) since `reset_counters`."""
    from comfyui_propainter_nodes_tpu_torch.utils import profiling

    since = {k: v - _COUNTER_BASE.get(k, 0) for k, v in profiling.counters().items() if k.startswith("raft_form/")}
    return {k: v for k, v in since.items() if v}


def card_io_since() -> int:
    """The nodes' calls that made their bytes on the card ("node_card_io")
    since `reset_counters`."""
    from comfyui_propainter_nodes_tpu_torch.utils import profiling

    return profiling.counters().get("node_card_io", 0) - _COUNTER_BASE.get("node_card_io", 0)


def require_kernels(tag, counts, need, forbid):
    require(all(counts[k] > 0 for k in need), f"{tag}: a kernel of the path was not launched: {counts}")
    require(all(counts[k] == 0 for k in forbid), f"{tag}: a kernel off the path was launched: {counts}")


def path_s_run(need, forbid):
    """Path S: `process_streaming` over the 240-frame 1280x720 clip, read
    from .npy files by two `VideoSource`s, at default widgets with random
    weights, twice. The first run takes the stage times with blocking
    timers and each stage's peak (wrapped pipeline methods); the second
    runs as a user runs it (timers not blocking, nothing wrapped), with the
    launch counters reset just before it, and gives the wall, frames/s,
    the first write, the launches and the peak. In both the writer only
    copies each frame into a float32 host array and the progress callback
    reads memory_allocated after each window's eviction. After the second
    run every frame must have been written once, in order, be integral in
    0..255 and equal the input bytes outside its dilated mask."""
    from comfyui_propainter_nodes_tpu_torch.utils import profiling
    from comfyui_propainter_nodes_tpu_torch.utils.frameio import VideoSource

    t, h, w = PATH_S
    tag = f"path S streaming {t} frames {w}x{h}"
    pipe = streaming_pipeline(h, w)
    out = np.zeros((t, h, w, 3), np.float32)  # touched here, not in the timed runs
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        fpath, mpath = write_clip_npy(tmp, t, h, w)
        log(f"  [{tag}] clip written as uint8 .npy in {time.perf_counter() - t0:.2f} s "
            f"({(os.path.getsize(fpath) + os.path.getsize(mpath)) / 1e9:.3f} GB)")
        base_bytes = torch.cuda.memory_allocated()
        stage_peaks = {}
        with VideoSource(fpath) as frames, VideoSource(mpath) as masks:
            profiling.reset_stages()
            blk = stream_clip(pipe, frames, masks, t, out, tag, stage_peaks)
            stages = profiling.summary()
            profiling.set_blocking(False)
            try:
                profiling.reset_stages()
                reset_counters()
                run = stream_clip(pipe, frames, masks, t, out, tag)
                counts, b2_shapes = read_counters()
                unblocked = profiling.summary()
            finally:
                profiling.set_blocking(True)
            checked = check_streamed(frames, masks, out, t, h, w, tag)
            copy_ms = write_copy_ab(torch.from_numpy(out[:5]).cuda())
    log(f"  [{tag}] wall {run['wall']:.3f} s = {t / run['wall']:.3f} frames/s; first frames written after "
        f"{run['first']:.3f} s (timers not blocking, nothing wrapped; the blocking run before it: "
        f"{blk['wall']:.3f} s, first write {blk['first']:.3f} s)")
    log(f"  [{tag}] stage timers, blocking run: "
        + ", ".join(f"{k} {v['seconds']:.3f} ({v['calls']})" for k, v in stages.items()))
    log(f"  [{tag}] stage timers, second run (not blocking: host time to enqueue, a stage's wait for the "
        f"card where it reads a value): "
        + ", ".join(f"{k} {v['seconds']:.3f} ({v['calls']})" for k, v in unblocked.items()))
    for name, st in (("blocking", blk), ("second", run)):
        log(f"  [{tag}] {name} run: max_memory_allocated {st['peak'] / 2**30:.3f} GiB; memory_allocated before the "
            f"run {base_bytes / 2**30:.3f} GiB, after each window's eviction: max {max(st['live']) / 2**30:.3f}, "
            f"last {st['live'][-1] / 2**30:.3f} GiB ({len(st['live'])} windows); largest live entries per cache "
            f"{st['caches']}")
    log(f"  [{tag}] after each window's eviction, GiB (second run): "
        + " ".join(f"{v / 2**30:.2f}" for v in run["live"]) + f"; chunks that entered a cache before each window: "
        f"{run['fills']}")
    log(f"  [{tag}] peak allocated by stage (GiB, blocking run): "
        + ", ".join(f"{k} {v / 2**30:.3f}" for k, v in stage_peaks.items()))
    log(f"  [{tag}] one flush of 5 frames to the host (ms, median of 20): float32 {copy_ms['float32']:.3f}, "
        f"uint8 then widened on the host {copy_ms['uint8']:.3f}")
    log(f"  [{tag}] launches {counts}; B2 launches by x shape {b2_shapes}")
    require_kernels(tag, counts, need, forbid)
    for st in (blk, run):
        grown = live_growth(st["live"], st["fills"], h, w)
        require(not grown, f"{tag}: the live set grows between chunk fills at windows {grown}: {st['live']}")
    return dict(frames=t, size=f"{w}x{h}", seconds=run["wall"], fps=t / run["wall"], first_write_s=run["first"],
                blocking_seconds=blk["wall"], blocking_first_write_s=blk["first"], stages=stages,
                stages_not_blocking=unblocked, peak_bytes=run["peak"], blocking_peak_bytes=blk["peak"],
                stage_peak_bytes=stage_peaks, base_bytes=base_bytes, live_after_eviction_bytes=run["live"],
                blocking_live_after_eviction_bytes=blk["live"], cache_peaks=run["caches"], launches=counts,
                b2_launches_by_shape=b2_shapes, flush_copy_ms=copy_ms, output=checked)


def record_forms(pipe, forms: list):
    """Wrap the pipeline's compute_flow and complete_flow_chunk to record,
    for each call, the form it takes by the gates (RAFT: frames, form and
    lookup; completion: pairs and `completion_plan`)."""
    from comfyui_propainter_nodes_tpu_torch.models import flow_completion as fc
    from comfyui_propainter_nodes_tpu_torch.pipeline import stages

    cfg = pipe.config
    compute_flow, complete = pipe.compute_flow, pipe.complete_flow_chunk

    def flow(frames):
        t, hw = frames.shape[1], (frames.shape[2], frames.shape[3])
        forms.append(("compute_flow", t, stages.raft_form(cfg, t, hw), stages.jax_flow_lookup(cfg, t, hw)))
        return compute_flow(frames)

    def chunk(ff, fb, mk):
        forms.append(("complete_flow_chunk", ff.shape[1], fc.completion_plan(ff.shape, pipe.cdtype)))
        return complete(ff, fb, mk)

    pipe.compute_flow, pipe.complete_flow_chunk = flow, chunk


# the earlier paths' launches (every other counter 0); path S's B1 map
# count is 76 RAFT calls of 20 iterations: its 24-pair flow sub-ranges;
# prop_fill's, 2 (n - 1) a chunk of n frames: 24 frames, or path S's
# chunks of 90, 100 and 90; corr_pyramid's, one a bf16 RAFT call (path B's
# padded build stays eager)
EARLIER_LAUNCHES = {
    "main": dict(corr_lookup=20, deform_conv=66, window_attention=8, prop_fill=46, corr_pyramid=1),
    "path_a": dict(corr_lookup_map=120, deform_conv=66, window_attention_tiled=8, prop_fill=46, corr_pyramid=6),
    "path_b": dict(deform_conv=66, window_attention_halo=8, corr_window4=20, prop_fill=46),
    "path_o": dict(corr_lookup=20, deform_conv=66, window_attention=8, prop_fill=46, corr_pyramid=1),
    "path_s": dict(corr_lookup_map=1520, deform_conv=1568, window_attention_tiled=384, prop_fill=554,
                   corr_pyramid=76),
}

def live_growth(live, fills, h: int, w: int) -> list:
    """The windows whose live set (memory after the window's eviction)
    exceeds the live set at the last window where a chunk entered a cache
    by more than the window loop's own transients: one window's flows
    (10 pairs of both directions, bf16, concatenated where the window
    spans two completion chunks) and 64 MiB. Between chunk fills a
    bounded working set does not grow with the window index."""
    slack = 10 * 2 * h * w * 2 * 2 + (64 << 20)
    grown, ref = [], live[0]
    for i in range(len(live)):
        if i == 0 or fills[i] != fills[i - 1]:
            ref = live[i]
        elif live[i] > ref + slack:
            grown.append(i)
    return grown


PEAK_LIMIT = 64 << 30  # path H's peak: leaves 15 GiB of the card to the other models of a graph


def path_h_run(need, forbid):
    """Path H: `process_streaming` over the 120-frame 1920x1080 clip (the
    JAX package's config 5: ref_stride 10, neighbor_length 10,
    subvideo_length 80, raft_iter 20, bf16), read from .npy files by two
    `VideoSource`s, one run with blocking stage timers, each stage's peak,
    the launch counters reset just before it, and the form of each RAFT
    call and completion chunk recorded. Requires: every frame written
    once, in order, integral in 0..255 and the input outside its dilated
    mask; peak allocated <= 64 GiB; the live set after each window's
    eviction not growing between chunk fills (`live_growth`)."""
    from comfyui_propainter_nodes_tpu_torch.utils import profiling
    from comfyui_propainter_nodes_tpu_torch.utils.frameio import VideoSource

    t, h, w = PATH_H
    tag = f"path H streaming {t} frames {w}x{h}"
    pipe = streaming_pipeline(h, w)
    out = np.zeros((t, h, w, 3), np.float32)
    forms, stage_peaks = [], {}
    with tempfile.TemporaryDirectory() as tmp:
        fpath, mpath = write_clip_npy(tmp, t, h, w)
        base_bytes = torch.cuda.memory_allocated()
        with VideoSource(fpath) as frames, VideoSource(mpath) as masks:
            profiling.reset_stages()
            record_forms(pipe, forms)
            try:
                reset_counters()
                run = stream_clip(pipe, frames, masks, t, out, tag, stage_peaks)
                counts, b2_shapes = read_counters()
            finally:
                pipe.__dict__.pop("compute_flow", None)
                pipe.__dict__.pop("complete_flow_chunk", None)
            stages = profiling.summary()
            checked = check_streamed(frames, masks, out, t, h, w, tag)
    live = run["live"]
    grown = live_growth(live, run["fills"], h, w)
    log(f"  [{tag}] wall {run['wall']:.3f} s = {t / run['wall']:.3f} frames/s (blocking stage timers); first frames "
        f"written after {run['first']:.3f} s")
    log(f"  [{tag}] stage timers: " + ", ".join(f"{k} {v['seconds']:.3f} ({v['calls']})" for k, v in stages.items()))
    log(f"  [{tag}] max_memory_allocated {run['peak'] / 2**30:.3f} GiB (limit {PEAK_LIMIT / 2**30:.0f}); by stage: "
        + ", ".join(f"{k} {v / 2**30:.3f}" for k, v in stage_peaks.items()))
    log(f"  [{tag}] memory_allocated before the run {base_bytes / 2**30:.3f} GiB; after each window's eviction (GiB): "
        + " ".join(f"{v / 2**30:.2f}" for v in live) + f"; largest live entries per cache {run['caches']}; "
        f"chunks that entered a cache before each window: {run['fills']}")
    for f in forms:
        log(f"  [{tag}] {f[0]}: " + ", ".join(str(x) for x in f[1:]))
    log(f"  [{tag}] launches {counts}; B2 launches by x shape {b2_shapes}")
    require_kernels(tag, counts, need, forbid)
    require(run["peak"] <= PEAK_LIMIT, f"{tag}: peak {run['peak'] / 2**30:.3f} GiB over {PEAK_LIMIT / 2**30:.0f}")
    require(not grown, f"{tag}: the live set grows between chunk fills at windows {grown}: {live}")
    return dict(frames=t, size=f"{w}x{h}", seconds=run["wall"], fps=t / run["wall"], first_write_s=run["first"],
                stages=stages, peak_bytes=run["peak"], stage_peak_bytes=stage_peaks, base_bytes=base_bytes,
                live_after_eviction_bytes=live, cache_peaks=run["caches"], launches=counts,
                b2_launches_by_shape=b2_shapes, forms=forms, output=checked)


def forced_forms() -> dict:
    """At 1920x1080 on the card: process_streaming over 20 frames of the
    synthetic clip (default widgets) with the forms path H takes, then with
    each form that no path takes forced through its budget, on the same
    inputs: RAFT a pair a call, and with the directions in turn; the
    completion's directions in turn; its encoder in temporal chunks, in row
    slabs; its mid dilation in frame chunks; the generator's encoder and
    decoder in frame chunks of 4 and 2 (the JAX package's). Each output is
    held against the path forms' with the card-against-host tolerance
    (all but < 0.1% of values within one uint8 level, mean |d| < 1e-3 in
    [0, 1]); the peak and wall of each run are logged. The first run is
    also path H's warm-up at its shapes."""
    from comfyui_propainter_nodes_tpu_torch.models import flow_completion as fc
    from comfyui_propainter_nodes_tpu_torch.models.raft import call_bytes
    from comfyui_propainter_nodes_tpu_torch.pipeline import stages
    from comfyui_propainter_nodes_tpu_torch.utils.frameio import VideoSource

    t, h, w = 20, PATH_H[1], PATH_H[2]
    pipe = streaming_pipeline(h, w)
    cfg = pipe.config
    dt = pipe.cdtype
    forced = {
        "path forms": {},
        "RAFT a pair a call": dict(stages__RAFT_CALL_BYTES=1.5 * call_bytes(1, h // 8, w // 8, 2, "map")),
        "RAFT a pair a call, directions in turn": dict(stages__RAFT_CALL_BYTES=1),
        "completion directions in turn": dict(fc__BATCH_BYTES=0),
        "completion encoder in temporal chunks": dict(fc__ENCODE_BYTES=0),
        "completion encoder in row slabs": dict(fc__SLAB_BYTES=256 << 20),
        "completion mid in frame chunks": dict(fc__MID_BYTES=0),
        "generator encoder and decoder in frame chunks": dict(
            pp__ENCODE_BYTES=4 * (h // 4) * (w // 4) * 512 * 2, pp__DECODE_BYTES=2 * h * w * 64 * 2),
    }
    res, base = {}, None
    out = np.zeros((t, h, w, 3), np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        fpath, mpath = write_clip_npy(tmp, t, h, w)
        with VideoSource(fpath) as frames, VideoSource(mpath) as masks:
            for name, values in forced.items():
                with budgets(**values):
                    plan = dict(raft=stages.raft_form(cfg, t, (h, w)),
                                completion=fc.completion_plan((1, t - 1, h, w, 2), dt))
                    st = stream_clip(pipe, frames, masks, t, out, f"forced forms: {name}")
                r = dict(seconds=st["wall"], peak_gib=st["peak"] / 2**30, forms=plan)
                if base is None:
                    base = out.copy()
                else:
                    d = np.abs(out - base)
                    r.update(differing_bytes=int((d > 0).sum()), max_abs=float(d.max()),
                             share_over_1=float((d > 1.5).mean()), mean=float(d.mean()) / 255.0)
                log(f"  forced forms at {w}x{h}, {t} frames: {name}: {r}")
                if base is not None and name != "path forms":
                    require(r["share_over_1"] < 1e-3 and r["mean"] < 1e-3, f"forced form {name} differs: {r}")
                res[name] = r
    return res


def write_copy_ab(frames, reps: int = 20) -> dict:
    """One streaming flush (5 composed frames on the card) to a float32
    host array: as float32, or as uint8 widened on the host, alternating;
    medians in ms."""
    times = {"float32": [], "uint8": []}
    for _ in range(reps):
        for kind in times:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if kind == "float32":
                frames.to("cpu", copy=True).numpy()
            else:
                frames.to(torch.uint8).cpu().numpy().astype(np.float32)
            times[kind].append((time.perf_counter() - t0) * 1e3)
    return {k: statistics.median(v) for k, v in times.items()}


def first_difference(pipe, fnorm, fm) -> str:
    """Where fp32 streaming and in-memory runs part, among the ops each
    batches otherwise: RAFT on all the clip's pairs against the first
    completion chunk's pairs alone, then the encoder on all frames against
    one window's frame count; else the windows' generator (8 windows a
    call in memory, one streaming)."""
    from comfyui_propainter_nodes_tpu_torch.models import propainter as pp
    from comfyui_propainter_nodes_tpu_torch.pipeline.stages import _window_tables, complete_chunk_plan, full_fp32

    s_f, e_f = complete_chunk_plan(pipe.config, fnorm.shape[0] - 1)[0][:2]
    *_, l_t_max, ref_max = _window_tables(pipe.config, fnorm.shape[0])
    n = l_t_max + ref_max
    with torch.inference_mode(), full_fp32():
        ff_all = pipe.compute_flow(fnorm[None])[0][:, s_f:e_f]
        ff_chunk = pipe.compute_flow(fnorm[None, s_f : e_f + 1])[0]
        d = float((ff_all - ff_chunk).abs().max())
        if d > 0:
            return f"compute_flow (RAFT on {fnorm.shape[0] - 1} pairs against {e_f - s_f}): max |d| {d:.3e}"
        x, m = fnorm.to(pipe.cdtype), fm.to(pipe.cdtype)
        enc_all = pp.encode_features(pipe.inpaint_params, x, m, m)[:n]
        enc_win = pp.encode_features(pipe.inpaint_params, x[:n], m[:n], m[:n])
        d = float((enc_all - enc_win).abs().max())
        if d > 0:
            return f"encode_features ({fnorm.shape[0]} frames a call against {n}): max |d| {d:.3e}"
    return "neither RAFT nor the encoder: the windows' generator (8 windows a call against 1)"


def stream_vs_memory(fp16: str) -> dict:
    """process_streaming against Pipeline.process on one pipeline, 48
    frames at 640x360, ref_stride 4, neighbor_length 10, subvideo_length
    16, raft_iter 20: three completion and three image-propagation chunks,
    reference frames, the updated-frame cache evicting from window 6. Held
    to the card-against-host tolerance of PERF.md section 2 (all but < 0.1%
    of values within one uint8 level); the differing bytes and the blend
    each run's RAFT took are printed (in bf16 the in-memory run's one call
    of 47 pairs passes the lanes gate's 1 GiB and takes the map blend,
    streaming's calls of at most 26 pairs take the lanes blend)."""
    from comfyui_propainter_nodes_tpu_torch.config import PipelineConfig
    from comfyui_propainter_nodes_tpu_torch.nodes import get_pipeline
    from comfyui_propainter_nodes_tpu_torch.pipeline.streaming import process_streaming
    from comfyui_propainter_nodes_tpu_torch.utils import image as image_utils

    t, h, w = STREAM_CLIP
    md_dil, fm_dil = WIDGETS["mask_dilates"], WIDGETS["flow_mask_dilates"]
    frames_u8, masks_u8 = synthetic_clip(t, h, w)
    frames, masks = frames_u8.astype(np.float32) / 255.0, masks_u8.astype(np.float32) / 255.0
    cfg = PipelineConfig(**dict(node_widgets(), ref_stride=4, subvideo_length=16, fp16=fp16), process_size=(w, h))
    pipe = get_pipeline(cfg, torch.device("cuda"), True)

    def blends():
        counts = read_counters()[0]
        return dict(lanes=counts["corr_lookup"], map=counts["corr_lookup_map"])

    reset_counters()
    fnorm, byte = image_utils.prepare_frames(torch.from_numpy(frames).cuda(), w, h)
    fm, md = image_utils.prepare_masks(torch.from_numpy(masks).cuda(), w, h, fm_dil, md_dil)
    mem = pipe.process(fnorm[None], fm[None], md[None], byte).cpu().numpy()
    mem_blends = blends()
    reset_counters()
    out = np.full((t, h, w, 3), -1.0, np.float32)

    def write(start, arr):
        out[start : start + arr.shape[0]] = arr

    process_streaming(pipe, lambda s, c: frames[s : s + c], lambda s, c: masks[s : s + c], t, write, md_dil, fm_dil)
    stream_blends = blends()
    d = np.abs(out - mem)
    n_diff, share, mean = int((d > 0).sum()), float((d > 1.5).mean()), float(d.mean()) / 255.0
    where = first_difference(pipe, fnorm, fm) if n_diff and fp16 == "disable" else None
    log(f"  streaming vs in-memory ({t} frames {w}x{h}, fp16={fp16}): {n_diff} of {d.size} bytes differ, "
        f"max |d| {float(d.max())}, share > 1 level {share:.6f}, mean |d| {mean:.2e} (in [0, 1]); RAFT blend "
        f"launches in memory {mem_blends}, streaming {stream_blends}" + (f"; first difference: {where}" if where else ""))
    require(out.min() >= 0, f"streaming vs in-memory (fp16={fp16}): a frame was not written")
    require(share < 1e-3 and mean < 1e-3, f"streaming and in-memory runs differ (fp16={fp16}): share {share}, mean {mean}")
    return dict(differing_bytes=n_diff, bytes=d.size, max_abs=float(d.max()), share_over_1=share, mean=mean,
                blends_in_memory=mem_blends, blends_streaming=stream_blends, first_difference=where)


def tree_path_t_steps() -> list:
    """Path T's training step (fp32) for `--conv-gemm`: host-clock seconds
    of PATH_T_STEPS synchronised steps after a warm-up step."""
    from comfyui_propainter_nodes_tpu_torch.training.train_step import init_state, make_train_step
    from comfyui_propainter_nodes_tpu_torch.utils import weights

    batch = path_t_batch()
    state = init_state(weights.get_params("inpaint_generator", allow_download=False, allow_random=True))
    step = make_train_step(None, PATH_T["local"])
    walls = []
    for _ in range(PATH_T_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = step(state, batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    del state, batch
    torch.cuda.empty_cache()
    return walls[1:]


@contextlib.contextmanager
def budgets(**values):
    """Module budgets (`module.NAME` for each `module__NAME` given) set for
    the block, restored after it."""
    from comfyui_propainter_nodes_tpu_torch.models import flow_completion, propainter
    from comfyui_propainter_nodes_tpu_torch.pipeline import stages

    mods = {"fc": flow_completion, "pp": propainter, "stages": stages}
    old = {}
    try:
        for key, v in values.items():
            mod, name = key.split("__")
            old[(mod, name)] = getattr(mods[mod], name)
            setattr(mods[mod], name, v)
        yield
    finally:
        for (mod, name), v in old.items():
            setattr(mods[mod], name, v)


# B3's, B4's and B5's fp32 kernels (csrc/flash_f32.cuh)
F32_LOOP_KERNELS = ("window_attention_f32_kernel", "window_attention_split_f32_kernel", "window_attention_halo_f32_kernel")
B2_F32_KERNEL = "deform_conv_kernel"  # B2's fp32 kernel (csrc/deform_conv.cu)

PATH_C = (100, 360, 640)  # paths C and M: the synthetic clip at default widgets
M_JOIN_TIMEOUT_S = 900  # path M's ranks, from their start to their last result
M_COLLECTIVE_TIMEOUT_S = 300  # a collective that waits longer fails its rank


def path_inputs(device, clip=PATH_C):
    """The synthetic clip (T, H, W) of `clip` (path C's by default) prepared
    as the inpaint node prepares it (default dilations): (frames_norm
    [1, T, H, W, 3], flow_masks, masks_dilated [1, T, H, W, 1], the
    frames' bytes [T, H, W, 3]) on `device`."""
    from comfyui_propainter_nodes_tpu_torch.utils import image as image_utils

    t, h, w = clip
    frames_u8, masks_u8 = synthetic_clip(t, h, w)
    fnorm, byte = image_utils.prepare_frames(torch.from_numpy(frames_u8.astype(np.float32) / 255.0).to(device), w, h)
    fm, md = image_utils.prepare_masks(torch.from_numpy(masks_u8.astype(np.float32) / 255.0).to(device), w, h,
                                       WIDGETS["flow_mask_dilates"], WIDGETS["mask_dilates"])
    return fnorm[None], fm[None], md[None], byte


# RAFT's iterations (its unrolled depth) in the fp32 legs of paths C, M and
# MH, which hold the ranks against the single card: cut from the default
# 20 to buy path T's time (fp32 RAFT took most of those legs' 217 s)
FP32_RAFT_ITER = 2


def path_config(fp16: str, clip=PATH_C):
    """Default widgets at the clip's size; fp32 (fp16="disable") at
    FP32_RAFT_ITER RAFT iterations."""
    from comfyui_propainter_nodes_tpu_torch.config import PipelineConfig

    h, w = clip[1:]
    widgets = dict(node_widgets(), fp16=fp16)
    if fp16 == "disable":
        widgets["raft_iter"] = FP32_RAFT_ITER
    return PipelineConfig(**widgets, process_size=(w, h))


def check_video(out, md, byte, tag: str, clip=PATH_C) -> np.ndarray:
    """A composed video on the card: the whole clip, integral in 0..255,
    the input bytes outside the dilated mask. Returns it as uint8."""
    t, h, w = clip
    require(tuple(out.shape) == (t, h, w, 3), f"{tag}: output shape {tuple(out.shape)}")
    o = out.cpu().numpy()
    require(np.isfinite(o).all() and o.min() >= 0 and o.max() <= 255 and np.array_equal(o, np.floor(o)),
            f"{tag}: output not integral in 0..255")
    outside = md[0, ..., 0].cpu().numpy() == 0
    require(np.array_equal(o[outside], byte.cpu().numpy()[outside]), f"{tag}: output differs from the input outside the dilated mask")
    return o.astype(np.uint8)


def video_diff(a: np.ndarray, b: np.ndarray) -> dict:
    """Differing bytes of two uint8 videos, and the card-against-host
    tolerance's numbers (share over one level, mean |d| in [0, 1])."""
    d = np.abs(a.astype(np.int16) - b.astype(np.int16))
    return dict(differing_bytes=int((d > 0).sum()), share_differing=float((d > 0).mean()), max_abs=int(d.max()),
                share_over_1=float((d > 1).mean()), mean=float(d.mean()) / 255.0)


def within_tolerance(d: dict) -> bool:
    return d["share_over_1"] < 1e-3 and d["mean"] < 1e-3


def recorded_raft(forms: list):
    """Context: RAFT's two bidirectional forms wrapped to record each
    call's (pairs, blend)."""
    from comfyui_propainter_nodes_tpu_torch.models import raft

    fns = raft.raft_bi_forward, raft.raft_bi_forward_seqdir

    def wrap(fn):
        def f(params, frames, iters=20, blend=None):
            forms.append((frames.shape[0] * (frames.shape[1] - 1), blend))
            return fn(params, frames, iters, blend)
        return f

    @contextlib.contextmanager
    def ctx():
        raft.raft_bi_forward, raft.raft_bi_forward_seqdir = (wrap(g) for g in fns)
        try:
            yield
        finally:
            raft.raft_bi_forward, raft.raft_bi_forward_seqdir = fns

    return ctx()


def path_c_run(need, forbid, ref_dir: str) -> dict:
    """Path C: `Pipeline.process` on the 100-frame 640x360 synthetic clip at
    default widgets with PROPAINTER_TPU_CLIP_PARALLEL=1 and no mesh: RAFT's
    9 chunks in one 108-pair call, the 2 completion and 2
    image-propagation chunks each as one batched call. bf16: a warm-up,
    then a timed run (launch counters reset just before it, each RAFT
    call's pairs and blend recorded); fp32: the same clip with and
    without the variable, held to the card-against-host tolerance; bf16
    without the variable, its differing bytes logged. Every output is
    checked (`check_video`); the fp32 and bf16 outputs with the variable
    are written to ref_dir for path M."""
    from comfyui_propainter_nodes_tpu_torch.nodes import get_pipeline
    from comfyui_propainter_nodes_tpu_torch.pipeline import stages
    from comfyui_propainter_nodes_tpu_torch.utils import profiling

    t, h, w = PATH_C
    tag = f"path C clip-parallel {t} frames {w}x{h}"
    args = path_inputs("cuda")
    pipe = get_pipeline(path_config("enable"), torch.device("cuda"), True)
    pipe32 = get_pipeline(path_config("disable"), torch.device("cuda"), True)
    forms = []
    os.environ["PROPAINTER_TPU_CLIP_PARALLEL"] = "1"
    try:
        form = stages.raft_form(pipe.config, t, (h, w), pipe._clip_dp())
        t0 = time.perf_counter()
        pipe.process(*args)
        log(f"  [{tag}] warm-up run {time.perf_counter() - t0:.3f} s")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counters()
        torch.cuda.synchronize()
        profiling.reset_stages()
        with recorded_raft(forms):
            t0 = time.perf_counter()
            out = pipe.process(*args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts, b2_shapes = read_counters()
        peak, stage_s = torch.cuda.max_memory_allocated(), stage_seconds()
        reset_counters()
        out32 = pipe32.process(*args)
        counts32, _ = read_counters()
    finally:
        os.environ.pop("PROPAINTER_TPU_CLIP_PARALLEL")
    log(f"  [{tag}] timed run (bf16) {wall:.3f} s = {t / wall:.3f} frames/s; stages (s): "
        + ", ".join(f"{k} {v:.4f}" for k, v in stage_s.items()))
    log(f"  [{tag}] max_memory_allocated {peak / 2**30:.3f} GiB; RAFT form {form!r}, calls (pairs, blend) {forms}")
    log(f"  [{tag}] launches {counts}; B2 launches by x shape {b2_shapes}")
    require_kernels(tag, counts, need, forbid)
    require(counts32["conv_gemm"] > 0, f"{tag}: the fp32 run's convs did not take conv_gemm: {counts32}")
    require(len(forms) == 1, f"{tag}: RAFT ran in {len(forms)} calls, not one")
    c16 = check_video(out, args[2], args[3], tag + " bf16")
    c32 = check_video(out32, args[2], args[3], tag + " fp32")
    in_turn32 = check_video(pipe32.process(*args), args[2], args[3], tag + " fp32, chunks in turn")
    in_turn16 = check_video(pipe.process(*args), args[2], args[3], tag + " bf16, chunks in turn")
    d32, d16 = video_diff(c32, in_turn32), video_diff(c16, in_turn16)
    log(f"  [{tag}] against the chunks in turn: fp32 {d32}; bf16 {d16}")
    require(within_tolerance(d32), f"{tag}: the fp32 clip-parallel run differs from the chunks in turn: {d32}")
    np.save(os.path.join(ref_dir, "disable.npy"), c32)
    np.save(os.path.join(ref_dir, "enable.npy"), c16)
    return dict(frames=t, size=f"{w}x{h}", seconds=wall, fps=t / wall, stages=stage_s, peak_bytes=peak,
                raft_form=form, raft_calls=forms, launches=counts, b2_launches_by_shape=b2_shapes,
                fp32_vs_in_turn=d32, bf16_vs_in_turn=d16)


# path M's meshes (data, model) and the kernels each must launch (the rest
# must not): clip-parallel stages 1-3 and window data parallelism on
# (2, 1); on (1, 2) the stages 1-3 in turn on both ranks (RAFT's 9 chunks
# a call each: all 99 pairs' volume, 6.98e9 bytes, passes the JAX stage's
# 4.5e9; 12 pairs take the lanes blend) and the sequence-parallel
# transformer, which takes no kernel (as in JAX). The
# windows of 100 frames hold 19 frames (11 local, 8 reference slots):
# the JAX size estimate, 14.9e6 and 14.1e6 at t_sel 10 and 9, sends
# them to B4 (B3 below 12e6, as on the 24-frame main path)
PATH_M_MESHES = {
    (2, 1): ("corr_lookup_map", "deform_conv", "window_attention_tiled", "prop_fill", "corr_pyramid"),
    (1, 2): ("corr_lookup", "deform_conv", "prop_fill", "corr_pyramid"),
}


def gather_seconds(mesh, nbytes: int) -> float:
    """Median of 3 of one all_gather over the mesh's data axis of a card
    tensor of nbytes a rank, synchronised on both sides."""
    from comfyui_propainter_nodes_tpu_torch.parallel.mesh import DATA_AXIS

    x = torch.ones(nbytes // 4, device=mesh.device)
    mesh.all_gather(x, DATA_AXIS)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mesh.all_gather(x, DATA_AXIS)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def feature_split(pipe, args) -> dict:
    """One more run of pipe with every `Mesh.all_gather` and every
    gathered-KV attention call (`ops/attention.py::_gathered_kv_attention`)
    timed, each synchronised on both sides: the feature stage's seconds,
    the gathers' (inside the attention and outside it: the transformer's
    output), their count and bytes, and the attention's seconds less its
    gathers. A gather's time includes its wait for the other rank."""
    from comfyui_propainter_nodes_tpu_torch.ops import attention
    from comfyui_propainter_nodes_tpu_torch.parallel.mesh import Mesh
    from comfyui_propainter_nodes_tpu_torch.utils import profiling

    spent = dict(gather_in_attention_s=0.0, gather_other_s=0.0, attention_s=0.0, gathers=0, gathered_bytes=0)
    inside = []
    gather, attend = Mesh.all_gather, attention._gathered_kv_attention

    def timed(fn, key):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            spent[key if key else ("gather_in_attention_s" if inside else "gather_other_s")] += time.perf_counter() - t0
            if not key and out is not a[1]:  # an axis of one rank returns x, gathering nothing
                spent["gathers"] += 1
                spent["gathered_bytes"] += out.numel() * out.element_size()
            return out
        return run

    def attend_timed(*a, **k):
        inside.append(1)
        try:
            return timed(attend, "attention_s")(*a, **k)
        finally:
            inside.pop()

    Mesh.all_gather, attention._gathered_kv_attention = timed(gather, None), attend_timed
    profiling.reset_stages()
    try:
        pipe.process(*args)
    finally:
        Mesh.all_gather, attention._gathered_kv_attention = gather, attend
    spent["feature_propagation_s"] = stage_seconds()["feature_propagation"]
    spent["attention_less_gathers_s"] = spent["attention_s"] - spent["gather_in_attention_s"]
    return spent


def path_m_rank(rank: int, world: int, backend: str, rendezvous: str, ref_dir: str) -> None:
    """One rank of path M (a process of its own): on each mesh of
    PATH_M_MESHES, `Pipeline.process` on path C's clip in fp32, then in
    bf16 a warm-up and a timed run, each run's launches counted (the bf16
    run's held to the mesh's kernels) and peak read; every output checked
    (`check_video`) and compared with path C's of the same dtype; on the
    first mesh also one all_gather of 64 MiB timed (`gather_seconds`).
    Writes its results to ref_dir/rank{rank}.json."""
    import datetime

    import torch.distributed as dist

    # ranks that share a card: blocks a rank frees go back to the card, not
    # to its own cache (read at the rank's first CUDA allocation)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    from comfyui_propainter_nodes_tpu_torch.parallel.mesh import make_mesh
    from comfyui_propainter_nodes_tpu_torch.pipeline.stages import Pipeline
    from comfyui_propainter_nodes_tpu_torch.utils import profiling, weights

    dist.init_process_group(backend, init_method=f"file://{rendezvous}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=M_COLLECTIVE_TIMEOUT_S))
    try:
        profiling.set_blocking(True)
        params = [weights.get_params(m, allow_download=False, allow_random=True) for m in ("raft", "flow_completion", "inpaint_generator")]
        results = {}
        for shape, need in PATH_M_MESHES.items():
            mesh = make_mesh(model_parallel=shape[1])
            args = path_inputs(mesh.device)
            if shape == (2, 1):
                results["all_gather_64MiB_s"] = gather_seconds(mesh, 64 << 20)
                log(f"  [path M rank {rank}] one all_gather of 64 MiB a rank over {backend}: "
                    f"{results['all_gather_64MiB_s']:.4f} s (median of 3)")
            for fp16 in ("disable", "enable"):
                tag = f"path M rank {rank} mesh {shape} fp16={fp16}"
                pipe = Pipeline(*params, path_config(fp16), mesh=mesh)
                if fp16 == "enable":
                    t0 = time.perf_counter()
                    pipe.process(*args)
                    log(f"  [{tag}] warm-up {time.perf_counter() - t0:.3f} s")
                dist.barrier()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                reset_counters()
                profiling.reset_stages()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = pipe.process(*args)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts, _ = read_counters()
                stages = stage_seconds()
                video = check_video(out, args[2], args[3], tag)
                if fp16 == "enable":  # the default widgets (fp32 maps take B1's one fp32 kernel)
                    require_kernels(tag, counts, need, [k for k in KERNELS if k not in need])
                else:
                    require(counts["conv_gemm"] > 0, f"{tag}: the fp32 convs did not take conv_gemm: {counts}")
                log(f"  [{tag}] {wall:.3f} s; stages (s) " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
                results[f"{shape[0]}x{shape[1]} {fp16}"] = dict(
                    seconds=wall, stages=stages, peak_bytes=torch.cuda.max_memory_allocated(),
                    launches=counts, vs_path_c=video_diff(video, np.load(os.path.join(ref_dir, f"{fp16}.npy"))),
                    clip_parallel=pipe._clip_parallel(), seq=pipe._seq_selected(PATH_C[1]), device=str(mesh.device),
                )
                if shape == (1, 2) and fp16 == "enable":  # where the sequence-parallel feature stage's time goes
                    results["feature_split"] = feature_split(pipe, args)
                    log(f"  [{tag}] the feature stage split (an extra run, synchronised timers): {results['feature_split']}")
                del pipe, out
        with open(os.path.join(ref_dir, f"rank{rank}.json"), "w") as f:
            json.dump(results, f)
    finally:
        dist.destroy_process_group()


def spawn_ranks(target, rank_args: list) -> None:
    """target(*args) in a process of its own (spawn) for each args of
    rank_args, after this process has handed its cached blocks back to
    the card. A rank that fails, or does not finish within
    M_JOIN_TIMEOUT_S, fails the script; every rank is stopped."""
    import gc
    import multiprocessing

    gc.collect()
    torch.cuda.empty_cache()
    log(f"  ranks: this process holds {torch.cuda.memory_reserved() / 2**30:.3f} GiB of the card")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=a) for a in rank_args]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(max(1.0, M_JOIN_TIMEOUT_S - (time.perf_counter() - t0)))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        require(not hung, f"ranks {hung} still running after {M_JOIN_TIMEOUT_S} s")
        codes = [p.exitcode for p in procs]
        require(codes == [0] * len(procs), f"rank exit codes {codes}")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(30)
            if p.is_alive():
                p.kill()
                p.join(30)


def path_m_run(ref_dir: str) -> dict:
    """Path M: two ranks, processes of their own (spawn), each running
    `path_m_rank`: on one card over gloo when the machine shows one card,
    a card each over NCCL otherwise (`backend_for`). A rank that fails, or
    does not finish within M_JOIN_TIMEOUT_S, fails the script (its
    collectives time out after M_COLLECTIVE_TIMEOUT_S); both are stopped.
    fp32 outputs are held to path C's fp32 output within the
    card-against-host tolerance; bf16 differing bytes are logged."""
    from comfyui_propainter_nodes_tpu_torch.parallel.mesh import backend_for

    world = 2
    backend = backend_for(world, "cuda")
    log(f"  path M: {world} ranks, {torch.cuda.device_count()} card(s), backend {backend}")
    t0 = time.perf_counter()
    spawn_ranks(path_m_rank, [(r, world, backend, os.path.join(ref_dir, "rendezvous"), ref_dir) for r in range(world)])
    log(f"  path M: both ranks done in {time.perf_counter() - t0:.1f} s (process start and kernel load included)")
    ranks = []
    for r in range(world):
        with open(os.path.join(ref_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    summary = {"all_gather_64MiB_s": [rk.pop("all_gather_64MiB_s") for rk in ranks],
               "feature_split_1x2_bf16": [rk.pop("feature_split") for rk in ranks]}
    for key in ranks[0]:
        per = [rk[key] for rk in ranks]
        for r, v in enumerate(per):
            log(f"  [path M {key}] rank {r} on {v['device']}: {v['seconds']:.3f} s = {PATH_C[0] / v['seconds']:.3f} "
                f"frames/s; peak {v['peak_bytes'] / 2**30:.3f} GiB; stages (s) "
                + ", ".join(f"{k} {s:.4f}" for k, s in v["stages"].items())
                + f"; launches {v['launches']}; against path C: {v['vs_path_c']}")
            if key.endswith("disable"):
                require(within_tolerance(v["vs_path_c"]), f"path M {key} rank {r}: fp32 output differs from path C's: {v['vs_path_c']}")
        wall = max(v["seconds"] for v in per)
        pair_peak = sum(v["peak_bytes"] for v in per)
        log(f"  [path M {key}] the pair: {wall:.3f} s = {PATH_C[0] / wall:.3f} frames/s (the slower rank); peaks summed "
            f"{pair_peak / 2**30:.3f} GiB")
        summary[key] = dict(seconds=wall, fps=PATH_C[0] / wall, peak_bytes_summed=pair_peak, ranks=per)
    # the kernels line's count: both ranks' timed bf16 runs on both meshes
    launches = {name: sum(v["launches"][name] for rk in ranks for k, v in rk.items() if k.endswith("enable"))
                for name in KERNELS}
    return dict(backend=backend, cards=torch.cuda.device_count(), meshes=summary, launches=launches)


# path MH: path A's clip (24 frames at 1280x720, default widgets) on mesh
# (1, 2): stages 1-3 whole on both ranks (path A's B1 map calls), the
# feature stage H-split (each rank 6 of the 12 window rows: pixel rows
# [0, 360) and [360, 720)); path A's kernels, B2's feature-propagation
# launches in the row form (x[5,180,320,128], 96 rows a rank)
PATH_MH = (24, 720, 1280)
PATH_MH_NEED = ("corr_lookup_map", "deform_conv", "window_attention_tiled", "prop_fill", "corr_pyramid")


def feature_peak(pipe, peaks: list):
    """pipe's feature stage wrapped to append to `peaks` (the peak allocated
    bytes of the run up to it, its own peak allocated bytes): the peak is
    read, then reset, just before the stage. The run's peak is the larger
    of the first and `max_memory_allocated()` after the run."""
    stage = pipe.feature_propagation

    def run(*a, **k):
        torch.cuda.synchronize()
        before = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = stage(*a, **k)
        torch.cuda.synchronize()
        peaks.append((before, torch.cuda.max_memory_allocated()))
        return out

    pipe.feature_propagation = run


def h_split_exchanges(pipe, args) -> dict:
    """One more run of pipe with every halo exchange (`halo_rows`) and every
    row gather (`gather_rows`: propagation's maps, the pooled tokens, the
    composed rows) of the H split timed apart, synchronised on both sides:
    their seconds, calls and the bytes their all_gathers and point-to-point
    receives bring to the rank (a call's time includes its wait for the
    other rank)."""
    from comfyui_propainter_nodes_tpu_torch.parallel import spatial
    from comfyui_propainter_nodes_tpu_torch.parallel.mesh import Mesh
    from comfyui_propainter_nodes_tpu_torch.utils import profiling

    spent = {f"{k}_{m}": 0 for k in ("halo", "gather") for m in ("s", "calls", "bytes")}
    inside = []
    halo, gather, all_gather, send_recv = spatial.halo_rows, spatial.gather_rows, Mesh.all_gather, Mesh.send_recv

    def timed(fn, key):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            inside.append(key)
            try:
                out = fn(*a, **k)
            finally:
                inside.pop()
            torch.cuda.synchronize()
            spent[key + "_s"] += time.perf_counter() - t0
            spent[key + "_calls"] += 1
            return out
        return run

    def counted(self, x, axis, dim=0):
        out = all_gather(self, x, axis, dim)
        if inside:
            spent[inside[-1] + "_bytes"] += out.numel() * out.element_size()
        return out

    def received(self, sends, recv_rows, axis, like):
        got = send_recv(self, sends, recv_rows, axis, like)
        if inside:
            spent[inside[-1] + "_bytes"] += sum(t.numel() * t.element_size() for t in got.values())
        return got

    spatial.halo_rows, spatial.gather_rows = timed(halo, "halo"), timed(gather, "gather")
    Mesh.all_gather, Mesh.send_recv = counted, received
    profiling.reset_stages()
    try:
        pipe.process(*args)
    finally:
        spatial.halo_rows, spatial.gather_rows, Mesh.all_gather, Mesh.send_recv = halo, gather, all_gather, send_recv
    spent["feature_propagation_s"] = stage_seconds()["feature_propagation"]
    return spent


def path_mh_single(ref_dir: str) -> dict:
    """Path MH's single-card reference: `Pipeline.process` on its clip with
    no mesh, fp32 (written to ref_dir for the ranks) and bf16 after a
    warm-up, each with its peak and its feature stage's peak."""
    from comfyui_propainter_nodes_tpu_torch.pipeline.stages import Pipeline
    from comfyui_propainter_nodes_tpu_torch.utils import profiling, weights

    params = [weights.get_params(m, allow_download=False, allow_random=True) for m in ("raft", "flow_completion", "inpaint_generator")]
    args = path_inputs("cuda", PATH_MH)
    out = {}
    for fp16 in ("disable", "enable"):
        pipe = Pipeline(*params, path_config(fp16, PATH_MH), device="cuda")
        if fp16 == "enable":
            pipe.process(*args)
        peaks = []
        feature_peak(pipe, peaks)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        profiling.reset_stages()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        video = pipe.process(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stages = stage_seconds()
        peak = max(peaks[0][0], torch.cuda.max_memory_allocated())
        np.save(os.path.join(ref_dir, f"mh_{fp16}.npy"), check_video(video, args[2], args[3], f"path MH single card {fp16}", PATH_MH))
        out[fp16] = dict(seconds=wall, stages=stages, peak_bytes=peak, feature_peak_bytes=peaks[0][1])
        log(f"  [path MH single card fp16={fp16}] {wall:.3f} s; peak {peak / 2**30:.3f} GiB, feature stage "
            f"{peaks[0][1] / 2**30:.3f} GiB; stages (s) "
            + ", ".join(f"{k} {v:.4f}" for k, v in stages.items()))
        del pipe, video
    return out


def path_mh_rank(rank: int, world: int, backend: str, rendezvous: str, ref_dir: str) -> None:
    """One rank of path MH (a process of its own) on mesh (1, 2):
    `Pipeline.process` on path A's clip in fp32, then in bf16 a warm-up, a
    timed run and a run with the H split's exchanges timed apart
    (`h_split_exchanges`); each timed run's launches (B2's by shape),
    stage times, peak and feature-stage peak; every output checked
    (`check_video`) and compared with the single card's of the same
    dtype. Writes its results to ref_dir/mh_rank{rank}.json."""
    import datetime

    import torch.distributed as dist

    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    from comfyui_propainter_nodes_tpu_torch.parallel.mesh import make_mesh
    from comfyui_propainter_nodes_tpu_torch.pipeline.stages import Pipeline
    from comfyui_propainter_nodes_tpu_torch.utils import profiling, weights

    dist.init_process_group(backend, init_method=f"file://{rendezvous}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=M_COLLECTIVE_TIMEOUT_S))
    try:
        profiling.set_blocking(True)
        params = [weights.get_params(m, allow_download=False, allow_random=True) for m in ("raft", "flow_completion", "inpaint_generator")]
        mesh = make_mesh(model_parallel=2)
        args = path_inputs(mesh.device, PATH_MH)
        results = {}
        for fp16 in ("disable", "enable"):
            tag = f"path MH rank {rank} fp16={fp16}"
            pipe = Pipeline(*params, path_config(fp16, PATH_MH), mesh=mesh)
            if fp16 == "enable":
                t0 = time.perf_counter()
                pipe.process(*args)
                log(f"  [{tag}] warm-up {time.perf_counter() - t0:.3f} s")
            peaks = []
            feature_peak(pipe, peaks)
            dist.barrier()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_counters()
            profiling.reset_stages()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = pipe.process(*args)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            stages = stage_seconds()
            peak = max(peaks[0][0], torch.cuda.max_memory_allocated())  # stages 1-3, and the feature stage on
            counts, b2_shapes = read_counters()
            video = check_video(out, args[2], args[3], tag, PATH_MH)
            if fp16 == "enable":
                require_kernels(tag, counts, PATH_MH_NEED, [k for k in KERNELS if k not in PATH_MH_NEED])
            else:
                require(counts["conv_gemm"] > 0, f"{tag}: the fp32 convs did not take conv_gemm: {counts}")
            require(any("rows" in k for k in b2_shapes), f"{tag}: B2 never ran in its row form: {b2_shapes}")
            results[fp16] = dict(
                seconds=wall, stages=stages, peak_bytes=peak, feature_peak_bytes=peaks[0][1],
                launches=counts, b2_launches_by_shape=b2_shapes, seq=pipe._seq_selected(PATH_MH[1]),
                vs_single=video_diff(video, np.load(os.path.join(ref_dir, f"mh_{fp16}.npy"))), device=str(mesh.device),
            )
            log(f"  [{tag}] {wall:.3f} s; stages (s) " + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
            if fp16 == "enable":
                results["exchanges"] = h_split_exchanges(pipe, args)
                log(f"  [{tag}] the H split's exchanges (an extra run, synchronised timers): {results['exchanges']}")
            del pipe, out
        with open(os.path.join(ref_dir, f"mh_rank{rank}.json"), "w") as f:
            json.dump(results, f)
    finally:
        dist.destroy_process_group()


def path_mh_run(ref_dir: str) -> dict:
    """Path MH: the single-card reference (`path_mh_single`), then two ranks
    spawned as path M's (`path_mh_rank`). Each rank's fp32 video is held
    to the single card's within the card-against-host tolerance (and to
    the input outside the dilated mask, in the rank); bf16 differing
    bytes are logged; per-rank and single-card feature-stage peaks side
    by side."""
    from comfyui_propainter_nodes_tpu_torch.parallel.mesh import backend_for

    single = path_mh_single(ref_dir)
    world = 2
    backend = backend_for(world, "cuda")
    t0 = time.perf_counter()
    spawn_ranks(path_mh_rank, [(r, world, backend, os.path.join(ref_dir, "mh_rendezvous"), ref_dir) for r in range(world)])
    log(f"  path MH: both ranks done in {time.perf_counter() - t0:.1f} s (process start and kernel load included)")
    ranks = []
    for r in range(world):
        with open(os.path.join(ref_dir, f"mh_rank{r}.json")) as f:
            ranks.append(json.load(f))
    t = PATH_MH[0]
    for fp16 in ("disable", "enable"):
        for r, rk in enumerate(ranks):
            v = rk[fp16]
            require(not v["seq"], f"path MH rank {r}: the feature stage did not take the H split")
            log(f"  [path MH {fp16}] rank {r}: {v['seconds']:.3f} s = {t / v['seconds']:.3f} frames/s; peak "
                f"{v['peak_bytes'] / 2**30:.3f} GiB, feature stage {v['feature_peak_bytes'] / 2**30:.3f} GiB (single card "
                f"{single[fp16]['peak_bytes'] / 2**30:.3f}, feature stage {single[fp16]['feature_peak_bytes'] / 2**30:.3f}); "
                "stages (s) "
                + ", ".join(f"{k} {s:.4f}" for k, s in v["stages"].items())
                + f"; launches {v['launches']}; B2 by shape {v['b2_launches_by_shape']}; against the single card: {v['vs_single']}")
            if fp16 == "disable":
                require(within_tolerance(v["vs_single"]), f"path MH rank {r}: fp32 output differs from the single card's: {v['vs_single']}")
    wall = max(rk["enable"]["seconds"] for rk in ranks)
    log(f"  [path MH] bf16: {wall:.3f} s = {t / wall:.3f} frames/s (the slower rank); single card {single['enable']['seconds']:.3f} s")
    # the kernels line's count: both ranks' timed bf16 runs
    launches = {name: sum(rk["enable"]["launches"][name] for rk in ranks) for name in KERNELS}
    return dict(backend=backend, cards=torch.cuda.device_count(), seconds=wall, fps=t / wall, single_card=single,
                exchanges=[rk.pop("exchanges") for rk in ranks], ranks=ranks, launches=launches,
                b2_launches_by_shape=[rk["enable"]["b2_launches_by_shape"] for rk in ranks])


# ------------------------------------------------------------------ path T

# path T: the training step (training/train_step.py) at ProPainter's
# published training recipe (sczhou/ProPainter configs/train_propainter.json:
# 432x240 frames, num_local_frames 10, num_ref_frames 6), a batch of 2
# clips, the InpaintGenerator at full width in fp32 with random weights,
# AdamW. Its attention inputs (16 frames, t_sel 8, 4 heads) give the JAX
# size estimate 21.5e6: B4 on the single card; the (1, 2) ranks' 2 heads
# give 10.7e6, under 12e6: B3 there
PATH_T = dict(clips=2, local=10, ref=6, h=240, w=432)
PATH_T_STEPS = 5
PATH_T_NEED = ("deform_conv", "window_attention_tiled")
PATH_T_RANK_NEED = ("deform_conv", "window_attention")
# the weights the ranks' first step is held to (JAX's own test's check)
PATH_T_CHECKED = {"transformers.transformer.0.attention.query.weight": 0, "transformers.transformer.0.mlp.fc2.1.weight": 1}


def path_t_clip():
    """(frames, h, w) of path T's clips laid end to end in one synthetic clip."""
    c = PATH_T
    return c["clips"] * (c["local"] + c["ref"]), c["h"], c["w"]


def path_t_occupancy():
    """Path T's occupied token windows: each clip's local frames' dilated
    masks on the 20x36 token grid (16 windows a clip)."""
    c = PATH_T
    md = path_inputs("cuda", path_t_clip())[2][0, ..., 0]
    t_clip = c["local"] + c["ref"]
    return torch.cat([occupied(token_pool(md[i * t_clip : i * t_clip + c["local"]])) for i in range(c["clips"])])


def check_grad(tag, fn, plain, args, n_diff: int, kw: dict, gen, sdpa=None) -> dict:
    """A kernel's Function (fp32, grad mode on) against its plain version
    on args: the output has a grad_fn and equals the plain output; each
    gradient of the first n_diff inputs for a seeded output gradient is
    within 1e-4 of the plain version's largest. Timed: the Function's
    forward (the kernel) and backward (the plain version's forward and
    backward), and `sdpa()` (SDPA's forward and backward on the same
    inputs) where given."""
    leaves = [a.detach().requires_grad_() for a in args[:n_diff]]
    rest = args[n_diff:]
    out = fn(*leaves, *rest, **kw)
    require(out.grad_fn is not None, f"{tag}: the kernel's output has no grad_fn")
    gout = torch.randn(out.shape, generator=gen, device="cuda")
    got = torch.autograd.grad(out, leaves, gout, retain_graph=True)
    ref_leaves = [a.detach().requires_grad_() for a in args[:n_diff]]
    ref = plain(*ref_leaves, *rest, **kw)
    want = torch.autograd.grad(ref, ref_leaves, gout)
    out_err, out_rel = rel_err(out.detach(), ref.detach())
    errs = [(g - w).abs().max().item() / max(w.abs().max().item(), 1e-30) for g, w in zip(got, want)]
    log(f"  {tag} fp32 gradients: output max_abs_err {out_err:.3e} rel {out_rel:.3e}; each input's gradient against "
        f"the plain version's, max |d| / max |g|: " + ", ".join(f"{e:.2e}" for e in errs) + " (tol 1e-4)")
    require(out_rel <= 1e-4 and max(errs) <= 1e-4, f"{tag}: the Function's gradients disagree with the plain version's")
    del ref, want, ref_leaves
    res = dict(max_abs_err=out_err, max_rel_grad_err=max(errs),
               forward_ms=time_ms(lambda: fn(*leaves, *rest, **kw), reps=5, warmup=1, batch=1),
               backward_ms=time_ms(lambda: torch.autograd.grad(out, leaves, gout, retain_graph=True), reps=5,
                                   warmup=1, batch=1))
    if sdpa is not None:
        res["sdpa_fwd_bwd_ms"] = time_ms(sdpa, reps=5, warmup=1, batch=1)
    log(f"    forward (kernel) {res['forward_ms']:.4f} ms, backward (plain forward + backward) {res['backward_ms']:.4f} ms"
        + (f"; SDPA forward + backward on the same inputs {res['sdpa_fwd_bwd_ms']:.4f} ms" if sdpa else ""))
    return res


def path_t_grad_checks(gen) -> dict:
    """Phase 2's gradients, fp32, at path T's shapes: B2 at a feature
    propagation step (x [2, 60, 108, 128]), B3 and B4 at a transformer
    layer's attention (2 clips x 16 windows of 16 frames, t_sel 8, with
    path T's occupancy) and B5 on the same token grid (20x36)."""
    from comfyui_propainter_nodes_tpu_torch.ops.cuda import deform_conv as b2
    from comfyui_propainter_nodes_tpu_torch.ops.cuda import window_attention as wa
    from comfyui_propainter_nodes_tpu_torch.ops.cuda import window_attention_halo as b5

    c = PATH_T
    b, t = c["clips"], c["local"] + c["ref"]
    occ = path_t_occupancy()
    n_win = occ.numel() // b
    log(f"  path T's token windows: {int(occ.sum())}/{occ.numel()} occupied ({n_win} a clip)")
    res = {}
    args = deform_inputs(torch.float32, gen, (b, c["h"] // 4, c["w"] // 4, 128))
    res["B2"] = check_grad(f"B2 deform_conv x[{b},{c['h'] // 4},{c['w'] // 4},128]", b2.deform_conv2d,
                           b2.deform_conv2d_plain, args, 5, {}, gen)
    args = attention_inputs(torch.float32, gen, n_win, t // 2, 45, occ, b, t)
    require(wa.uses_tiled(args[0], args[3], args[5]), "path T's attention inputs must pass the size estimate")
    sdpa = attention_library(args, n_win, grad=True)
    kw = dict(n_win_per_b=n_win)
    for key, fn, plain in (("B3", wa.window_attention, wa.window_attention_plain),
                           ("B4", wa.window_attention_tiled, wa.window_attention_tiled_plain)):
        res[key] = check_grad(f"{key} at path T's attention", fn, plain, args, 7, kw, gen, sdpa)
    args = halo_inputs(torch.float32, gen, b, t, t // 2, (20, 36), occ)
    res["B5"] = check_grad("B5 on path T's token grid", b5.window_attention_halo, b5.window_attention_halo_plain,
                           args, 7, dict(window_size=(5, 9), n_head=4), gen)
    return res


def path_t_batch() -> dict:
    """Path T's batch on the card: frames [2, 16, 240, 432, 3] in [-1, 1]
    and masks (dilated, as the node prepares them) of the synthetic clip,
    clip i its frames 16i..16i+15 (10 local, then 6 reference); flows
    [2, 9, 240, 432, 2] of each clip's local frames from the port's own
    `compute_flow` and `complete_flow` at default widgets under inference
    mode (B1, B2), cast to fp32 and cloned out of it."""
    from comfyui_propainter_nodes_tpu_torch.nodes import get_pipeline

    c = PATH_T
    t_clip = c["local"] + c["ref"]
    clip = path_t_clip()
    fnorm, fm, md, _ = path_inputs("cuda", clip)
    pipe = get_pipeline(path_config("enable", clip), torch.device("cuda"), True)
    flows = []
    with torch.inference_mode():
        for i in range(c["clips"]):
            s = i * t_clip
            flows.append(pipe.complete_flow(pipe.compute_flow(fnorm[:, s : s + c["local"]]), fm[:, s : s + c["local"]]))

    def clips(a):  # [1, clips * t_clip, ...] -> [clips, t_clip, ...]
        return a.reshape(c["clips"], t_clip, *a.shape[2:]).clone()

    return {"frames": clips(fnorm), "masks": clips(md), "flows_f": torch.cat([f for f, _ in flows]).float().clone(),
            "flows_b": torch.cat([f for _, f in flows]).float().clone()}


def plain_attention(*args, n_win_per_b):
    """`window_attention_dispatch` with the plain versions."""
    from comfyui_propainter_nodes_tpu_torch.ops.cuda import window_attention as wa

    plain = wa.window_attention_tiled_plain if wa.uses_tiled(args[0], args[3], args[5]) else wa.window_attention_plain
    return plain(*args, n_win_per_b)


@contextlib.contextmanager
def plain_kernels():
    """The generator's wrapped kernels (B2, and B3/B4 through the
    dispatcher) replaced by their plain versions for the block, by
    patching the attributes the model calls."""
    from comfyui_propainter_nodes_tpu_torch.models import propainter as pp
    from comfyui_propainter_nodes_tpu_torch.ops import attention as att
    from comfyui_propainter_nodes_tpu_torch.ops.cuda import deform_conv as b2

    saved = pp.deform_conv2d, att.window_attention_dispatch
    pp.deform_conv2d, att.window_attention_dispatch = b2.deform_conv2d_plain, plain_attention
    try:
        yield
    finally:
        pp.deform_conv2d, att.window_attention_dispatch = saved


@contextlib.contextmanager
def twins_backward_timed(spent: dict):
    """Every `TwinGrad` backward (the plain versions' forward and backward)
    synchronised on both sides and timed into spent["s"] / spent["calls"]."""
    from comfyui_propainter_nodes_tpu_torch.ops.cuda import _grad

    orig = _grad.TwinGrad.backward

    def timed(ctx, grad):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(ctx, grad)
        torch.cuda.synchronize()
        spent["s"] += time.perf_counter() - t0
        spent["calls"] += 1
        return out

    _grad.TwinGrad.backward = staticmethod(timed)
    try:
        yield spent
    finally:
        _grad.TwinGrad.backward = staticmethod(orig)


def split_of(summary: dict) -> dict:
    return {k: v["seconds"] for k, v in summary.items() if k.startswith("train_")}


def path_t_first_step(tag: str, batch: dict, params: dict, step) -> dict:
    """Path T's first step with the plain versions of the kernels
    (`plain_kernels`), again with torch's deterministic algorithms, and
    with the kernels (the warm-up), each from a fresh state of params:
    the kernels' state after it, its loss, the loss's relative distance
    to the plain step's, each param's gradient distance (`grad_errs`, max
    |d| over the largest entry; the key biases and the deformable
    alignment over the largest gradient of all) and the worst, logged."""
    from comfyui_propainter_nodes_tpu_torch.training.train_step import init_state

    def plain_step(deterministic: bool):
        """The first step with the plain versions: (loss, gradients)."""
        state = init_state(params)
        reset_counters()
        torch.use_deterministic_algorithms(deterministic, warn_only=True)
        try:
            with plain_kernels():
                state, loss = step(state, batch)
        finally:
            torch.use_deterministic_algorithms(False)
        counts, _ = read_counters()
        require(not any(counts.values()), f"{tag}: a kernel launched in the plain reference step: {counts}")
        return loss, {k: p.grad for k, p in state.params.items()}

    twin_loss, twin_grads = plain_step(False)
    # the same step with torch's deterministic algorithms: how far rounding
    # alone moves the gradients (the floor the kernels' step is read against)
    det_grads = plain_step(True)[1]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = init_state(params)
    t0 = time.perf_counter()
    state, loss = step(state, batch)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    first_loss = loss.item()
    loss_rel = abs(loss.item() - twin_loss.item()) / abs(twin_loss.item())
    # Each gradient within 1e-4 of its own largest entry, but for two kinds
    # of param, held to the largest gradient of all: the key biases, whose
    # gradient is zero in exact arithmetic (softmax ignores a constant
    # added to all of a query's logits), and the deformable alignment's
    # (its offset net and B2's weights), which reach the loss through
    # bilinear sampling: a rounding change in the forward moves samples
    # across cell edges, where the gradient jumps
    gmax = max(g.abs().max().item() for g in twin_grads.values())

    def errs(grads):
        return {k: (grads[k] - twin_grads[k]).abs().max().item()
                / max(gmax if k.endswith(".attention.key.bias") or ".deform_align." in k
                      else twin_grads[k].abs().max().item(), 1e-30) for k in twin_grads}

    grad_errs = errs({k: p.grad for k, p in state.params.items()})
    floor = errs(det_grads)
    worst = max(grad_errs, key=grad_errs.get)
    own = {k: (p.grad - twin_grads[k]).abs().max().item() / max(twin_grads[k].abs().max().item(), 1e-30)
           for k, p in state.params.items() if k.endswith(".attention.key.bias") or ".deform_align." in k}
    log(f"  [{tag}] first step (warm-up, {warm:.3f} s): loss {loss.item():.7f}, with the plain versions "
        f"{twin_loss.item():.7f} (rel {loss_rel:.2e}, tol 1e-5); gradients, max |d| / max |g| (tol 1e-4; the key "
        f"biases and the deformable alignment against the largest gradient, {gmax:.3e}): worst {grad_errs[worst]:.2e} "
        f"({worst}), next " + ", ".join(f"{k} {v:.2e}" for k, v in sorted(grad_errs.items(), key=lambda kv: -kv[1])[1:4])
        + f"; the plain step with deterministic algorithms against it: worst {max(floor.values()):.2e} "
        f"({max(floor, key=floor.get)}); the tensors held to the largest gradient, against their own: worst "
        + ", ".join(f"{k} {v:.2e}" for k, v in sorted(own.items(), key=lambda kv: -kv[1])[:3]))
    return dict(state=state, loss=first_loss, plain_loss=twin_loss.item(), loss_rel=loss_rel, grad_errs=grad_errs,
                worst=worst, floor=max(floor.values()), own=own, seconds=warm)


def path_t_run(ref_dir: str) -> dict:
    """Path T on the single card: the batch (`path_t_batch`, written to
    ref_dir for the ranks); the first step with the plain versions of the
    kernels (`plain_kernels`) from one copy of the weights, and with the
    kernels from another (the warm-up): loss within rtol 1e-5, each param's
    gradient within 1e-4 of its largest entry; its loss and the checked
    weights after it written to ref_dir; then PATH_T_STEPS timed steps
    (launch counters reset before each: B2 and B4 in every step, nothing
    else), their forward / backward / update split (blocking stage
    timers), the peak, and one more step with the twins' backward timed
    apart. Every loss and param finite."""
    from comfyui_propainter_nodes_tpu_torch.training.train_step import make_train_step
    from comfyui_propainter_nodes_tpu_torch.utils import profiling, weights

    c = PATH_T
    tag = f"path T {c['clips']} clips of {c['local']} + {c['ref']} frames {c['w']}x{c['h']}"
    t0 = time.perf_counter()
    batch = path_t_batch()
    log(f"  [{tag}] batch and its flows in {time.perf_counter() - t0:.2f} s: "
        + ", ".join(f"{k} {list(v.shape)}" for k, v in batch.items()))
    torch.save({k: v.cpu() for k, v in batch.items()}, os.path.join(ref_dir, "path_t_batch.pt"))
    params = weights.get_params("inpaint_generator", allow_download=False, allow_random=True)
    step = make_train_step(None, c["local"])
    first = path_t_first_step(tag, batch, params, step)
    state, first_loss, loss_rel, grad_errs, worst = (first[k] for k in ("state", "loss", "loss_rel", "grad_errs", "worst"))
    require(loss_rel <= 1e-5, f"{tag}: the first step's loss differs from the plain versions' step")
    require(grad_errs[worst] <= 1e-4, f"{tag}: {worst}'s gradient differs from the plain versions' step")
    torch.save({"loss": first_loss, "params": {k: state.params[k].detach().cpu() for k in PATH_T_CHECKED},
                "grads": {k: state.params[k].grad.cpu() for k in PATH_T_CHECKED}},
               os.path.join(ref_dir, "path_t_single.pt"))
    profiling.reset_stages()
    walls, losses, per_step = [], [], []
    for _ in range(PATH_T_STEPS):
        reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step(state, batch)
        losses.append(loss.item())
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts, b2_shapes = read_counters()
        require_kernels(tag, counts, PATH_T_NEED, [k for k in KERNELS if k not in PATH_T_NEED])
        per_step.append(counts)
    split = {k: v / PATH_T_STEPS for k, v in split_of(profiling.summary()).items()}
    peak = torch.cuda.max_memory_allocated()
    twins = {"s": 0.0, "calls": 0}
    profiling.reset_stages()
    with twins_backward_timed(twins):
        state, loss = step(state, batch)
    twins["backward_s"] = split_of(profiling.summary())["train_backward"]
    finite = all(math.isfinite(x) for x in losses) and all(bool(torch.isfinite(p).all()) for p in state.params.values())
    require(finite, f"{tag}: a loss or a param is not finite")
    med = statistics.median(walls)
    log(f"  [{tag}] {PATH_T_STEPS} timed steps (s): " + ", ".join(f"{w:.4f}" for w in walls) + f"; median {med:.4f} s = "
        f"{c['clips'] / med:.3f} clips/s = {c['clips'] * (c['local'] + c['ref']) / med:.2f} frames/s; a step's mean "
        "split (blocking timers): " + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
    log(f"  [{tag}] max_memory_allocated {peak / 2**30:.3f} GiB (first and timed steps); losses "
        + ", ".join(f"{x:.6f}" for x in losses) + f"; launches a step {per_step[0]}; B2 by x shape {b2_shapes}")
    log(f"  [{tag}] one more step, the twins' backward timed apart: {twins['calls']} calls, {twins['s']:.4f} s of the "
        f"backward's {twins['backward_s']:.4f} s")
    require(all(p == per_step[0] for p in per_step), f"{tag}: the launches differ between steps: {per_step}")
    launches = {k: sum(p[k] for p in per_step) for k in per_step[0]}
    return dict(clips=c["clips"], frames_per_clip=c["local"] + c["ref"], size=f"{c['w']}x{c['h']}",
                step_seconds=walls, median_step_s=med, clips_per_s=c["clips"] / med,
                frames_per_s=c["clips"] * (c["local"] + c["ref"]) / med, split_s=split, peak_bytes=peak,
                losses=losses, first_step=dict(loss=first_loss, plain_loss=first["plain_loss"], loss_rel=loss_rel,
                                               worst_grad=worst, worst_grad_err=grad_errs[worst],
                                               seconds=first["seconds"], deterministic_plain_worst_err=first["floor"],
                                               own_scale_errs=first["own"]),
                twins_backward=twins, launches=launches, launches_per_step=per_step[0], b2_launches_by_shape=b2_shapes)


def path_t_rank(rank: int, world: int, backend: str, rendezvous: str, ref_dir: str) -> None:
    """One rank of path T on mesh (1, 2) (a process of its own): path T's
    batch and initial weights, the step tensor-parallel over the two
    ranks; the first step held to the single card's: the loss (rtol 2e-5),
    the PATH_T_CHECKED weights' gradients, gathered (within 1e-4 of their
    largest), and the weights after the step within atol 1e-5, rtol 1e-4
    (JAX's bounds) wherever the single card's gradient is past 1e-7 (ten
    times AdamW's eps; below it the first update lr g / (|g| + eps) turns
    with the gradient's rounding: those components are counted apart, and
    at most 1e-4 of them may fall outside); the second step timed. Writes its results to ref_dir/t_rank{rank}.json."""
    import datetime

    import torch.distributed as dist

    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    from comfyui_propainter_nodes_tpu_torch.parallel.mesh import MODEL_AXIS, make_mesh
    from comfyui_propainter_nodes_tpu_torch.training.train_step import init_state, make_train_step
    from comfyui_propainter_nodes_tpu_torch.utils import profiling, weights

    dist.init_process_group(backend, init_method=f"file://{rendezvous}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=M_COLLECTIVE_TIMEOUT_S))
    try:
        profiling.set_blocking(True)
        mesh = make_mesh(model_parallel=2)
        batch = {k: v.to(mesh.device) for k, v in torch.load(os.path.join(ref_dir, "path_t_batch.pt")).items()}
        single = torch.load(os.path.join(ref_dir, "path_t_single.pt"))
        state = init_state(weights.get_params("inpaint_generator", allow_download=False, allow_random=True), mesh)
        step = make_train_step(mesh, PATH_T["local"])
        results = {}
        for i in range(2):
            reset_counters()
            profiling.reset_stages()
            dist.barrier()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state, loss = step(state, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts, _ = read_counters()
            r = dict(seconds=wall, loss=loss.item(), launches=counts, split_s=split_of(profiling.summary()),
                     peak_bytes=torch.cuda.max_memory_allocated(), device=str(mesh.device))
            if i == 0:
                r["loss_rel"] = abs(loss.item() - single["loss"]) / abs(single["loss"])
                r["weights"] = {}
                for k, dim in PATH_T_CHECKED.items():
                    got = mesh.all_gather(state.params[k].detach(), MODEL_AXIS, dim=dim).cpu()
                    grad = mesh.all_gather(state.params[k].grad, MODEL_AXIS, dim=dim).cpu()
                    ref, gref = single["params"][k], single["grads"][k]
                    excess = (got - ref).abs() - (1e-5 + 1e-4 * ref.abs())  # <= 0 within JAX's bounds
                    # AdamW's first update is lr g / (|g| + 1e-8): about +-lr where |g| is past
                    # 10 eps, but turning with the gradient's rounding where it is smaller
                    turning = gref.abs() <= 1e-7
                    r["weights"][k] = dict(
                        worst_excess=excess[~turning].max().item(), components=got.numel(),
                        small_grad_components=int(turning.sum()), small_grad_over=int((excess[turning] > 0).sum()),
                        small_grad_worst_excess=excess[turning].max().item() if turning.any() else None,
                        small_grad_over_largest_grad=gref[turning & (excess > 0)].abs().max().item()
                        if bool((turning & (excess > 0)).any()) else None,
                        grad_rel_err=(grad - gref).abs().max().item() / gref.abs().max().item(),
                        grad_max=gref.abs().max().item())
            results[f"step{i + 1}"] = r
            log(f"  [path T rank {rank} mesh (1, 2) step {i + 1}] {wall:.3f} s, loss {loss.item():.7f}; launches {counts}")
        with open(os.path.join(ref_dir, f"t_rank{rank}.json"), "w") as f:
            json.dump(results, f)
    finally:
        dist.destroy_process_group()


def path_t_ranks_run(ref_dir: str, single: dict) -> dict:
    """Path T on mesh (1, 2): two ranks spawned as path M's (`path_t_rank`),
    both held to the single card's first step; the second step's wall is
    the slower rank's."""
    from comfyui_propainter_nodes_tpu_torch.parallel.mesh import backend_for

    world = 2
    backend = backend_for(world, "cuda")
    t0 = time.perf_counter()
    spawn_ranks(path_t_rank, [(r, world, backend, os.path.join(ref_dir, "t_rendezvous"), ref_dir) for r in range(world)])
    log(f"  path T ranks: both done in {time.perf_counter() - t0:.1f} s (process start and kernel load included)")
    ranks = []
    for r in range(world):
        with open(os.path.join(ref_dir, f"t_rank{r}.json")) as f:
            ranks.append(json.load(f))
    for r, rk in enumerate(ranks):
        first, second = rk["step1"], rk["step2"]
        log(f"  [path T mesh (1, 2) rank {r}] first step: loss rel to the single card {first['loss_rel']:.2e} (tol 2e-5), "
            f"the checked weights {first['weights']}; second step {second['seconds']:.4f} s, "
            f"split {second['split_s']}, peak {second['peak_bytes'] / 2**30:.3f} GiB")
        require(first["loss_rel"] <= 2e-5, f"path T rank {r}: the first step's loss differs from the single card's")
        require(all(v["worst_excess"] <= 0 and v["grad_rel_err"] <= 1e-4 and v["small_grad_over"] <= 1e-4 * v["components"]
                    for v in first["weights"].values()),
                f"path T rank {r}: the weights or gradients of the first step differ from the single card's")
        for st in (first, second):
            require_kernels(f"path T rank {r}", st["launches"], PATH_T_RANK_NEED,
                            [k for k in KERNELS if k not in PATH_T_RANK_NEED])
    wall = max(rk["step2"]["seconds"] for rk in ranks)
    c = PATH_T
    log(f"  [path T mesh (1, 2)] the second step {wall:.4f} s = {c['clips'] / wall:.3f} clips/s (the slower rank); "
        f"single card {single['median_step_s']:.4f} s")
    launches = {name: sum(rk[s]["launches"][name] for rk in ranks for s in ("step1", "step2")) for name in KERNELS}
    return dict(backend=backend, cards=torch.cuda.device_count(), seconds=wall, clips_per_s=c["clips"] / wall,
                ranks=ranks, launches=launches)


KEEP = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")  # a kernels row's numbers


def subset(r: dict, keys) -> dict:
    return {k: r[k] for k in keys}


def fp32_of(r: dict) -> dict:
    return dict(max_abs_err_fp32=r["max_abs_err"], ms_fp32=r["ms"])


def weights_cache() -> tempfile.TemporaryDirectory:
    """The three models' seeded random weights written as the `.jax.npz`
    cache files `get_params` reads first, in a temporary directory named by
    PROPAINTER_TPU_WEIGHTS (the ranks inherit it), and each loaded from
    there once (no random fallback allowed): every node, pipeline and rank
    of the run takes the cache branch, and nothing is downloaded."""
    from comfyui_propainter_nodes_tpu_torch.utils import checkpoint, weights

    d = tempfile.TemporaryDirectory(prefix="propainter_weights_")
    t0 = time.perf_counter()
    for model, fname in weights.MODEL_FILES.items():
        checkpoint.save_params(weights.random_params(model), os.path.join(d.name, os.path.splitext(fname)[0] + ".jax.npz"))
    os.environ["PROPAINTER_TPU_WEIGHTS"] = d.name
    weights._PARAM_CACHE.clear()
    for model in weights.MODEL_FILES:
        weights.get_params(model, allow_download=False)
    log(f"  random weights written as .jax.npz caches and loaded from them in {time.perf_counter() - t0:.2f} s")
    return d


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    for k in SWITCHES:
        os.environ.pop(k, None)  # the main path and path A run the default kernels
    if len(sys.argv) == 2 and sys.argv[1] == "--conv-gemm":
        return conv_gemm_times()
    t_start = time.perf_counter()
    weights_dir = weights_cache()
    from comfyui_propainter_nodes_tpu_torch.ops.cuda import _build
    from comfyui_propainter_nodes_tpu_torch.utils import profiling

    profiling.set_blocking(True)  # stage times synchronised on the card
    name = torch.cuda.get_device_name(0)
    log(f"device: {name}, torch {torch.__version__}, cuda {torch.version.cuda}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    log("phase 1: build")
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    log(f"  kernels built in {time.perf_counter() - t0:.2f} s")
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "ptxas.log"), "w") as f:
        f.write(_build.build_log)
    resources = kernel_resources(_build.build_log, lib_path)
    for kname, r in resources.items():
        log(f"  {kname}: {r['registers']} registers, spill stores {r['spill_stores']} B, loads "
            f"{r['spill_loads']} B, smem {r['smem']} B static, HMMA {r['hmma']}")
    mma_kernels = ["window_attention_mma_kernel", "window_attention_split_mma_kernel", "window_attention_halo_mma_kernel"]
    mma_kernels += [f"deform_conv_mma_kernel<{rows},{vec}>" for rows in (64, 32) for vec in (1, 0)]
    for kname in mma_kernels:
        require(resources[kname]["hmma"] > 0, f"{kname} has no tensor-core instruction in its SASS")
    # the fp32 loop of B3, B4 and B5 (csrc/flash_f32.cuh), 16-byte (<1>) and 4-byte (<0>) copies, and
    # B2's fp32 kernel, 16-byte (<1>) and per-channel (<0>) corners: no spills
    f32_kernels = [f"{k}<{vec}>" for k in F32_LOOP_KERNELS + (B2_F32_KERNEL,) for vec in (1, 0)]
    for kname in f32_kernels:
        r = resources[kname]
        require(r["spill_stores"] == 0 and r["spill_loads"] == 0, f"{kname} spills: {r}")

    log("phase 2: kernels vs plain versions")
    gen = torch.Generator(device="cuda").manual_seed(0)
    occ360, occ720, occ_o = clip_occupancy(360, 640), clip_occupancy(720, 1280), ring_occupancy()
    occ_s, occ_h = stream_occupancy(PATH_S), stream_occupancy(PATH_H)
    t_win_s, t_sel_s, _ = stream_window(PATH_S[0])
    t_win_h, t_sel_h, _ = stream_window(PATH_H[0])
    t_win_c, t_sel_c, _ = stream_window(PATH_C[0])
    b_c, occ_c = group_occupancy(PATH_C)
    log(f"  window occupancy of the node runs: 640x360 {int(occ360.sum())}/{occ360.numel()}, "
        f"1280x720 {int(occ720.sum())}/{occ720.numel()}, path O's ring on 768x360 {int(occ_o.sum())}/{occ_o.numel()}, "
        f"path S's middle window {int(occ_s.sum())}/{occ_s.numel()} ({t_win_s} frames, t_sel {t_sel_s}), "
        f"path H's {int(occ_h.sum())}/{occ_h.numel()} ({t_win_h} frames, t_sel {t_sel_h}), "
        f"path C's middle group of {b_c} windows {int(occ_c.sum())}/{occ_c.numel()} ({t_win_c} frames, t_sel {t_sel_c})")
    res = {}
    for dt in (torch.float32, torch.bfloat16):
        key = str(dt)[6:]
        res[("B1", key)] = check_corr_lookup(dt, gen)
        torch.cuda.empty_cache()
        if dt == torch.bfloat16:  # fp32 maps: both blends are the fp32 kernel
            res[("B1map", key)] = check_corr_lookup(dt, gen, "map")
            res[("B1_720", key)] = check_corr_lookup(dt, gen, "lanes", PATH_A_RAFT_CALL)
            res[("B1map_720", key)] = check_corr_lookup(dt, gen, "map", PATH_A_RAFT_CALL)
            res[("B1map_S", key)] = check_corr_lookup(dt, gen, "map", PATH_S_RAFT_CALL)
            torch.cuda.empty_cache()
            res[("B1map_H", key)] = check_corr_lookup(dt, gen, "map", PATH_H_RAFT_CALL)
            torch.cuda.empty_cache()
            for i, tag in ((0, "B4eH"), (1, "B4oH")):  # bf16 only: the fp32 library call would not fit
                res[(tag, key)] = check_window_attention_tiled(dt, gen, t_sel_h[i], occ_h, 1, t_win_h, 324, 880)
                torch.cuda.empty_cache()
            log(f"  B1 map / lanes blend: {res[('B1map', key)]['ms'] / res[('B1', key)]['ms']:.3f} at M 165600, "
                f"{res[('B1map_720', key)]['ms'] / res[('B1_720', key)]['ms']:.3f} at path A's call")
            torch.cuda.empty_cache()
        res[("B1_O", key)] = check_corr_lookup(dt, gen, "lanes", PATH_O_RAFT_CALL)
        torch.cuda.empty_cache()
        for tag, shape in B2_SHAPES.items():
            if dt == torch.bfloat16 or tag in B2_FP32:
                res[("B2" + tag, key)] = check_deform_conv(dt, gen, shape)
        for tag, (shape, rows) in B2_ROWS.items():
            res[("B2" + tag, key)] = check_deform_conv(dt, gen, shape, rows)
        torch.cuda.empty_cache()
        res[("B3e", key)] = check_window_attention(dt, gen, 7, occ360)
        res[("B3o", key)] = check_window_attention(dt, gen, 6, occ360)
        res[("B3eO", key)] = check_window_attention(dt, gen, 7, occ_o, 48, 126, "30x72")
        res[("B3oO", key)] = check_window_attention(dt, gen, 6, occ_o, 48, 126, "30x72")
        res[("B4e", key)] = check_window_attention_tiled(dt, gen, 7, occ720)
        res[("B4o", key)] = check_window_attention_tiled(dt, gen, 6, occ720)
        res[("B4eS", key)] = check_window_attention_tiled(dt, gen, t_sel_s[0], occ_s, 1, t_win_s)
        res[("B4oS", key)] = check_window_attention_tiled(dt, gen, t_sel_s[1], occ_s, 1, t_win_s)
        # path MH: each rank's 72 windows (6 of path A's 12 window rows) of
        # its 5 windows of 13 frames, with that rank's occupancy
        for r in range(2):
            occ_r = occ720.reshape(5, 12, 12)[:, 6 * r : 6 * r + 6].reshape(-1).contiguous()
            for tag, t_sel in (("B4eMH", 7), ("B4oMH", 6)):
                res[(f"{tag}{r}", key)] = check_window_attention_tiled(dt, gen, t_sel, occ_r, 5, 13, 72, 405)
        # paths C and M: B1 on path C's one 108-pair call (bf16 maps take the
        # map blend past the lanes gate, fp32 maps the fp32 kernel) and on path
        # M (1, 2)'s 12-pair calls (lanes); B4 on path C's middle window group
        res[("B1C", key)] = check_corr_lookup(dt, gen, "map", PATH_C_RAFT_CALL)
        torch.cuda.empty_cache()
        res[("B1M", key)] = check_corr_lookup(dt, gen, "lanes", PATH_M_RAFT_CALL)
        for i, tag in ((0, "B4eC"), (1, "B4oC")):
            res[(tag, key)] = check_window_attention_tiled(dt, gen, t_sel_c[i], occ_c, b_c, t_win_c, 36, 91)
            torch.cuda.empty_cache()
        res[("B5s", key)] = check_window_attention_halo(dt, gen, (30, 54), occ360)
        res[("B5l", key)] = check_window_attention_halo(dt, gen, (60, 108), occ720)
        cw = check_corr_window(dt, gen)
        res[("B6", key)], res[("B7", key)] = cw["B6"], cw["B7"]
        res[("PF", key)] = check_prop_fill(dt, gen)
        torch.cuda.empty_cache()
        if dt == torch.bfloat16:  # float32 maps keep the eager build
            res[("CP", key)] = check_corr_pyramid(gen)
            torch.cuda.empty_cache()
    grads = path_t_grad_checks(gen)
    torch.cuda.empty_cache()
    conv_gemm = check_conv_gemm(gen, table=False)
    torch.cuda.empty_cache()

    log("phase 3: ProPainterInpaint and ProPainterOutpaint, 24 frames, default widgets, random weights")
    # the JAX dispatcher's lookup gate: the lanes blend for the main path's
    # one RAFT call (w8 = 80, 723.5 MB a direction), the map-dtype blend for
    # path A's (w8 = 160)
    main_run, main_img, main_md = node_run(
        "main path 640x360", 360, 640, ("corr_lookup", "deform_conv", "window_attention", "prop_fill", "corr_pyramid"),
        ("corr_lookup_map", "window_attention_tiled", "window_attention_halo", "corr_window4", "corr_window",
         "conv_gemm"),
        profile_name="profile.txt",
    )
    path_a, _, _ = node_run(
        "path A 1280x720", 720, 1280,
        ("corr_lookup_map", "deform_conv", "window_attention_tiled", "prop_fill", "corr_pyramid"),
        ("corr_lookup", "window_attention_halo", "corr_window4", "corr_window", "conv_gemm"),
        profile_name="profile_720p.txt",
    )
    # at w8 = 160 the all-pairs volume passes RAFT_ALLPAIRS_BYTES: one call a chunk of 4 frames
    require(path_a["raft_forms"] == {"raft_form/chunks": 1}, f"path A: RAFT forms {path_a['raft_forms']}")
    path_b, b_img, _ = node_run(
        "path B 640x360 halo+pallas", 360, 640, ("deform_conv", "window_attention_halo", "corr_window4", "prop_fill"),
        ("corr_lookup", "corr_lookup_map", "window_attention", "window_attention_tiled", "corr_window", "conv_gemm",
         "corr_pyramid"),
        switched=True, profile_name="profile_switches.txt",
    )
    inside = main_md != 0
    delta = np.abs(b_img - main_img)[inside]
    path_b["vs_default_inside_mask"] = dict(mean=float(delta.mean()), max=float(delta.max()))
    log(f"  path B vs the main path inside the dilated mask: mean |d| {delta.mean():.6f}, max |d| {delta.max():.6f} "
        "(reported, not gated: B6's fractions are rounded to bf16)")
    # the outpaint canvas: RAFT's gate at both of its edges (w8 = 96, the
    # lanes' widest; 976.8 MB of the 1 GiB a direction) still takes the lanes
    path_o = outpaint_run(
        ("corr_lookup", "deform_conv", "window_attention", "prop_fill", "corr_pyramid"),
        ("corr_lookup_map", "window_attention_tiled", "window_attention_halo", "corr_window4", "corr_window",
         "conv_gemm"),
    )
    card_vs_host(False)
    card_vs_host(True)
    # path S: RAFT at w8 = 160 takes the map blend; one window of 19 frames
    # a transformer call, B4 by the size estimate
    path_s = path_s_run(
        ("corr_lookup_map", "deform_conv", "window_attention_tiled", "prop_fill", "corr_pyramid"),
        ("corr_lookup", "window_attention", "window_attention_halo", "corr_window4", "corr_window", "conv_gemm"),
    )
    # path H at 1920x1080: the forced forms first (also its warm-up); RAFT
    # (w8 = 240) takes the map blend, the windows B4
    forced = forced_forms()
    path_h = path_h_run(
        ("corr_lookup_map", "deform_conv", "window_attention_tiled", "prop_fill", "corr_pyramid"),
        ("corr_lookup", "window_attention", "window_attention_halo", "corr_window4", "corr_window", "conv_gemm"),
    )
    card_vs_host(False, outpaint=True)
    streaming = {fp16: stream_vs_memory(fp16) for fp16 in ("disable", "enable")}
    # paths C and M, 100 frames at 640x360: the clip-parallel RAFT call of
    # 108 pairs at w8 = 80 passes the lanes gate's 1 GiB (the map blend)
    with tempfile.TemporaryDirectory() as ref_dir:
        path_c = path_c_run(
            PATH_M_MESHES[(2, 1)],
            ("corr_lookup", "window_attention", "window_attention_halo", "corr_window4", "corr_window", "conv_gemm"),
            ref_dir,
        )
        path_m = path_m_run(ref_dir)
        # path MH: path A's clip on path M's ranks, mesh (1, 2), the feature stage H-split
        path_mh = path_mh_run(ref_dir)
        # path T: the training step, on the single card, then on mesh (1, 2)
        torch.cuda.empty_cache()
        path_t = path_t_run(ref_dir)
        path_t_ranks = path_t_ranks_run(ref_dir, path_t)
    paths = {"main": main_run, "path_a": path_a, "path_b": path_b, "path_o": path_o, "path_s": path_s, "path_h": path_h,
             "path_c": path_c, "path_m": path_m, "path_mh": path_mh, "path_t": path_t, "path_t_ranks": path_t_ranks}
    for path, expected in EARLIER_LAUNCHES.items():
        got = {k: v for k, v in paths[path]["launches"].items() if v}
        require(got == expected, f"{path}: launches {got}, expected {expected}")
    log(f"  the earlier paths' launches as expected: {EARLIER_LAUNCHES}")

    log(f"phase 4: report ({time.perf_counter() - t_start:.1f} s since the build began)")
    smi = nvidia_smi()
    log(smi)
    pkg = "comfyui_propainter_nodes_tpu_torch"
    pallas = "comfyui_propainter_nodes_tpu/ops/pallas"
    # the wrapped kernels' gradients at path T's shapes (fp32)
    grad_rows = {"deform_conv": "B2", "window_attention": "B3", "window_attention_tiled": "B4",
                 "window_attention_halo": "B5"}
    rows = [  # name, source, replaces, result key, path whose run counts its launches
        ("corr_lookup", "corr_lookup.cu", "corr_lanes.py:55", "B1", main_run),
        ("corr_lookup_map", "corr_lookup.cu", "corr_lanes.py:55", "B1map", path_a),
        ("deform_conv", "deform_conv.cu", "deform_conv.py:52", "B2fp", main_run),
        ("window_attention", "window_attention.cu", "window_attention.py:52", "B3e", main_run),
        ("window_attention_tiled", "window_attention_tiled.cu", "window_attention.py:176", "B4e", path_a),
        ("window_attention_halo", "window_attention_halo.cu", "window_attention_halo.py:69", "B5s", path_b),
        ("corr_window4", "corr_window.cu", "corr_lookup.py:91", "B6", path_b),
        ("corr_window", "corr_window.cu", "corr_lookup.py:42", "B7", main_run),
    ]
    # each kernel's fp32 kernel, its source and the phase-2 shapes of its fp32 numbers
    loop = f"{pkg}/csrc/flash_f32.cuh"
    f32_rows = {"window_attention": (F32_LOOP_KERNELS[0], loop, ("B3e", "B3o", "B3eO", "B3oO")),
                "window_attention_tiled": (F32_LOOP_KERNELS[1], loop, ("B4e", "B4o", "B4eS", "B4oS", "B4eC", "B4oC",
                                                                       "B4eMH0", "B4oMH0", "B4eMH1", "B4oMH1")),
                "window_attention_halo": (F32_LOOP_KERNELS[2], loop, ("B5s", "B5l")),
                "deform_conv": (B2_F32_KERNEL, f"{pkg}/csrc/deform_conv.cu",
                                tuple("B2" + t for t in B2_FP32 + tuple(B2_ROWS)))}
    kernels = []
    for name_k, src, repl, rk, run in rows:
        r = res[(rk, "bfloat16")]
        f32 = res.get((rk, "float32"))  # None for the map blend: fp32 maps take the fp32 kernel of B1
        row = {
            "name": name_k, "route": "cuda", "source": f"{pkg}/csrc/{src}", "replaces": f"{pallas}/{repl}",
            "launches": run["launches"][name_k], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"], "dtype": "bf16",
            "max_abs_err_fp32": f32 and f32["max_abs_err"], "ms_fp32": f32 and f32["ms"],
            "launches_by_path": {p: v["launches"][name_k] for p, v in paths.items()},
        }
        if name_k in grad_rows:  # fp32, path T's shapes: the Function's forward and backward, SDPA's
            row["path_t_gradients"] = grads[grad_rows[name_k]]
        if name_k in f32_rows:  # the fp32 kernels: their registers and spills and their numbers at fp32 shapes
            kn, src32, shapes = f32_rows[name_k]
            row["fp32"] = dict(
                source=src32,
                kernels={f"{kn}<{vec}>": subset(resources[f"{kn}<{vec}>"], ("registers", "spill_stores", "spill_loads"))
                         for vec in (1, 0)},
                **{tag: dict(subset(res[(tag, "float32")], KEEP),
                             **{k: v for k, v in res[(tag, "float32")].items() if k in ("ms_by_tap_split", "tap_split")})
                   for tag in shapes})
        if rk.startswith("B1"):
            row["blend"] = r["blend"]
            row["ms_path_a_call"] = res[({"B1": "B1_720", "B1map": "B1map_720"}[rk], "bfloat16")]["ms"]
        if rk == "B1map":
            row["ms_path_s_call"] = res[("B1map_S", "bfloat16")]["ms"]
            h_ = res[("B1map_H", "bfloat16")]
            row["path_h_call"] = {k: h_[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        if rk == "B1":
            row["ms_path_o_call"] = res[("B1_O", "bfloat16")]["ms"]
            # fp32 maps take this kernel on path C's call; path M (1, 2) runs it on 12 pairs
            row["path_c_shapes"] = dict(call=PATH_C_RAFT_CALL, dtype="fp32", **subset(res[("B1C", "float32")], KEEP))
            row["path_m_shapes"] = dict(call=PATH_M_RAFT_CALL, **subset(res[("B1M", "bfloat16")], KEEP),
                                        **fp32_of(res[("B1M", "float32")]))
        if rk == "B1map":
            row["path_c_shapes"] = dict(call=PATH_C_RAFT_CALL, **subset(res[("B1C", "bfloat16")], KEEP))
        if rk == "B4e":  # path S's window, the even layers' t_sel (the odd in chip_smoke.json)
            s_, s32 = res[("B4eS", "bfloat16")], res[("B4eS", "float32")]
            row["path_s_shapes"] = {k: s_[k] for k in ("b", "t", "t_sel", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                                        "bound_by", "library_ms", "b3_ms", "occupied_share")}
            row["path_s_shapes"].update(max_abs_err_fp32=s32["max_abs_err"], ms_fp32=s32["ms"])
            h_ = res[("B4eH", "bfloat16")]
            row["path_h_shapes"] = {k: h_[k] for k in ("b", "t", "t_sel", "n_win", "max_abs_err", "ms", "plain_ms",
                                                        "bound_ms", "bound_by", "library_ms", "b3_ms", "occupied_share")}
            # path C's middle window group, the even layers' t_sel (the odd in chip_smoke.json)
            row["path_c_shapes"] = dict(subset(res[("B4eC", "bfloat16")], KEEP + ("b", "t", "t_sel", "n_win", "b3_ms",
                                                                                 "occupied_share")),
                                        **fp32_of(res[("B4eC", "float32")]))
            # path MH's ranks, the even layers' t_sel (the odd in chip_smoke.json)
            row["path_mh_shapes"] = {
                f"rank {r}": dict(subset(res[(f"B4eMH{r}", "bfloat16")], KEEP + ("b", "t", "t_sel", "n_win", "b3_ms",
                                                                              "occupied_share")),
                                  **fp32_of(res[(f"B4eMH{r}", "float32")]))
                for r in range(2)
            }
        if rk == "B3e":  # path O's shapes, t_sel 7 (B3 at t_sel 6 in chip_smoke.json)
            o, o32 = res[("B3eO", "bfloat16")], res[("B3eO", "float32")]
            row["path_o_shapes"] = {k: o[k] for k in ("grid", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                                       "bound_by", "library_ms", "occupied_share")}
            row["path_o_shapes"].update(max_abs_err_fp32=o32["max_abs_err"], ms_fp32=o32["ms"])
        if rk == "B1map":
            row["computes"] = "the JAX package's lookup_corr in bf16 (models/raft.py:249-349), taken past the lanes gate"
        if "b3_ms" in r:
            row["b3_ms_same_inputs"] = r["b3_ms"]
        if rk == "B2fp":
            row["ms_by_shape"] = {tag: res[("B2" + tag, "bfloat16")]["ms"] for tag in B2_SHAPES}
            row["launches_by_shape"] = {p: v.get("b2_launches_by_shape") for p, v in paths.items()}
            row["path_c_shapes"] = {"x".join(map(str, B2_SHAPES[tag])): dict(subset(res[("B2" + tag, "bfloat16")], KEEP),
                                                                             **fp32_of(res[("B2" + tag, "float32")]))
                                    for tag in ("fcC", "fpC", "fpC4")}
            # the row form at path MH's per-rank shapes
            row["path_mh_shapes"] = {
                "x".join(map(str, shape)) + f" rows {r0}-{r0 + ho}": dict(
                    subset(res[("B2" + tag, "bfloat16")], KEEP), **fp32_of(res[("B2" + tag, "float32")]))
                for tag, (shape, (r0, ho)) in B2_ROWS.items()
            }
        kernels.append(row)
    pf_, pf32 = res[("PF", "bfloat16")], res[("PF", "float32")]
    kernels.append({  # replaces no TPU kernel: the eager step (the JAX package leaves it to XLA)
        "name": "prop_fill", "route": "cuda", "source": f"{pkg}/csrc/prop_fill.cu", "replaces": None,
        "launches": path_o["launches"]["prop_fill"], "clip": pf_["path_o"]["clip"], "dtype": "bf16",
        **subset(pf_["path_o"], KEEP + ("ms_single", "direction_ms", "plain_direction_ms")),
        **fp32_of(pf32["path_o"]),
        **{f"{tag}_shapes": dict(subset(pf_[tag], ("clip", "first_index", "interpolation", "max_abs_err")),
                                 max_abs_err_fp32=pf32[tag]["max_abs_err"])
           for tag in PROP_FILL_CLIPS if tag != "path_o"},
        "launches_by_path": {p: v["launches"]["prop_fill"] for p, v in paths.items()},
    })
    cp_ = res[("CP", "bfloat16")]
    kernels.append({  # replaces no TPU kernel: the eager build (the JAX package leaves it to XLA)
        "name": "corr_pyramid", "route": "cuda", "source": f"{pkg}/csrc/corr_pyramid.cu", "replaces": None,
        "launches": main_run["launches"]["corr_pyramid"], "dtype": "bf16", "call": cp_["main"]["call"],
        **subset(cp_["main"], KEEP),
        **{f"{tag}_call": subset(cp_[tag], ("call",) + KEEP) for tag in CORR_PYRAMID_CALLS if tag != "main"},
        "launches_by_path": {p: v["launches"]["corr_pyramid"] for p, v in paths.items()},
    })
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"conv_gemm": conv_gemm}))
    detail = {f"{k}_{d}": v for (k, d), v in res.items()}
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"device": name, "nvidia_smi": smi, "kernels": detail, "resources": resources,
                   "streaming_vs_in_memory": streaming, "forced_forms_1080p": forced,
                   "gradients_path_t": grads, "conv_gemm": conv_gemm, "node": paths}, f, indent=1)
    weights_dir.cleanup()
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
