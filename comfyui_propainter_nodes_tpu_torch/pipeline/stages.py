"""Pipeline stages: flow -> completion -> image prop -> feature prop.

Port of the JAX package's `pipeline/stages.py`, as eager PyTorch on one
device or on the ranks of a mesh. Chunk boundaries follow the reference
inference script (propainter_inference.py): flow-completion subvideo
chunks with a 5-frame halo, image-propagation chunks of <= 100 frames
with a 10-frame halo, sliding neighbor windows with global reference
frames and the first-visit / 0.5-blend overlap merge. The chunk loops
are plain Python loops over unpadded chunks (exactly what the JAX
package's padded, masked chunks compute for their real frames). RAFT's
clip chunking only bounds memory, so all pairs run in one call when the
correlation volumes fit. The feature stage encodes every frame once and
gathers windows from the per-frame features, in groups of
`_window_group_size` windows.

Clip parallelism (the JAX stage's mesh branches, `Pipeline(mesh=)`, or
PROPAINTER_TPU_CLIP_PARALLEL=1 on one card): stages 1-3 pad their chunks
to one length, batch them on a chunk axis with their real lengths and
split it over the data ranks (`Pipeline._chunk_mapped`); the windows of
each group split the same way; the model ranks split the transformer's
T below 512 rows (`parallel/sequence.py`), the frames' rows from 512
(`parallel/spatial.py`). Every rank returns the whole video.

With a crop (the node's mask bounding box, `nodes.py::_mask_crop_plan`)
the feature stage decodes, composites and blends only that window: the
composed video equals the input outside the dilated mask, and
`decoder_crop` is exact.

`process` times each stage with `utils/profiling.stage_timer` (one
registry for the whole package) and every stage reports its progress
through `Pipeline.progress`. The chunk methods `complete_flow_chunk`,
`image_prop_chunk` and `feature_window` are the units the long-video
path (`pipeline/streaming.py`) runs; the in-memory loops call the same
first two.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from ..config import PipelineConfig
from ..models import flow_completion as fc
from ..models import propainter as pp
from ..models import raft
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS
from ..parallel.sequence import sequence_sharding
from ..parallel.spatial import Partition, spatial_sharding, token_rows
from ..utils.params import to_device
from ..utils.profiling import count, progress_report, stage_timer

RAFT_ALLPAIRS_BYTES = 4.5e9  # all-pairs volume budget for one RAFT call
# what one RAFT call may hold in its correlation volume (`raft.call_bytes`):
# above it RAFT runs a pair a call, then a pair a call with the directions
# in turn. A chunk of 2 pairs at 1920x1080 holds 11.7 GiB in bf16, so every
# path up to 1080p keeps its chunks on an 80 GB card
RAFT_CALL_BYTES = 24 << 30


def get_ref_index(mid_neighbor_id, neighbor_ids, video_length, ref_stride, ref_num):
    """Global reference frame selection (propainter_inference.py:36-58)."""
    ref_index = []
    if ref_num == -1:
        for i in range(0, video_length, ref_stride):
            if i not in neighbor_ids:
                ref_index.append(i)
    else:
        start_idx = max(0, mid_neighbor_id - ref_stride * (ref_num // 2))
        end_idx = min(video_length, mid_neighbor_id + ref_stride * (ref_num // 2))
        for i in range(start_idx, end_idx, ref_stride):
            if i not in neighbor_ids:
                if len(ref_index) > ref_num:
                    break
                ref_index.append(i)
    return ref_index


def crop_decode_ok(hw: tuple[int, int], crop) -> bool:
    """Whether the feature stage decodes only the crop (the JAX node's
    gate, stages.py:1646-1653, where the crop decoder's fixed-size halo
    block must fit inside the frame; the port's block is clamped to the
    frame, and it keeps the gate to decode what the JAX node decodes);
    PROPAINTER_TPU_CROP_DECODE=0 (read at call time) turns it off, and
    the full frames are decoded and then cropped."""
    halo = 8 * pp.DECODER_HALO4  # full-res rows of halo, both sides
    return (
        os.environ.get("PROPAINTER_TPU_CROP_DECODE", "1") == "1"
        and crop[2] + halo <= hw[0]
        and crop[3] + halo <= hw[1]
    )


@contextlib.contextmanager
def full_fp32():
    """TF32 off for cuDNN convs and matmuls inside the block (cuDNN convs
    default to TF32), both flags restored after it, also when it raises."""
    old = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


def flow_chunk_plan(cfg: PipelineConfig, t: int) -> list[tuple[int, int]]:
    """RAFT clip bounds with 1-frame overlap (propainter_inference.py:75-93)."""
    clip = cfg.raft_chunk_len()
    return [(c if c == 0 else c - 1, min(t, c + clip)) for c in range(0, t, clip)]


def jax_flow_lookup(cfg: PipelineConfig, t: int, hw: tuple[int, int], clip_dp: int | None = None) -> str:
    """The lookup the JAX stage plan takes for one `compute_flow` call of
    t frames at hw = (H, W) (`Pipeline._flow_fn`, stages.py:355-515
    there), with the variables it reads and their defaults, read at call
    time. Its RAFT calls hold n pairs:
      one call        one chunk: n = t - 1;
      clip-parallel   clip_dp (the data ranks) given, more than one chunk:
                      the chunks padded to clip + 1 frames and split over
                      the ranks, n = ceil(n_chunks / clip_dp) clip
                      (`Pipeline._clip_parallel`, stages.py:372-423 there);
      one call        the all-pairs volume 2 (t-1) h8w8^2 esz 1.36 within
                      PROPAINTER_TPU_RAFT_ALLPAIRS_BYTES (4.5e9): n = t - 1;
      chunk by chunk  the chunks' total over that budget, one chunk within
                      it: n = clip (JAX pads the first chunk to clip + 1);
      pair by pair    one chunk over it: n = 1, and past
                      PROPAINTER_TPU_RAFT_SEQDIR_BYTES (2e9) for one pair's
                      volume the directions in turn, whose `raft_forward`
                      never takes the lanes lookup;
      chunks batched  otherwise: n = n_chunks clip.
    The lookup of n pairs is `raft.lookup_mode`'s."""
    bounds = flow_chunk_plan(cfg, t)
    clip = cfg.raft_chunk_len()
    h8, w8 = hw[0] // 8, hw[1] // 8
    dtype = torch.bfloat16 if cfg.raft_half else torch.float32

    def volume(pairs):
        return 2 * pairs * (h8 * w8) ** 2 * dtype.itemsize * 1.36

    budget = float(os.environ.get("PROPAINTER_TPU_RAFT_ALLPAIRS_BYTES", 4.5e9))
    if len(bounds) > 1 and clip_dp is not None:
        n = -(-len(bounds) // clip_dp) * clip
    elif len(bounds) == 1 or volume(t - 1) <= budget:
        n = t - 1
    elif volume(clip) * len(bounds) > budget and volume(clip) <= budget:
        n = clip
    elif volume(clip) * len(bounds) > budget:
        if volume(1) > float(os.environ.get("PROPAINTER_TPU_RAFT_SEQDIR_BYTES", 2e9)):
            return raft.forward_lookup_mode()
        n = 1
    else:
        n = len(bounds) * clip
    return raft.lookup_mode(n, h8, w8, dtype)


def raft_form(cfg: PipelineConfig, t: int, hw: tuple[int, int], clip_dp: int | None = None) -> str:
    """How `Pipeline.compute_flow` runs RAFT on t frames at hw:
      "one call"       one chunk, or the all-pairs volume within
                       RAFT_ALLPAIRS_BYTES (the JAX stage's rule);
      "clip-parallel"  clip_dp given (the data ranks of a clip-parallel
                       pipeline) and more than one chunk: the chunks
                       padded to clip + 1 frames, each data rank's share
                       in one call;
      "chunks"         otherwise, one call a chunk of `flow_chunk_plan`
                       (in the clip-parallel form, a chunk of the share);
    and where the largest of those calls would hold more than
    RAFT_CALL_BYTES (`raft.call_bytes`, counted in the port's own
    tensors), one pair a call ("per pair"), or past that for one pair,
    one pair a call with the directions in turn ("per pair, directions
    in turn"). Each pair's flow is the same in every form: pairs and
    directions are independent. On an 80 GB card the last two engage
    only above 1920x1080."""
    bounds = flow_chunk_plan(cfg, t)
    h8, w8 = hw[0] // 8, hw[1] // 8
    esz = 2 if cfg.raft_half else 4
    mode = jax_flow_lookup(cfg, t, hw, clip_dp)
    clip = cfg.raft_chunk_len()
    if len(bounds) > 1 and clip_dp is not None:
        form, n = "clip-parallel", -(-len(bounds) // clip_dp) * clip
        if raft.call_bytes(n, h8, w8, esz, mode) > RAFT_CALL_BYTES:
            form, n = "chunks", clip
    elif len(bounds) == 1 or 2 * (t - 1) * (h8 * w8) ** 2 * esz * 1.36 <= RAFT_ALLPAIRS_BYTES:
        form, n = "one call", t - 1
    else:
        form, n = "chunks", max(e - s - 1 for s, e in bounds)
    if raft.call_bytes(n, h8, w8, esz, mode) <= RAFT_CALL_BYTES:
        return form
    if raft.call_bytes(1, h8, w8, esz, mode) <= RAFT_CALL_BYTES:
        return "per pair"
    return "per pair, directions in turn"


def complete_chunk_plan(cfg: PipelineConfig, flow_length: int):
    """(start, end, lead_halo, tail_halo) per subvideo chunk
    (propainter_inference.py:115-144)."""
    sub = cfg.subvideo_length
    pad_len = 5
    bounds = []
    for f in range(0, flow_length, sub):
        s_f = max(0, f - pad_len)
        e_f = min(flow_length, f + sub + pad_len)
        bounds.append((s_f, e_f, f - s_f, e_f - min(flow_length, f + sub)))
    return bounds


def imgprop_chunk_plan(cfg: PipelineConfig, t: int):
    """<=100-frame chunks with 10-frame halo (propainter_inference.py:172-212)."""
    sub = min(100, cfg.subvideo_length)
    pad_len = 10
    bounds = []
    for f in range(0, t, sub):
        s_f = max(0, f - pad_len)
        e_f = min(t, f + sub + pad_len)
        bounds.append((s_f, e_f, f - s_f, e_f - min(t, f + sub)))
    return bounds


def window_plan(cfg: PipelineConfig, t: int):
    """Sliding windows + global refs (propainter_inference.py:254-261)."""
    ns = cfg.neighbor_stride
    ref_num = cfg.subvideo_length // cfg.ref_stride if t > cfg.subvideo_length else -1
    windows = []
    for f in range(0, t, ns):
        neighbor_ids = list(range(max(0, f - ns), min(t, f + ns + 1)))
        windows.append((neighbor_ids, get_ref_index(f, neighbor_ids, t, cfg.ref_stride, ref_num)))
    return windows


def _window_tables(cfg: PipelineConfig, t: int):
    """Per-window frame selections (local + refs padded to static
    buckets), validity, start frames, local/ref counts and the blend
    slot-validity map."""
    windows = window_plan(cfg, t)
    n_windows = len(windows)
    l_t_max = 2 * cfg.neighbor_stride + 1
    ref_max = max((len(r) for _, r in windows), default=0)
    ref_max = max(2, -(-ref_max // 2) * 2)
    t_sel = l_t_max + ref_max
    sels = np.zeros((n_windows, t_sel), np.int64)
    valids = np.zeros((n_windows, t_sel), np.float32)
    starts = np.zeros((n_windows,), np.int64)
    lts = np.zeros((n_windows,), np.int64)
    refs = np.zeros((n_windows,), np.int64)
    slot_valid = np.zeros((n_windows, l_t_max), np.bool_)
    for wi, (nids, rids) in enumerate(windows):
        l_t, n_ref = len(nids), len(rids)
        sels[wi] = np.asarray(nids + [0] * (l_t_max - l_t) + rids + [0] * (ref_max - n_ref))
        valids[wi, :l_t] = 1.0
        valids[wi, l_t_max : l_t_max + n_ref] = 1.0
        starts[wi] = nids[0]
        lts[wi] = l_t
        refs[wi] = n_ref
        slot_valid[wi, :l_t] = True
    return sels, valids, starts, lts, refs, slot_valid, l_t_max, ref_max


def _blend_windows(imgs, starts, slot_valid, t: int, l_t_max: int):
    """Overlap blend in the reference's visit order: first visit replaces,
    a revisit gives floor(0.5*new + 0.5*old). imgs [nW, l_t_max, H, W, 3]
    float 0..255 -> [T, H, W, 3]."""
    h, w = imgs.shape[2], imgs.shape[3]
    canvas = imgs.new_zeros((t + l_t_max, h, w, 3))
    seen = torch.zeros(t + l_t_max, dtype=torch.bool, device=imgs.device)
    for wi in range(imgs.shape[0]):
        s0 = int(starts[wi])
        sv = torch.as_tensor(slot_valid[wi], device=imgs.device)
        cur = canvas[s0 : s0 + l_t_max]
        sn = seen[s0 : s0 + l_t_max]
        blended = torch.where(sn[:, None, None, None], torch.floor(0.5 * imgs[wi] + 0.5 * cur), imgs[wi])
        canvas[s0 : s0 + l_t_max] = torch.where(sv[:, None, None, None], blended, cur)
        seen[s0 : s0 + l_t_max] = sn | sv
    return canvas[:t]


def _window_group_size(n_windows: int, dp: int) -> int:
    """Windows a batched transformer forward: all of them up to
    PROPAINTER_TPU_WINDOW_BATCH (read at call time; 8: the transformer
    holds about 0.4 GB of K/V a window at 640x360), rounded up to a
    multiple of the data ranks (the JAX stage's rule, stages.py:222-231)."""
    env = os.environ.get("PROPAINTER_TPU_WINDOW_BATCH")
    g = min(n_windows, int(env) if env else 8)
    return -(-g // dp) * dp


def _pad_t(a, n: int):
    """[B, T, ...] zero-padded at the end of T to n frames."""
    return torch.cat([a, a.new_zeros((a.shape[0], n - a.shape[1]) + a.shape[2:])], dim=1)


def _form_calls(form: str, t: int, chunks) -> list[tuple[int, int]]:
    """The frame ranges (start, end) of a `raft_form` form's RAFT calls
    over t frames: the chunks `chunks` ("chunks"), one a pair ("per
    pair", with or without the directions in turn), else one call."""
    if form == "chunks":
        return chunks
    if form.startswith("per pair"):
        return [(i, i + 2) for i in range(t - 1)]
    return [(0, t)]


def _stitch(parts, bounds):
    """Each chunk's outputs (a tuple [1, n, ...] a chunk) with its halos
    (bounds: (start, end, lead_halo, tail_halo)) cut, concatenated on T."""
    cut = [tuple(o[:, ps : e - s - pe] for o in outs) for outs, (s, e, ps, pe) in zip(parts, bounds)]
    return tuple(torch.cat(col, dim=1) for col in zip(*cut))


def _raft_calls(prm, frames, calls, form: str, iters: int, blend: str):
    """RAFT over the frame ranges `calls` ((start, end) of frames [1, T,
    ...], in order, covering every pair once) of a `raft_form` form: the
    pairs' flows (f, b) [1, T-1, H, W, 2] fp32."""
    fn = raft.raft_bi_forward_seqdir if form == "per pair, directions in turn" else raft.raft_bi_forward
    ff, fb = zip(*(fn(prm, frames[:, s:e], iters, blend) for s, e in calls))
    return (ff[0], fb[0]) if len(calls) == 1 else (torch.cat(ff, dim=1), torch.cat(fb, dim=1))


class Pipeline:
    """End-to-end video inpainting on one device, or on the ranks of a mesh.

    Params are upstream-layout CPU tensors; they are cast (bf16 under
    fp16="enable", RAFT per `config.raft_half`) and moved once. On the
    card `process` runs with TF32 off for cuDNN convs and matmuls
    (`full_fp32`), so the fp32 paths compute in full fp32; the process's
    own TF32 flags are back as they were after each run.

    mesh (`parallel/mesh.py::make_mesh`, every rank builds its Pipeline
    with its own): the data ranks split the chunk loops of stages 1-3
    (clip parallelism: on with more than one data rank, or under
    PROPAINTER_TPU_CLIP_PARALLEL=1 with no mesh, as one batched call) and
    each window group of stage 4; the model ranks split the transformer's
    T (sequence parallelism, below 512 rows or under PROPAINTER_TPU_SEQ=1)
    or the frames' rows (the spatial H split, from 512 rows).
    Every rank returns the whole video. The device is the mesh's."""

    def __init__(self, raft_params, flow_params, inpaint_params, config: PipelineConfig, device=None, mesh=None):
        self.config = config
        self.mesh = mesh
        if mesh is not None and device is not None and torch.device(device) != mesh.device:
            raise ValueError(f"Pipeline: device {device} is not the mesh's {mesh.device}")
        self.device = mesh.device if mesh is not None else torch.device(device or "cuda")
        rdt = torch.bfloat16 if config.raft_half else torch.float32
        self.cdtype = torch.bfloat16 if config.use_bf16 else torch.float32
        self.raft_params = to_device(raft_params, self.device, rdt)
        self.flow_params = to_device(flow_params, self.device, self.cdtype)
        self.inpaint_params = to_device(inpaint_params, self.device, self.cdtype)
        # progress callback: fn(stage_name, done_units, total_units)
        self.progress = None

    def _report(self, stage: str, done: int, total: int) -> None:
        progress_report(self.progress, stage, done, total)

    # --------------------------------------------------- mesh plumbing

    def _clip_parallel(self) -> bool:
        """Whether stages 1-3 batch their chunk loops on a chunk axis split
        over the data ranks: PROPAINTER_TPU_CLIP_PARALLEL=1 / 0 (read at
        call time) forces it (with no mesh, one batched call: fewer calls,
        more memory); by default on with more than one data rank."""
        env = os.environ.get("PROPAINTER_TPU_CLIP_PARALLEL")
        if env is not None:
            return env == "1"
        return self._dp() > 1

    def _dp(self) -> int:
        return 1 if self.mesh is None else self.mesh.shape[DATA_AXIS]

    def _mp(self) -> int:
        return 1 if self.mesh is None else self.mesh.shape[MODEL_AXIS]

    def _seq_selected(self, h: int) -> bool:
        """How the feature stage uses more than one model rank: sequence
        parallelism (`parallel/sequence.py`) below 512 rows, where an H
        split would leave too few token rows a rank, else the spatial H
        split (`parallel/spatial.py`), the JAX package's rule.
        PROPAINTER_TPU_SEQ=1 / 0 (read at call time) forces the choice."""
        if self._mp() <= 1:
            return False
        env = os.environ.get("PROPAINTER_TPU_SEQ")
        if env is not None:
            return env == "1"
        return h < 512

    def _chunk_mapped(self, fn):
        """fn(*arrays) -> tuple of tensors, run by each data rank on its
        contiguous share of the arrays' leading (chunk) axis, whose length
        is a multiple of the data ranks; the outputs are all-gathered over
        the data axis, so every rank holds them all. Chunks are
        independent: nothing else crosses ranks. With one data rank, fn."""
        dp = self._dp()
        if dp <= 1:
            return fn
        mesh = self.mesh
        i = mesh.index(DATA_AXIS)

        def mapped(*arrays):
            share = arrays[0].shape[0] // dp
            outs = fn(*(a[i * share : (i + 1) * share] for a in arrays))
            return tuple(mesh.all_gather(o, DATA_AXIS) for o in outs)

        return mapped

    @staticmethod
    def _pad_chunk_axis(arrays: tuple, dp: int) -> tuple:
        """The leading (chunk) axis padded to a multiple of dp by repeating
        the last chunk."""
        n_pad = (-arrays[0].shape[0]) % dp
        if not n_pad:
            return arrays
        return tuple(torch.cat([a, a[-1:].expand((n_pad,) + a.shape[1:])]) for a in arrays)

    def _clip_dp(self) -> int | None:
        """The data ranks a clip-parallel stage splits its chunks over, or
        None where the stages run their chunks in turn."""
        return self._dp() if self._clip_parallel() else None

    def _batched_chunks(self, fn, take, sizes, bounds) -> list:
        """fn over the chunks `bounds` ((start, end, ...)) batched on a
        chunk axis (the JAX stage's clip-parallel stages 2 and 3): take(s,
        e) gives a chunk's arrays [1, n, ...], each zero-padded at the end
        of T to its entry of `sizes`; fn gets them with the real lengths e -
        s (a [n_chunks] tensor on the device) as its last argument, the
        chunk axis split over the data ranks. Returns each chunk's
        outputs, a tuple of [1, ...]."""
        cols = zip(*(take(s, e) for s, e, _, _ in bounds))
        batch = tuple(torch.cat([_pad_t(a, n) for a in col]) for col, n in zip(cols, sizes))
        lengths = torch.tensor([e - s for s, e, _, _ in bounds], device=self.device)
        outs = self._chunk_mapped(fn)(*self._pad_chunk_axis(batch + (lengths,), self._dp()))
        return [tuple(o[ci : ci + 1] for o in outs) for ci in range(len(bounds))]

    # ------------------------------------------------------------- stage 1

    def compute_flow(self, frames):
        """Bidirectional RAFT flow. frames [1, T, H, W, 3] fp32 in [-1, 1]
        -> (flows_f, flows_b) [1, T-1, H, W, 2] fp32, in the form
        `raft_form` picks, counted as `raft_form/<form>` (one a call);
        every call takes the blend of the JAX stage plan for this clip
        (`jax_flow_lookup`)."""
        cfg = self.config
        t, hw = frames.shape[1], (frames.shape[2], frames.shape[3])
        clip_dp = self._clip_dp()
        bounds = flow_chunk_plan(cfg, t)
        form = raft_form(cfg, t, hw, clip_dp)
        count(f"raft_form/{form}")
        blend = jax_flow_lookup(cfg, t, hw, clip_dp)
        self._report("compute_flow", 0, 1)
        if clip_dp is not None and len(bounds) > 1:
            out = self._flow_clip_parallel(frames, bounds, form, blend)
        else:
            out = _raft_calls(self.raft_params, frames, _form_calls(form, t, bounds), form, cfg.raft_iter, blend)
        self._report("compute_flow", 1, 1)
        return out

    def _flow_clip_parallel(self, frames, bounds, form: str, blend: str):
        """RAFT's clip-parallel form (the JAX stage's, stages.py:372-423):
        the chunks padded to clip + 1 frames by repeating their last frame,
        batched on a chunk axis, each data rank's share in the calls of
        `form`, the flows gathered and the padding's dropped."""
        cfg = self.config
        n1 = cfg.raft_chunk_len() + 1
        chunks = []
        for s, e in bounds:
            ck = frames[0, s:e]
            chunks.append(torch.cat([ck, ck[-1:].expand((n1 - (e - s),) + ck.shape[1:])]))
        (batch,) = self._pad_chunk_axis((torch.stack(chunks),), self._dp())

        def share(b):
            if form == "clip-parallel":
                return raft.raft_bi_forward(self.raft_params, b, cfg.raft_iter, blend)
            calls = _form_calls(form, n1, [(0, n1)])  # a chunk of the share a call
            flows = [_raft_calls(self.raft_params, b[j : j + 1], calls, form, cfg.raft_iter, blend) for j in range(len(b))]
            return torch.cat([f for f, _ in flows]), torch.cat([f for _, f in flows])

        ff, fb = self._chunk_mapped(share)(batch)
        return (
            torch.cat([ff[ci : ci + 1, : e - s - 1] for ci, (s, e) in enumerate(bounds)], dim=1),
            torch.cat([fb[ci : ci + 1, : e - s - 1] for ci, (s, e) in enumerate(bounds)], dim=1),
        )

    # ------------------------------------------------------------- stage 2

    def complete_flow_chunk(self, ff, fb, mk, t_valid=None):
        """One flow-completion chunk: flows (ff, fb) [B, n, H, W, 2] and
        flow masks [B, n + 1, H, W, 1] -> the completed flows, in the
        compute dtype. Past its memory budget `forward_bidirect_flow`
        completes the directions in turn (the JAX stage's high-res form,
        stages.py:1428-1487 there): one direction's activations are live
        at a time. t_valid: the real flows of zero-padded chunks (an int
        or a [B] tensor)."""
        dt = self.cdtype
        ff, fb, mk = ff.to(dt), fb.to(dt), mk.to(dt)
        pf, pb = fc.forward_bidirect_flow(self.flow_params, ff, fb, mk, t_valid)
        return fc.combine_flow(ff, fb, pf, pb, mk)

    def complete_flow(self, flows, flow_masks):
        """Flow completion over subvideo chunks with a 5-frame halo.
        flows (f, b) [1, T-1, H, W, 2]; flow_masks [1, T, H, W, 1]. The
        chunks run in turn, or clip-parallel: zero-padded to one length
        (subvideo_length + 10 flows) with their real lengths, batched and
        split over the data ranks (the JAX stage's, stages.py:572-620)."""
        ff, fb = flows
        self._report("complete_flow", 0, 1)
        flow_length = ff.shape[1]
        if flow_length <= self.config.subvideo_length:
            out = self.complete_flow_chunk(ff, fb, flow_masks)
        else:
            bounds = complete_chunk_plan(self.config, flow_length)

            def take(s, e):
                return ff[:, s:e], fb[:, s:e], flow_masks[:, s : e + 1]

            if self._clip_parallel() and len(bounds) > 1:
                n = self.config.subvideo_length + 10
                parts = self._batched_chunks(self.complete_flow_chunk, take, (n, n, n + 1), bounds)
            else:
                parts = [self.complete_flow_chunk(*take(s, e)) for s, e, _, _ in bounds]
            out = _stitch(parts, bounds)
        self._report("complete_flow", 1, 1)
        return out

    # ------------------------------------------------------------- stage 3

    def image_prop_chunk(self, fr, mk, ff, fb, t_valid=None):
        """One image-propagation chunk: frames [B, n, H, W, 3] in [-1, 1],
        dilated masks [B, n, H, W, 1], completed flows [B, n - 1, H, W, 2]
        -> (updated_frames, updated_masks) in the compute dtype. t_valid:
        the real frames of zero-padded chunks (an int or a [B] tensor)."""
        dt = self.cdtype
        fr, mk, ff, fb = fr.to(dt), mk.to(dt), ff.to(dt), fb.to(dt)
        masked = fr * (1 - mk)
        prop, upd_mask = pp.bidirectional_propagation_image(masked, ff, fb, mk, "nearest", t_valid)
        return fr * (1 - mk) + prop * mk, upd_mask

    def image_propagation(self, frames, masks_dilated, pred_flows):
        """Pixel-domain propagation in <=100-frame chunks with a 10-frame
        halo, in turn or clip-parallel (zero-padded to sub + 20 frames,
        the JAX stage's, stages.py:701-760). Returns (updated_frames,
        updated_masks) in the compute dtype."""
        ff, fb = pred_flows
        self._report("image_propagation", 0, 1)
        t = frames.shape[1]
        sub = min(100, self.config.subvideo_length)
        if t <= sub:
            out = self.image_prop_chunk(frames, masks_dilated, ff, fb)
        else:
            bounds = imgprop_chunk_plan(self.config, t)

            def take(s, e):
                return frames[:, s:e], masks_dilated[:, s:e], ff[:, s : e - 1], fb[:, s : e - 1]

            if self._clip_parallel() and len(bounds) > 1:
                n = sub + 20
                parts = self._batched_chunks(self.image_prop_chunk, take, (n, n, n - 1, n - 1), bounds)
            else:
                parts = [self.image_prop_chunk(*take(s, e)) for s, e, _, _ in bounds]
            out = _stitch(parts, bounds)
        self._report("image_propagation", 1, 1)
        return out

    # ------------------------------------------------------------- stage 4

    def feature_propagation(self, updated_frames, updated_masks, masks_dilated, pred_flows, original_frames, crop=None):
        """Sliding-window transformer inference, uint8 composite and overlap
        blend. original_frames [T, H, W, 3] float 0..255. Returns the
        composed video [T, H, W, 3] float 0..255 (uint8-exact); with crop =
        (y0, x0, ch, cw) only that window of it, [T, ch, cw, 3], decoded
        alone where `crop_decode_ok` allows.

        Windows run in groups of `_window_group_size`; with more than one
        data rank each rank runs its contiguous share of a group (padded
        by repeating its last window) and the composed windows are
        gathered (the JAX stage's, stages.py:945-963). With more than one
        model rank the transformer runs sequence-parallel, or, where
        `_seq_selected` is False, the window forward H-split
        (`parallel/spatial.py`): each model rank encodes, propagates,
        decodes, composes and blends its rows of the frames (of the
        crop), and the rows are gathered at the end."""
        dt = self.cdtype
        t, hh, ww = updated_frames.shape[1], updated_frames.shape[2], updated_frames.shape[3]
        tables = _window_tables(self.config, t)
        _, _, starts, _, _, slot_valid, l_t_max, _ = tables

        def pad_t(a):  # zero frames after the end: window slices stay in range
            return _pad_t(a, a.shape[1] + l_t_max)

        frames = tuple(pad_t(a.to(dt)) for a in (updated_frames, updated_masks, masks_dilated, *pred_flows))
        orig_p = pad_t(original_frames.float()[None])[0]
        # the rows this rank composes: all, or its own under the H split,
        # gathered at the end (`out_rows`)
        split = self._mp() > 1 and not self._seq_selected(hh)
        rows, out_rows = (0, hh), None
        if split:
            out_rows = Partition(self.mesh, MODEL_AXIS, token_rows(hh // 4)).pixels(hh)
            rows = (out_rows.lo, out_rows.hi)
        # the composite's inputs, cropped: the composite and blend run on the crop
        md_p = frames[2]
        md_c, orig_c, decode_crop = md_p[0, :, rows[0] : rows[1]], orig_p[:, rows[0] : rows[1]], None
        if crop is not None:
            y0, x0, ch, cw = crop
            p0, p1 = min(max(rows[0], y0), y0 + ch), min(max(rows[1], y0), y0 + ch)  # the crop's rows composed here
            md_c = md_p[0, :, p0:p1, x0 : x0 + cw]
            orig_c = orig_p[:, p0:p1, x0 : x0 + cw]
            if split:
                out_rows = out_rows.clipped(y0, y0 + ch)
            if crop_decode_ok((hh, ww), crop):
                decode_crop = crop
        if self._mp() <= 1:
            ctx = contextlib.nullcontext()
        else:
            ctx = spatial_sharding(self.mesh) if split else sequence_sharding(self.mesh)
        with ctx:
            imgs = self._feature_windows(tables, frames, orig_c, md_c, (hh, ww), t, crop, decode_crop, rows)
        out = _blend_windows(imgs, starts, slot_valid, t, l_t_max)
        return out if out_rows is None else out_rows.gather(out, 1)

    def _feature_windows(self, tables, frames, orig_c, md_c, hw, t, crop, decode_crop, rows):
        """The feature stage's composed windows [nW, l_t_max, rows, W, 3] (of
        the crop, with one), in groups, each group's windows split over the
        data ranks. tables: `_window_tables`; frames: the updated frames,
        updated and dilated masks and both flows, zero-padded on T. Under
        `spatial_sharding` the rows are this rank's (`rows`: its pixel
        rows), the features its widened feature rows (`encode_features`)."""
        dt = self.cdtype
        dev = self.device
        uf_p, um_p, md_p, ff_p, fb_p = frames
        hh, ww = hw
        h4, w4 = hh // 4, ww // 4
        sels, valids, starts, lts, refs, _, l_t_max, _ = tables
        n_windows = sels.shape[0]
        dp = self._dp()
        prm = self.inpaint_params

        # per-frame work once per unique frame, on every rank (a gather of
        # the features would move more than encoding them; the H split
        # encodes the rank's rows); windows gather from it
        enc_all = pp.encode_features(prm, uf_p[0, :t], md_p[0, :t], um_p[0, :t])
        ds_ff_all = pp.downsample_flow(ff_p, h4, w4)[0]
        ds_fb_all = pp.downsample_flow(fb_p, h4, w4)[0]
        ds_md_all = pp.downsample_mask(md_p, h4, w4)[0]
        ds_um_all = pp.downsample_mask(um_p, h4, w4)[0]
        pool_all = pp.attention_pool_mask(ds_md_all[None])[0]

        def windows(grp):
            """The composed windows `grp` (a tensor of window ids)."""
            grp = grp.tolist()
            gsel = torch.as_tensor(sels[grp], device=dev)
            gloc = gsel[:, :l_t_max]
            gvl = torch.as_tensor(valids[grp][:, :l_t_max], device=dev, dtype=dt)[:, :, None, None, None]
            gst = [int(s) for s in starts[grp]]
            pred = pp.inpaint_generator_from_features(
                prm,
                enc_all[gsel],
                torch.stack([ds_ff_all[s : s + l_t_max - 1] for s in gst]),
                torch.stack([ds_fb_all[s : s + l_t_max - 1] for s in gst]),
                ds_md_all[gloc] * gvl,
                ds_um_all[gloc] * gvl,
                pool_all[gloc] * gvl,
                l_t_max,
                (hh, ww),
                l_t_valid=torch.as_tensor(lts[grp], device=dev),
                ref_valid=torch.as_tensor(refs[grp], device=dev),
                crop=decode_crop,
            )
            if crop is not None and decode_crop is None:
                y0, x0, ch, cw = crop
                p0, p1 = min(max(rows[0], y0), y0 + ch), min(max(rows[1], y0), y0 + ch)
                pred = pred[:, :, p0 - rows[0] : p1 - rows[0], x0 : x0 + cw]
            # uint8 composite (propainter_inference.py:283-293)
            pred_byte = torch.floor((pred.float() + 1.0) / 2.0 * 255.0)
            binary = (md_c[gloc] * gvl).float()
            orig = torch.stack([orig_c[s : s + l_t_max] for s in gst])
            return (torch.floor(pred_byte * binary + orig * (1.0 - binary)),)

        group = _window_group_size(n_windows, dp)
        self._report("feature_propagation", 0, n_windows)
        imgs = []
        for g0 in range(0, n_windows, group):
            grp = torch.arange(g0, min(n_windows, g0 + group))
            (out,) = self._chunk_mapped(windows)(*self._pad_chunk_axis((grp,), dp))
            imgs.append(out[: len(grp)])
            self._report("feature_propagation", int(grp[-1]) + 1, n_windows)
        return torch.cat(imgs, dim=0)

    def feature_window(self, frames, masks, upd_masks, flows, old, orig, blend, l_t: int, n_ref: int):
        """One sliding window of the feature stage, full frames: the
        transformer on the window's frames, the uint8 composite, and the
        overlap blend against the composed frames under the window.

        frames / masks / upd_masks [1, T_sel, H, W, C]: the updated frames,
        dilated and updated masks of the window's l_t_max local slots then
        its reference slots (padded slots' masks zeroed; l_t and n_ref
        are the real counts); flows (f, b) [1, l_t_max - 1, H, W, 2];
        old [l_t_max, H, W, 3] the composed frames under the window and
        orig the input bytes there, float 0..255; blend [l_t_max] 1.0 on a
        first visit, 0.5 on a revisit, 0.0 on a padded slot.
        Returns the blended [l_t_max, H, W, 3], float 0..255."""
        l_t_max = old.shape[0]
        pred = pp.inpaint_generator_forward(
            self.inpaint_params, frames, flows[0], flows[1], masks, upd_masks, l_t_max,
            l_t_valid=l_t, ref_valid=n_ref,
        )[0].float()
        # uint8 composite (propainter_inference.py:283-293)
        pred_byte = torch.floor((pred + 1.0) / 2.0 * 255.0)
        binary = masks[0, :l_t_max].float()
        img = torch.floor(pred_byte * binary + orig * (1.0 - binary))
        b = blend[:, None, None, None]
        return torch.floor(b * img + (1.0 - b) * old)

    # ------------------------------------------------------------ full run

    def process(self, frames_norm, flow_masks, masks_dilated, original_frames, crop=None):
        """The four stages. frames_norm [1, T, H, W, 3] fp32 in [-1, 1];
        masks [1, T, H, W, 1]; original_frames [T, H, W, 3] float 0..255.
        Returns the composed video [T, H, W, 3] float 0..255, or with crop =
        (y0, x0, ch, cw) its window [T, ch, cw, 3]. Each stage's wall time
        (`stage_timer`: synchronised on the card in blocking mode) lands in
        the stage table, `utils/profiling.summary()`."""
        fp32 = full_fp32() if self.device.type == "cuda" else contextlib.nullcontext()
        with fp32, torch.inference_mode():
            with stage_timer("compute_flow"):
                gt_flows = self.compute_flow(frames_norm)
            with stage_timer("complete_flow"):
                pred_flows = self.complete_flow(gt_flows, flow_masks)
            with stage_timer("image_propagation"):
                uf, um = self.image_propagation(frames_norm, masks_dilated, pred_flows)
            with stage_timer("feature_propagation"):
                return self.feature_propagation(uf, um, masks_dilated, pred_flows, original_frames, crop)
