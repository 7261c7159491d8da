"""Pipeline stages: flow -> completion -> image prop -> feature prop.

Port of the JAX package's `pipeline/stages.py` main path, as eager
PyTorch on one device. Chunk boundaries follow the reference inference script
(propainter_inference.py): flow-completion subvideo chunks with a
5-frame halo, image-propagation chunks of <= 100 frames with a 10-frame
halo, sliding neighbor windows with global reference frames and the
first-visit / 0.5-blend overlap merge. The chunk loops are plain Python
loops over unpadded chunks (exactly what the JAX package's padded,
masked chunks compute for their real frames). RAFT's clip chunking only
bounds memory, so all pairs run in one call when the correlation
volumes fit. The feature stage encodes every frame once and gathers
windows from the per-frame features, in groups of at most 8 windows.

With a crop (the node's mask bounding box, `nodes.py::_mask_crop_plan`)
the feature stage decodes, composites and blends only that window: the
composed video equals the input outside the dilated mask, and
`decoder_crop` is exact. `process_node_outpaint` runs the stages on the
outpaint canvas and returns only its bands.

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
from ..utils.image import extrapolate_frames
from ..utils.params import to_device
from ..utils.profiling import progress_report, stage_timer

RAFT_ALLPAIRS_BYTES = 4.5e9  # all-pairs volume budget for one RAFT call
# what one RAFT call may hold in its correlation volume (`raft.call_bytes`):
# above it RAFT runs a pair a call, then a pair a call with the directions
# in turn. A chunk of 2 pairs at 1920x1080 holds 11.7 GiB in bf16, so every
# path up to 1080p keeps its chunks on an 80 GB card
RAFT_CALL_BYTES = 24 << 30
WINDOW_GROUP = 8  # windows per batched transformer forward


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
    gate, stages.py:1646-1653): decoder_crop's halo block must fit inside
    the frame; PROPAINTER_TPU_CROP_DECODE=0 (read at call time) turns it
    off, and the full frames are decoded and then cropped."""
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


def jax_flow_lookup(cfg: PipelineConfig, t: int, hw: tuple[int, int]) -> str:
    """The lookup the JAX stage plan takes for one `compute_flow` call of
    t frames at hw = (H, W) (`Pipeline._flow_fn`, stages.py:355-515
    there), with the variables it reads and their defaults, read at call
    time. Its RAFT calls hold n pairs:
      one call        one chunk, or the all-pairs volume 2 (t-1) h8w8^2
                      esz 1.36 within PROPAINTER_TPU_RAFT_ALLPAIRS_BYTES
                      (4.5e9): n = t - 1;
      chunk by chunk  the chunks' total over that budget, one chunk within
                      it: n = clip (JAX pads the first chunk to clip + 1);
      pair by pair    one chunk over it: n = 1, and past
                      PROPAINTER_TPU_RAFT_SEQDIR_BYTES (2e9) for one pair's
                      volume the directions in turn, whose `raft_forward`
                      never takes the lanes lookup;
      chunks batched  otherwise: n = n_chunks clip.
    The lookup of n pairs is `raft.lookup_mode`'s. (JAX's clip-parallel
    branch is multi-device and not ported.)"""
    bounds = flow_chunk_plan(cfg, t)
    clip = cfg.raft_chunk_len()
    h8, w8 = hw[0] // 8, hw[1] // 8
    dtype = torch.bfloat16 if cfg.raft_half else torch.float32

    def volume(pairs):
        return 2 * pairs * (h8 * w8) ** 2 * dtype.itemsize * 1.36

    budget = float(os.environ.get("PROPAINTER_TPU_RAFT_ALLPAIRS_BYTES", 4.5e9))
    if len(bounds) == 1 or volume(t - 1) <= budget:
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


def raft_form(cfg: PipelineConfig, t: int, hw: tuple[int, int]) -> str:
    """How `Pipeline.compute_flow` runs RAFT on t frames at hw:
      "one call"   one chunk, or the all-pairs volume within
                   RAFT_ALLPAIRS_BYTES (the JAX stage's rule);
      "chunks"     otherwise, one call a chunk of `flow_chunk_plan`;
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
    mode = jax_flow_lookup(cfg, t, hw)
    if len(bounds) == 1 or 2 * (t - 1) * (h8 * w8) ** 2 * esz * 1.36 <= RAFT_ALLPAIRS_BYTES:
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


class Pipeline:
    """End-to-end video inpainting on one device.

    Params are upstream-layout CPU tensors; they are cast (bf16 under
    fp16="enable", RAFT per `config.raft_half`) and moved once. On the
    card `process` runs with TF32 off for cuDNN convs and matmuls
    (`full_fp32`), so the fp32 paths compute in full fp32; the process's
    own TF32 flags are back as they were after each run."""

    def __init__(self, raft_params, flow_params, inpaint_params, config: PipelineConfig, device="cuda"):
        self.config = config
        self.device = torch.device(device)
        rdt = torch.bfloat16 if config.raft_half else torch.float32
        self.cdtype = torch.bfloat16 if config.use_bf16 else torch.float32
        self.raft_params = to_device(raft_params, self.device, rdt)
        self.flow_params = to_device(flow_params, self.device, self.cdtype)
        self.inpaint_params = to_device(inpaint_params, self.device, self.cdtype)
        self.stage_seconds: dict[str, float] = {}
        # progress callback: fn(stage_name, done_units, total_units)
        self.progress = None

    def _report(self, stage: str, done: int, total: int) -> None:
        progress_report(self.progress, stage, done, total)

    # ------------------------------------------------------------- stage 1

    def compute_flow(self, frames):
        """Bidirectional RAFT flow. frames [1, T, H, W, 3] fp32 in [-1, 1]
        -> (flows_f, flows_b) [1, T-1, H, W, 2] fp32, in the form
        `raft_form` picks; every call takes the blend of the JAX stage
        plan for this clip (`jax_flow_lookup`)."""
        cfg = self.config
        t, hw = frames.shape[1], (frames.shape[2], frames.shape[3])
        form = raft_form(cfg, t, hw)
        blend = jax_flow_lookup(cfg, t, hw)
        prm, iters = self.raft_params, cfg.raft_iter
        if form == "one call":
            calls = [(raft.raft_bi_forward, 0, t)]
        elif form == "chunks":
            calls = [(raft.raft_bi_forward, s, e) for s, e in flow_chunk_plan(cfg, t)]
        else:
            fn = raft.raft_bi_forward if form == "per pair" else raft.raft_bi_forward_seqdir
            calls = [(fn, i, i + 2) for i in range(t - 1)]
        self._report("compute_flow", 0, 1)
        ff, fb = zip(*(fn(prm, frames[:, s:e], iters, blend) for fn, s, e in calls))
        self._report("compute_flow", 1, 1)
        return (ff[0], fb[0]) if len(calls) == 1 else (torch.cat(ff, dim=1), torch.cat(fb, dim=1))

    # ------------------------------------------------------------- stage 2

    def complete_flow_chunk(self, ff, fb, mk):
        """One flow-completion chunk: flows (ff, fb) [1, n, H, W, 2] and
        flow masks [1, n + 1, H, W, 1] -> the completed flows, in the
        compute dtype. Past its memory budget `forward_bidirect_flow`
        completes the directions in turn (the JAX stage's high-res form,
        stages.py:1428-1487 there): one direction's activations are live
        at a time."""
        dt = self.cdtype
        ff, fb, mk = ff.to(dt), fb.to(dt), mk.to(dt)
        pf, pb = fc.forward_bidirect_flow(self.flow_params, ff, fb, mk)
        return fc.combine_flow(ff, fb, pf, pb, mk)

    def complete_flow(self, flows, flow_masks):
        """Flow completion over subvideo chunks with a 5-frame halo.
        flows (f, b) [1, T-1, H, W, 2]; flow_masks [1, T, H, W, 1]."""
        ff, fb = flows
        self._report("complete_flow", 0, 1)
        flow_length = ff.shape[1]
        if flow_length <= self.config.subvideo_length:
            out = self.complete_flow_chunk(ff, fb, flow_masks)
        else:
            out_f, out_b = [], []
            for s_f, e_f, ps, pe in complete_chunk_plan(self.config, flow_length):
                of, ob = self.complete_flow_chunk(ff[:, s_f:e_f], fb[:, s_f:e_f], flow_masks[:, s_f : e_f + 1])
                end = e_f - s_f - pe
                out_f.append(of[:, ps:end])
                out_b.append(ob[:, ps:end])
            out = torch.cat(out_f, dim=1), torch.cat(out_b, dim=1)
        self._report("complete_flow", 1, 1)
        return out

    # ------------------------------------------------------------- stage 3

    def image_prop_chunk(self, fr, mk, ff, fb):
        """One image-propagation chunk: frames [1, n, H, W, 3] in [-1, 1],
        dilated masks [1, n, H, W, 1], completed flows [1, n - 1, H, W, 2]
        -> (updated_frames, updated_masks) in the compute dtype."""
        dt = self.cdtype
        fr, mk, ff, fb = fr.to(dt), mk.to(dt), ff.to(dt), fb.to(dt)
        masked = fr * (1 - mk)
        prop, upd_mask = pp.bidirectional_propagation_image(masked, ff, fb, mk, "nearest")
        return fr * (1 - mk) + prop * mk, upd_mask

    def image_propagation(self, frames, masks_dilated, pred_flows):
        """Pixel-domain propagation in <=100-frame chunks with a 10-frame
        halo. Returns (updated_frames, updated_masks) in the compute dtype."""
        ff, fb = pred_flows
        self._report("image_propagation", 0, 1)
        t = frames.shape[1]
        if t <= min(100, self.config.subvideo_length):
            out = self.image_prop_chunk(frames, masks_dilated, ff, fb)
        else:
            out_fr, out_mk = [], []
            for s_f, e_f, ps, pe in imgprop_chunk_plan(self.config, t):
                uf, um = self.image_prop_chunk(
                    frames[:, s_f:e_f], masks_dilated[:, s_f:e_f], ff[:, s_f : e_f - 1], fb[:, s_f : e_f - 1]
                )
                end = e_f - s_f - pe
                out_fr.append(uf[:, ps:end])
                out_mk.append(um[:, ps:end])
            out = torch.cat(out_fr, dim=1), torch.cat(out_mk, dim=1)
        self._report("image_propagation", 1, 1)
        return out

    # ------------------------------------------------------------- stage 4

    def feature_propagation(self, updated_frames, updated_masks, masks_dilated, pred_flows, original_frames, crop=None):
        """Sliding-window transformer inference, uint8 composite and overlap
        blend. original_frames [T, H, W, 3] float 0..255. Returns the
        composed video [T, H, W, 3] float 0..255 (uint8-exact); with crop =
        (y0, x0, ch, cw) only that window of it, [T, ch, cw, 3], decoded
        alone where `crop_decode_ok` allows."""
        cfg = self.config
        dt = self.cdtype
        dev = self.device
        t, hh, ww = updated_frames.shape[1], updated_frames.shape[2], updated_frames.shape[3]
        sels, valids, starts, lts, refs, slot_valid, l_t_max, _ = _window_tables(cfg, t)
        n_windows = sels.shape[0]

        def pad_t(a):  # zero frames after the end: window slices stay in range
            return torch.cat([a, a.new_zeros((a.shape[0], l_t_max) + a.shape[2:])], dim=1)

        uf_p = pad_t(updated_frames.to(dt))
        um_p = pad_t(updated_masks.to(dt))
        md_p = pad_t(masks_dilated.to(dt))
        ff_p = pad_t(pred_flows[0].to(dt))
        fb_p = pad_t(pred_flows[1].to(dt))
        orig_p = pad_t(original_frames.float()[None])[0]
        # the composite's inputs, cropped: the composite and blend run on the crop
        md_c, orig_c, decode_crop = md_p[0], orig_p, None
        if crop is not None:
            y0, x0, ch, cw = crop
            md_c = md_c[:, y0 : y0 + ch, x0 : x0 + cw]
            orig_c = orig_c[:, y0 : y0 + ch, x0 : x0 + cw]
            if crop_decode_ok((hh, ww), crop):
                decode_crop = crop
        h4, w4 = hh // 4, ww // 4
        prm = self.inpaint_params

        # per-frame work once per unique frame; windows gather from it
        enc_all = pp.encode_features(prm, uf_p[0, :t], md_p[0, :t], um_p[0, :t])
        ds_ff_all = pp.downsample_flow(ff_p, h4, w4)[0]
        ds_fb_all = pp.downsample_flow(fb_p, h4, w4)[0]
        ds_md_all = pp.downsample_mask(md_p, h4, w4)[0]
        ds_um_all = pp.downsample_mask(um_p, h4, w4)[0]
        pool_all = pp.attention_pool_mask(ds_md_all[None])[0]

        self._report("feature_propagation", 0, n_windows)
        imgs = []
        for g0 in range(0, n_windows, WINDOW_GROUP):
            grp = list(range(g0, min(n_windows, g0 + WINDOW_GROUP)))
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
                pred = pred[:, :, y0 : y0 + ch, x0 : x0 + cw]
            # uint8 composite (propainter_inference.py:283-293)
            pred_byte = torch.floor((pred.float() + 1.0) / 2.0 * 255.0)
            binary = (md_c[gloc] * gvl).float()
            orig = torch.stack([orig_c[s : s + l_t_max] for s in gst])
            imgs.append(torch.floor(pred_byte * binary + orig * (1.0 - binary)))
            self._report("feature_propagation", grp[-1] + 1, n_windows)
        return _blend_windows(torch.cat(imgs, dim=0), starts, slot_valid, t, l_t_max)

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
        (y0, x0, ch, cw) its window [T, ch, cw, 3]. Per-stage wall times
        (`stage_timer`: synchronised on the card in blocking mode) land in
        `stage_seconds`."""
        stages = {}

        def timed(name, fn, *args):
            with stage_timer(name) as tm:
                out = fn(*args)
            stages[name] = tm.seconds
            return out

        fp32 = full_fp32() if self.device.type == "cuda" else contextlib.nullcontext()
        with fp32, torch.inference_mode():
            gt_flows = timed("compute_flow", self.compute_flow, frames_norm)
            pred_flows = timed("complete_flow", self.complete_flow, gt_flows, flow_masks)
            uf, um = timed("image_propagation", self.image_propagation, frames_norm, masks_dilated, pred_flows)
            out = timed(
                "feature_propagation", self.feature_propagation,
                uf, um, masks_dilated, pred_flows, original_frames, crop,
            )
        self.stage_seconds = stages
        return out

    def process_node_outpaint(self, frames_u8, canvas_hw: tuple[int, int]):
        """The outpaint node's run. frames_u8 [T, ph, pw, 3] uint8 on the
        device go centred on a zero canvas of canvas_hw with both ring
        masks (`extrapolate_frames`; k / 255 * 255 is k again in fp32);
        the four stages take the canvas as the original frames.
        Returns the composed canvas's uint8 bands, top, bottom, left and
        right, empty ones left out: the interior equals the input bytes
        (its dilated mask is 0), so the caller already holds it."""
        t, ph, pw, _ = frames_u8.shape
        chh, cww = canvas_hw
        h_start, w_start = (chh - ph) // 2, (cww - pw) // 2
        canvas, flow_masks, masks_dilated = extrapolate_frames(frames_u8.float() / 255.0, pw, ph, cww, chh)
        canvas = canvas * 255.0
        composed = self.process(
            (canvas / 255.0 * 2.0 - 1.0)[None],
            flow_masks[None].contiguous(),
            masks_dilated[None].contiguous(),
            canvas,
        ).to(torch.uint8)
        bands = []
        if h_start:
            bands += [composed[:, :h_start], composed[:, h_start + ph :]]
        if w_start:
            mid = composed[:, h_start : h_start + ph]
            bands += [mid[:, :, :w_start], mid[:, :, w_start + pw :]]
        return bands
