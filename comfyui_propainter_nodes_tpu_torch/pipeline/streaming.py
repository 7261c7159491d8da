"""Long videos with a bounded working set, bit for bit the in-memory run.

`Pipeline.process` holds every stage's output for the whole clip on the
card, so device memory bounds the clip length. `process_streaming` runs
the same four stages over a sliding working set of O(subvideo_length)
frames and gives the same bytes:

  * RAFT flows are independent per frame pair, so each is computed for
    exactly the pair range a completion chunk needs: above 640x480 in
    sub-ranges of `stream_flow_pairs()` pairs (PROPAINTER_TPU_STREAM_FLOW_PAIRS,
    default 24, read at call time as the JAX driver reads it), each its
    own `compute_flow` call, as the JAX driver calls it (`_flows_range`,
    streaming.py:164-197 there), so each call takes the JAX stage's RAFT
    blend;
  * flow-completion and image-propagation chunks have ABSOLUTE bounds
    (`complete_chunk_plan`, `imgprop_chunk_plan`: multiples of the
    chunk length with fixed halos, propainter_inference.py:115-144,
    172-212), so streaming runs exactly the in-memory chunks
    (`Pipeline.complete_flow_chunk`, `image_prop_chunk`) and caches each
    chunk's output until no later window can need it;
  * transformer windows slide by neighbor_stride with reference frames
    at most ref_stride * (ref_num // 2) away (`window_plan`), so a
    lookahead of one chunk suffices; the 0.5/0.5 revisit blend and the
    composed frames roll forward in a short tail (`Pipeline.feature_window`).

Frames enter through `fetch(start, count) -> [count, H, W, 3]` float32
in [0, 1] (for example `utils.frameio.VideoSource.fetch`) and leave
through `write(start, frames)` once final. It decodes full frames: the
crop plan of the inpaint node is not applied here.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable

import numpy as np
import torch

from ..utils import image as image_utils
from ..utils.profiling import stage_timer
from .stages import Pipeline, _window_tables, complete_chunk_plan, full_fp32, imgprop_chunk_plan


def stream_flow_pairs() -> int:
    """RAFT pairs a compute_flow call above 640x480:
    PROPAINTER_TPU_STREAM_FLOW_PAIRS (read at call time), default 24."""
    return int(os.environ.get("PROPAINTER_TPU_STREAM_FLOW_PAIRS", "24"))


class _ChunkCache:
    """chunk index -> value, computed on first use, evicted below a floor.
    `peak` is the largest number of entries held at once."""

    def __init__(self, compute: Callable[[int], object]):
        self._compute = compute
        self._store: dict[int, object] = {}
        self.peak = 0

    def get(self, k: int):
        if k not in self._store:
            self._store[k] = self._compute(k)
            self.peak = max(self.peak, len(self._store))
        return self._store[k]

    def evict_below(self, k_min: int) -> None:
        for k in [k for k in self._store if k < k_min]:
            del self._store[k]


def process_streaming(
    pipe: Pipeline,
    fetch: Callable[[int, int], np.ndarray],
    fetch_mask: Callable[[int, int], np.ndarray],
    num_frames: int,
    write: Callable[[int, np.ndarray], None],
    mask_dilates: int = 5,
    flow_mask_dilates: int = 8,
    prefetch: Callable[[int, int], None] | None = None,
) -> dict[str, int]:
    """Run the four stages over `num_frames` frames, writing the composed
    frames (float32 0..255, uint8-exact, [n, H, W, 3] at the process
    size) through `write(start, frames)` in order, each exactly once.

    fetch(start, count): frames [count, H, W, 3] float in [0, 1] at the
    source size; fetch_mask likewise [count, H, W]. Neither is asked for
    a frame outside [0, num_frames). prefetch(start, count), when given,
    is told which frames come next.

    Runs with TF32 off on the card (`full_fp32`) and in inference mode,
    as `Pipeline.process` does. Ticks `pipe.progress` with
    ("feature_windows", done, n_windows) once a window, after the
    window's flush and eviction. Returns the largest number of live
    entries of each chunk cache ("prep", "completed", "updated")."""
    fp32 = full_fp32() if pipe.device.type == "cuda" else contextlib.nullcontext()
    with fp32, torch.inference_mode():
        return _stream(pipe, fetch, fetch_mask, num_frames, write, mask_dilates, flow_mask_dilates, prefetch)


def _stream(pipe, fetch, fetch_mask, t, write, mask_dilates, flow_mask_dilates, prefetch):
    cfg = pipe.config
    dev = pipe.device
    dt = pipe.cdtype
    pw, ph = cfg.process_size
    sub = cfg.subvideo_length
    sub_img = min(100, sub)
    ns = cfg.neighbor_stride
    ref_num = sub // cfg.ref_stride if t > sub else -1

    # ---------------- prepared frames and masks, cached by chunk --------
    # byte frames (integral 0..255 after the PIL-exact resize) and binary
    # masks are stored as uint8, exactly; the [-1, 1] normalization is
    # recomputed per gather with the in-memory expression
    prep_chunk = 32 if ph * pw <= 640 * 480 else 16

    def _prep(k: int):
        lo = k * prep_chunk
        n = min(prep_chunk, t - lo)
        if prefetch is not None:
            prefetch(lo + n, prep_chunk)
        with stage_timer("stream_prep"):
            frames = torch.from_numpy(np.ascontiguousarray(fetch(lo, n), np.float32)).to(dev)
            masks = torch.from_numpy(np.ascontiguousarray(fetch_mask(lo, n), np.float32)).to(dev)
            _, byte = image_utils.prepare_frames(frames, pw, ph)
            flow_m, dil_m = image_utils.prepare_masks(masks, pw, ph, flow_mask_dilates, mask_dilates)
            return byte.to(torch.uint8), flow_m.to(torch.uint8), dil_m.to(torch.uint8)

    prep = _ChunkCache(_prep)
    slot = {"byte": 0, "flow_mask": 1, "mask": 2}

    def gather(kind: str, lo: int, hi: int, dtype=torch.float32):
        """Prepared frames [lo, hi) (clamped to the clip): "norm" (the
        frames in [-1, 1]), "byte" (0..255), "flow_mask" or "mask"."""
        lo, hi = max(0, lo), min(t, hi)
        parts = []
        for k in range(lo // prep_chunk, (hi - 1) // prep_chunk + 1):
            cached = prep.get(k)
            s, e = max(lo - k * prep_chunk, 0), min(hi - k * prep_chunk, cached[0].shape[0])
            if kind == "norm":
                parts.append((cached[0][s:e].float() / 255.0 * 2.0 - 1.0).to(dtype))
            else:
                parts.append(cached[slot[kind]][s:e].to(dtype))
        return torch.cat(parts) if len(parts) > 1 else parts[0]

    # ---------------- stages 1 + 2: completed flows per absolute chunk --
    flow_len = t - 1
    fc_plan = complete_chunk_plan(cfg, flow_len)
    rdt = pipe.raft_params["fnet.conv1.weight"].dtype

    def _flows(lo: int, hi: int):
        """RAFT flows (f, b) of pairs [lo, hi) in the compute dtype: one
        `compute_flow` call, or above 640x480 one a sub-range of
        `stream_flow_pairs()` pairs. RAFT casts its frames to its parameters'
        dtype and completion its flows to the compute dtype: casting here
        changes no value."""
        step = hi - lo if ph * pw <= 640 * 480 else stream_flow_pairs()
        parts_f, parts_b = [], []
        for a in range(lo, hi, step):
            frames = gather("norm", a, min(hi, a + step) + 1, rdt)[None]
            with stage_timer("compute_flow"):
                ff, fb = pipe.compute_flow(frames)
            parts_f.append(ff.to(dt))
            parts_b.append(fb.to(dt))
        if len(parts_f) == 1:
            return parts_f[0], parts_b[0]
        return torch.cat(parts_f, 1), torch.cat(parts_b, 1)

    def _completed(k: int):
        s_f, e_f, ps, pe = fc_plan[k]
        ff, fb = _flows(s_f, e_f)
        mk = gather("flow_mask", s_f, e_f + 1, dt)[None]
        with stage_timer("complete_flow"):
            of, ob = pipe.complete_flow_chunk(ff, fb, mk)
        end = e_f - s_f - pe
        return s_f + ps, of[:, ps:end].clone(), ob[:, ps:end].clone()  # the halos freed

    completed = _ChunkCache(_completed)

    def completed_range(lo: int, hi: int):
        """Completed flows (f, b) of pairs [lo, hi)."""
        parts_f, parts_b = [], []
        for k in range(lo // sub, (hi - 1) // sub + 1):
            base, of, ob = completed.get(k)
            s, e = max(lo - base, 0), min(hi - base, of.shape[1])
            parts_f.append(of[:, s:e])
            parts_b.append(ob[:, s:e])
        if len(parts_f) == 1:
            return parts_f[0], parts_b[0]
        return torch.cat(parts_f, 1), torch.cat(parts_b, 1)

    # ---------------- stage 3: updated frames per absolute chunk --------
    ip_plan = imgprop_chunk_plan(cfg, t)
    pad_fc, pad_ip = 5, 10  # the two plans' halos

    def _updated(k: int):
        s_f, e_f, ps, pe = ip_plan[k]
        fr = gather("norm", s_f, e_f, dt)[None]
        mk = gather("mask", s_f, e_f, dt)[None]
        ff, fb = completed_range(s_f, e_f - 1)
        with stage_timer("image_propagation"):
            uf, um = pipe.image_prop_chunk(fr, mk, ff, fb)
        end = e_f - s_f - pe
        return s_f + ps, uf[:, ps:end].clone(), um[:, ps:end].clone()

    updated = _ChunkCache(_updated)

    def updated_at(idx):
        """Updated frames and masks [1, len(idx), H, W, C] at frames idx."""
        ufs, ums = [], []
        for i in idx:
            base, uf, um = updated.get(i // sub_img)
            ufs.append(uf[:, i - base])
            ums.append(um[:, i - base])
        return torch.stack(ufs, 1), torch.stack(ums, 1)

    # ---------------- stage 4: sliding windows, rolling composition -----
    sels, valids, starts, lts, refs, _, l_t_max, _ = _window_tables(cfg, t)
    n_windows = sels.shape[0]
    visited = np.zeros(t, dtype=bool)
    tail_base = 0  # the composed tail holds frames [tail_base, tail_base + len)
    tail = torch.zeros((0, ph, pw, 3), device=dev)
    ref_span = cfg.ref_stride * (ref_num // 2) if ref_num > 0 else t

    def zero_pad(a, n: int):
        """a padded with zeros along dim 0 (frames) or 1 (flows) to n."""
        d = 0 if a.dim() == 4 else 1
        if a.shape[d] >= n:
            return a
        shape = list(a.shape)
        shape[d] = n - a.shape[d]
        return torch.cat([a, a.new_zeros(shape)], d)

    def flush(start: int, frames):
        with stage_timer("stream_write"):
            write(start, frames.to("cpu", copy=True).numpy())

    for wi in range(n_windows):
        n0, l_t, n_ref = int(starts[wi]), int(lts[wi]), int(refs[wi])
        nids = range(n0, n0 + l_t)

        # extend the composed tail over this window: the input bytes, then
        # zeros past the end of the clip
        need_hi = n0 + l_t_max
        lo = tail_base + tail.shape[0]
        if lo < need_hi:
            newly = gather("byte", lo, need_hi) if lo < t else tail.new_zeros((0, ph, pw, 3))
            tail = torch.cat([tail, zero_pad(newly, need_hi - lo)])

        # padded slots are masked out in the window (l_t / n_ref and zeroed
        # masks), so their content does not matter; their frame index n0
        # keeps them inside the live working set (frame 0 would bring an
        # evicted chunk back)
        sel = np.where(valids[wi] > 0, sels[wi], n0).tolist()
        uf_sel, um_sel = updated_at(sel)
        md_sel = torch.stack([gather("mask", i, i + 1, dt)[0] for i in sel])[None]
        valid = torch.as_tensor(valids[wi], dtype=dt, device=dev)[None, :, None, None, None]
        ff, fb = completed_range(n0, min(n0 + l_t - 1, flow_len))
        blend = torch.tensor(
            [0.5 if visited[i] else 1.0 for i in nids] + [0.0] * (l_t_max - l_t), device=dev
        )
        old = tail[n0 - tail_base : n0 - tail_base + l_t_max]
        orig = zero_pad(gather("byte", n0, n0 + l_t_max), l_t_max)
        with stage_timer("feature_propagation"):
            blended = pipe.feature_window(
                uf_sel, md_sel * valid, um_sel * valid,
                (zero_pad(ff, l_t_max - 1), zero_pad(fb, l_t_max - 1)), old, orig, blend, l_t, n_ref,
            )
        tail[n0 - tail_base : n0 - tail_base + l_t_max] = blended
        visited[n0 : n0 + l_t] = True

        # frames before this window's start are final: no later window
        # reaches them
        if n0 > tail_base:
            flush(tail_base, tail[: n0 - tail_base])
            tail = tail[n0 - tail_base :]
            tail_base = n0

        # evict what no later window can need. Later windows touch frames
        # >= n0 - ref_span; each cache's floor then follows the halos its
        # recomputation would read: an updated chunk k reads completed
        # pairs and prepared frames from k * sub_img - pad_ip, a completed
        # chunk k reads prepared frames from k * sub - pad_fc
        f_lo = max(0, n0 - ref_span)
        upd_floor = f_lo // sub_img
        updated.evict_below(upd_floor)
        cmp_need = min(f_lo, max(0, upd_floor * sub_img - pad_ip))
        cmp_floor = cmp_need // sub
        completed.evict_below(cmp_floor)
        prep_need = min(tail_base, cmp_need, max(0, cmp_floor * sub - pad_fc))
        prep.evict_below(prep_need // prep_chunk)
        pipe._report("feature_windows", wi + 1, n_windows)

    if tail_base < t:
        flush(tail_base, tail[: t - tail_base])
    return {"prep": prep.peak, "completed": completed.peak, "updated": updated.peak}
