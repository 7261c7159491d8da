"""The two nodes' outputs, worked out from their inputs in plain PyTorch.

`inpaint` and `outpaint` take what ComfyUI hands the nodes (IMAGE as a
float [T, H, W, 3] in 0..1, MASK as [T, H, W]) and their widgets, and
return what the nodes return. Frames and masks supplied at another size
than the process size (width and height rounded down to multiples of
8) are resized to it as PIL resizes them (`resize.py`), masks then
taken where non-zero. The whole frame is composed: the
nodes' crop of the mask's bounding box is theirs to get right.

Stages (the reference inference script's): RAFT over every adjacent
pair, flow completion over subvideo chunks with a 5-flow halo, image
propagation over chunks of at most 100 frames with a 10-frame halo, and
the sliding windows of the feature stage (neighbour stride
neighbor_length // 2, reference frames every ref_stride), each window's
local frames composed in uint8 over the input and blended in visit
order: a first visit replaces, a revisit takes floor(0.5 new + 0.5 old).
"""

from __future__ import annotations

import torch

from . import flow_completion, propainter, raft
from .ops import binary_dilation
from .resize import resize


def _mod8(v: int) -> int:
    return v - v % 8


def _u8(x: torch.Tensor) -> torch.Tensor:
    """ComfyUI floats to bytes, truncating (the nodes' PIL round trip)."""
    return torch.floor(torch.clamp(x.float() * 255.0, 0.0, 255.0))


def _ref_index(mid, neighbor_ids, t, ref_stride, ref_num):
    refs = []
    if ref_num == -1:
        return [i for i in range(0, t, ref_stride) if i not in neighbor_ids]
    start = max(0, mid - ref_stride * (ref_num // 2))
    end = min(t, mid + ref_stride * (ref_num // 2))
    for i in range(start, end, ref_stride):
        if i not in neighbor_ids:
            if len(refs) > ref_num:
                break
            refs.append(i)
    return refs


def windows(w: dict, t: int):
    """(neighbor_ids, ref_ids) of each sliding window."""
    ns = w["neighbor_length"] // 2
    ref_num = w["subvideo_length"] // w["ref_stride"] if t > w["subvideo_length"] else -1
    out = []
    for f in range(0, t, ns):
        nids = list(range(max(0, f - ns), min(t, f + ns + 1)))
        out.append((nids, _ref_index(f, nids, t, w["ref_stride"], ref_num)))
    return out


def _chunks(length: int, sub: int, halo: int):
    """(start, end, lead, tail) of chunks of `sub` with `halo` each side."""
    out = []
    for f in range(0, length, sub):
        s, e = max(0, f - halo), min(length, f + sub + halo)
        out.append((s, e, f - s, e - min(length, f + sub)))
    return out


def _stitch(parts, plan):
    return tuple(torch.cat([o[lead : (e - s) - tail] for o, (s, e, lead, tail) in zip(col, plan)])
                 for col in zip(*parts))


def run_stages(params, frames_b, flow_masks, masks_dilated, w: dict):
    """The four stages. frames_b [T, H, W, 3] bytes as floats; masks
    [T, H, W] {0, 1} -> the composed video [T, H, W, 3], bytes as floats."""
    t = frames_b.shape[0]
    frames = frames_b / 255.0 * 2.0 - 1.0
    fm, md = flow_masks[..., None], masks_dilated[..., None]
    ff, fb = raft.raft_bidirectional(params["raft"], frames, w["raft_iter"])

    sub = w["subvideo_length"]
    plan = _chunks(t - 1, sub, 5)
    parts = [flow_completion.complete_bidirectional(params["flow_completion"], ff[s:e], fb[s:e], fm[s : e + 1])
             for s, e, _, _ in plan]
    cf, cb = _stitch(parts, plan)
    del ff, fb

    plan = _chunks(t, min(100, sub), 10)
    parts = [propainter.image_propagation(frames[s:e], md[s:e], cf[s : e - 1], cb[s : e - 1]) for s, e, _, _ in plan]
    upd_frames, upd_masks = _stitch(parts, plan)

    wins = windows(w, t)
    l_t_max = 2 * (w["neighbor_length"] // 2) + 1
    canvas = torch.zeros_like(frames_b)
    seen = [False] * t
    gp = params["inpaint_generator"]
    for nids, rids in wins:
        ids = nids + rids
        slots = list(range(len(nids))) + [l_t_max + r for r in range(len(rids))]
        s0, s1 = nids[0], nids[-1]
        pred = propainter.window_forward(
            gp, upd_frames[ids], md[ids], upd_masks[ids], cf[s0:s1], cb[s0:s1], len(nids), slots
        )
        pred_byte = torch.floor((pred + 1.0) / 2.0 * 255.0)
        binary = md[nids]
        img = torch.floor(pred_byte * binary + frames_b[nids] * (1.0 - binary))
        for j, fi in enumerate(nids):
            canvas[fi] = torch.floor(0.5 * img[j] + 0.5 * canvas[fi]) if seen[fi] else img[j]
            seen[fi] = True
    return canvas


def _to_process_size(stack, w: dict):
    """Bytes [T, H, W(, C)] resized to the process size where they differ."""
    ph, pw = _mod8(w["height"]), _mod8(w["width"])
    return stack if tuple(stack.shape[1:3]) == (ph, pw) else resize(stack, ph, pw)


def inpaint(params, image, mask, w: dict):
    """ProPainterInpaint: (IMAGE, FLOW_MASK, MASK_DILATE)."""
    t = image.shape[0]
    frames_b = _to_process_size(_u8(image), w)
    h, wd = frames_b.shape[1:3]
    masks = mask if mask.ndim == 3 else mask[None]
    base = (_to_process_size(_u8(masks), w) != 0).float().expand(t, h, wd)
    fm = binary_dilation(base, w["flow_mask_dilates"])
    md = binary_dilation(base, w["mask_dilates"])
    out = run_stages(params, frames_b, fm, md, w)
    return out / 255.0, fm, md


def outpaint(params, image, w: dict):
    """ProPainterOutpaint: (IMAGE, OUTPAINT_MASK, width, height) on the
    canvas of width_scale x height_scale, the frames centred on zeros."""
    frames_b = _to_process_size(_u8(image), w)
    t, ph, pw = frames_b.shape[:3]
    cw, chh = _mod8(int(w["width_scale"] * w["width"])), _mod8(int(w["height_scale"] * w["height"]))
    hs, ws = (chh - ph) // 2, (cw - pw) // 2
    canvas = image.new_zeros((t, chh, cw, 3))
    canvas[:, hs : hs + ph, ws : ws + pw] = frames_b
    dh, dw = (4 if hs > 10 else 0), (4 if ws > 10 else 0)
    fm = torch.ones((t, chh, cw), device=image.device)
    fm[:, hs + dh : hs + ph - dh, ws + dw : ws + pw - dw] = 0.0
    md = torch.ones((t, chh, cw), device=image.device)
    md[:, hs : hs + ph, ws : ws + pw] = 0.0
    out = run_stages(params, canvas, fm, md, w)
    return out / 255.0, md, cw, chh
