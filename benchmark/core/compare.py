"""The comparison that decides `correct`: a clip's node outputs against
the plain reference's outputs for the same inputs and weights.

Numbers (IMAGE in byte levels; "the mask" is the reference's dilated
mask for inpaint, its ring for outpaint):
  masks_mismatch  pixels where a returned mask differs from the
                  reference's (inpaint: FLOW_MASK and MASK_DILATE;
                  outpaint: OUTPAINT_MASK, and 1 if the canvas size
                  differs) - exact;
  outside_max     the largest |IMAGE - reference| outside the mask, where
                  both return the input bytes, in levels over 255 - exact;
  share_off3      the share of the mask's pixels at which IMAGE is three
                  levels or more from the reference in some channel;
  mean_levels     the mean over the mask's pixels of the worst channel's
                  gap, in levels.
A cell compares the exact two and those of the gap numbers that
separate its program from its control (a bf16 program and a float8
control differ most in the share three levels off; a float32 program
and a TF32 control never reach three levels and differ in the mean),
each against its limit in `benchmark/limits/<cell>.json`. A number above
its limit, or one that is not finite, makes the run not correct.
"""

from __future__ import annotations

import json
import math

import torch

NAMES = ("masks_mismatch", "outside_max", "share_off3", "mean_levels")


def load_limits(path: str) -> dict:
    with open(path) as f:
        return json.load(f)["limits"]


def numbers(kind: str, out, ref, detail: bool = False) -> dict:
    """The compared numbers of one clip; out and ref are the node's and
    the reference's return values (tensors on any device). IMAGE is
    compared in byte levels (its values are k / 255), as a share of 255.
    `detail` adds further statistics of the gap inside the mask."""
    img = torch.round(out[0].float().cpu() * 255.0)
    rimg = torch.round(ref[0].float().cpu() * 255.0)
    if kind == "inpaint":
        mask = ref[2].float().cpu() > 0
        mism = sum(int((o.float().cpu() != r.float().cpu()).sum()) for o, r in ((out[1], ref[1]), (out[2], ref[2])))
    else:
        mask = ref[1].float().cpu() > 0
        mism = int((out[1].float().cpu() != ref[1].float().cpu()).sum()) + int(tuple(out[2:4]) != tuple(ref[2:4]))
    if img.shape != rimg.shape:
        return {**{n: math.inf for n in NAMES}, "masks_mismatch": float(mism + 1)}
    levels = (img - rimg).abs().amax(-1)  # [T, H, W]: the worst channel a pixel
    inside = levels[mask]
    nums = dict(
        masks_mismatch=float(mism),
        outside_max=float(levels[~mask].max()) / 255.0 if (~mask).any() else 0.0,
        share_off3=float((inside >= 3).float().mean()) if inside.numel() else 0.0,
        mean_levels=float(inside.mean()) if inside.numel() else 0.0,
    )
    if detail and inside.numel():
        per_frame = [levels[i][mask[i]] for i in range(levels.shape[0]) if mask[i].any()]
        nums.update(share_off2=float((inside >= 2).float().mean()),
                    share_off4=float((inside >= 4).float().mean()), max_levels=float(inside.max()),
                    frame_share_off3_max=max(float((f >= 3).float().mean()) for f in per_frame),
                    frame_mean_max=max(float(f.mean()) for f in per_frame))
    return nums


def judge(readings: list, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value": worst reading, "limit": limit}}) over the
    clips compared, for each number the cell's limits name: the exact
    ones always, and the gap numbers that separate the cell's program
    from its control."""
    missing = {"masks_mismatch", "outside_max"} - set(limits)
    if missing:
        raise ValueError(f"limits lack the exact comparisons {sorted(missing)}")
    checks = {}
    for name, limit in limits.items():
        checks[name] = {"value": max(r[name] for r in readings), "limit": limit}
    ok = bool(readings) and all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
