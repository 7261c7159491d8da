"""The one traffic generator: clips of a moving box over a gradient.

A traffic mix is a JSON file under `benchmark/traffic/` with:
  node      "inpaint" or "outpaint": which ComfyUI node each clip goes to;
  frames    frames a clip;
  box       [h_frac, w_frac]: the box's size as fractions of the frame;
  step_px   [dy, dx]: how far the box moves a frame, in pixels; the seed
            picks the signs;
  margin_px how far the box's path stays from the frame's edges;
  widgets   the node widgets the mix sets (outpaint: the canvas scales);
  supplied_hw  optional [height, width] at which the clips are handed
            to the node, which resizes them to the widgets' size; by
            default they come at the widgets' height and width;
  check_clips  how many of the window's clips the comparison samples.
Every clip has the same size, the same box and the same speed, so every
seed gives the same work; clip i of seed s takes its start and its
direction from a generator seeded with (s, i).
"""

from __future__ import annotations

import json

import numpy as np
import torch


def load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def size(mix: dict, widgets: dict) -> tuple[int, int]:
    """(height, width) of the frames the mix hands the node."""
    if "supplied_hw" in mix:
        h, w = mix["supplied_hw"]
        return int(h), int(w)
    return int(widgets["height"]), int(widgets["width"])


def _background(h: int, w: int) -> np.ndarray:
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([yy / h, xx / w, (yy + xx) / (h + w)], axis=-1).astype(np.float32)


def clip(mix: dict, h: int, w: int, seed: int, index: int):
    """Frames [T, h, w, 3] and masks [T, h, w], uint8, of clip `index`."""
    t = mix["frames"]
    bh, bw = int(h * mix["box"][0]), int(w * mix["box"][1])
    dy, dx = mix["step_px"]
    margin = mix["margin_px"]
    rng = np.random.default_rng([int(seed) % (1 << 63), index % (1 << 63), 7])
    sy, sx = rng.choice([-1, 1], size=2)
    ty, tx = dy * (t - 1), dx * (t - 1)
    # the top-left corner of the box's path, then its start on that path
    py = int(rng.integers(margin, h - margin - bh - ty + 1))
    px = int(rng.integers(margin, w - margin - bw - tx + 1))
    y0 = py if sy > 0 else py + ty
    x0 = px if sx > 0 else px + tx
    base = (_background(h, w) * 255).astype(np.uint8)
    frames = np.repeat(base[None], t, axis=0)
    masks = np.zeros((t, h, w), np.uint8)
    for i in range(t):
        y, x = y0 + sy * dy * i, x0 + sx * dx * i
        frames[i, y : y + bh, x : x + bw] = (255, 51, 51)
        masks[i, y : y + bh, x : x + bw] = 255
    return frames, masks


def comfy_inputs(frames: np.ndarray, masks: np.ndarray):
    """IMAGE [T, H, W, 3] and MASK [T, H, W] as ComfyUI hands them to a
    node: CPU float32 tensors in 0..1."""
    image = torch.from_numpy(frames).float().div_(255.0)
    mask = torch.from_numpy(masks).float().div_(255.0)
    return image, mask


def inputs(mix: dict, widgets: dict, seed: int, index: int):
    """Clip `index` of `seed` as ComfyUI hands it to the node, at the
    mix's supplied size."""
    h, w = size(mix, widgets)
    return comfy_inputs(*clip(mix, h, w, seed, index))
