"""Image propagation's warp-fill recurrence: a CUDA kernel a step (csrc/prop_fill.cu) + its plain version.

Replaces no TPU kernel: the JAX package leaves the step to XLA
(`models/propainter.py::_prop_direction_image`). One direction of
`models/propainter.py::bidirectional_propagation_image`:

  prop_fill(x, mask, flows_prop, flows_check, interpolation, first_index, reverse)
      x [N, T, H, W, 3], mask [N, T, H, W, 1], flows [N, T-1, H, W, 2]
      -> (feats [N, T, H, W, 3], masks [N, T, H, W, 1])

walks the slots in order (from the last with `reverse`), writing each
step's frame and mask into its slot of preallocated outputs: the step
at slot s reads the slot before it in the walk, p, and the flows at
min(s, p). `first_index` is the step where propagation (re)starts,
keeping the frame as it is: an int (the steps before it are zeros), or
an [N] tensor, each batch row its own (the steps before a row's run on
padding, their values unused), read from one [T, N] flag table.

`prop_step_plain` is the step as eager PyTorch (warp, forward-backward
check, fill); CPU tensors take it. CUDA tensors (fp32 or bf16) take the
kernel, one launch a step on the current stream, bit for bit the plain
step on the card (csrc/prop_fill.cu), counted as "prop_fill". Image
propagation never runs under grad: the kernel has no backward, and
`prop_fill` raises where a gradient is asked for.
"""

from __future__ import annotations

import torch

from ...utils.profiling import kernel
from ..dilation import binarize
from ..warp import flow_warp
from . import _build
from ._grad import forward_only

INTERPOLATIONS = ("nearest", "bilinear")


def prop_step_plain(feat_prop, mask_prop, feat_current, mask_current, flow_prop, flow_check, interpolation):
    """One warp-fill step [N, H, W, *]: the next (feat_prop, mask_prop)."""
    if interpolation == "bilinear":
        warped = flow_warp(torch.cat([flow_check, mask_prop, feat_prop], dim=-1), flow_prop)
        warped3, feat_warped = warped[..., :3], warped[..., 3:]
    else:
        warped3 = flow_warp(torch.cat([flow_check, mask_prop], dim=-1), flow_prop)
        feat_warped = flow_warp(feat_prop, flow_prop, interpolation)
    flow_bw_warped = warped3[..., :2]
    mask_prop_valid = binarize(warped3[..., 2:])
    diff = flow_prop + flow_bw_warped
    mag = torch.sum(flow_prop**2, -1, keepdim=True) + torch.sum(flow_bw_warped**2, -1, keepdim=True)
    valid = (torch.sum(diff**2, -1, keepdim=True) < 0.01 * mag + 0.5).to(flow_prop.dtype)
    union = binarize(mask_current * valid * (1 - mask_prop_valid))
    feat_prop = union * feat_warped + (1 - union) * feat_current
    mask_prop = binarize(mask_current * (1 - valid * (1 - mask_prop_valid)))
    return feat_prop, mask_prop


def first_flags(t: int, first_index, device):
    """[T, 1] or [T, B] bool: True at the step where propagation (re)starts
    (`first_index` an int, or a [B] tensor, each batch row its own)."""
    ar = torch.arange(t, device=device)
    if isinstance(first_index, torch.Tensor):
        return ar[:, None] == first_index.to(device)[None, :]
    return (ar == first_index)[:, None]


def row_flag(flag, like):
    """[B] or [1] flag -> broadcastable against [B, H, W, C]."""
    return flag.reshape(-1, 1, 1, 1).expand(like.shape[0], 1, 1, 1)


def _plain_launcher(x, mask, flows_prop, flows_check, feats, masks, interpolation):
    def step(s, p, f, restart):
        fp, mp = prop_step_plain(
            feats[:, p], masks[:, p], x[:, s], mask[:, s], flows_prop[:, f], flows_check[:, f], interpolation
        )
        if restart is not None:
            r = row_flag(restart, fp)
            fp, mp = torch.where(r, x[:, s], fp), torch.where(r, mask[:, s], mp)
        feats[:, s], masks[:, s] = fp, mp

    return step


def _kernel_launcher(x, mask, flows_prop, flows_check, feats, masks, interpolation):
    n, t, h, w, _ = x.shape
    fn = _build.library().propainter_prop_fill
    head = (x.data_ptr(), mask.data_ptr(), flows_prop.data_ptr(), flows_check.data_ptr(),
            feats.data_ptr(), masks.data_ptr())
    tail = (int(x.dtype == torch.bfloat16), int(interpolation == "nearest"),
            torch.cuda.current_stream(x.device).cuda_stream)

    def step(s, p, f, restart):
        with kernel("prop_fill"):
            status = fn(*head, None if restart is None else restart.data_ptr(), n, t, h, w, s, p, f, *tail)
            _build.check(status, "prop_fill")

    return step


def _check(x, mask, flows_prop, flows_check, interpolation, first_index):
    """Refuse what the step does not take; returns (per-row first indices
    [N] on x's device or None, the int first index)."""
    dev = x.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"prop_fill: unsupported device {dev}")
    if interpolation not in INTERPOLATIONS:
        raise ValueError(f"prop_fill: interpolation must be one of {INTERPOLATIONS}, got {interpolation!r}")
    if x.dim() != 5 or x.shape[-1] != 3 or x.shape[1] < 1:
        raise ValueError(f"prop_fill: x must be [N, T, H, W, 3], got {tuple(x.shape)}")
    n, t, h, w, _ = x.shape
    want = {"mask": (mask, (n, t, h, w, 1)), "flows_prop": (flows_prop, (n, t - 1, h, w, 2)),
            "flows_check": (flows_check, (n, t - 1, h, w, 2))}
    for name, (a, shape) in want.items():
        if tuple(a.shape) != shape:
            raise ValueError(f"prop_fill: {name} must be {list(shape)}, got {tuple(a.shape)}")
    tensors = (x, mask, flows_prop, flows_check)
    kinds = (torch.float32, torch.bfloat16) if dev.type == "cuda" else (torch.float32, torch.float64, torch.bfloat16)
    if x.dtype not in kinds or any(a.dtype != x.dtype for a in tensors):
        raise ValueError(f"prop_fill: inputs must share one of {kinds} on {dev.type}, got "
                         f"{[a.dtype for a in tensors]}")
    if any(a.device != dev for a in tensors):
        raise ValueError(f"prop_fill: inputs must share x's device {dev}")
    if not all(a.is_contiguous() for a in tensors):
        raise ValueError("prop_fill: inputs must be contiguous")
    if dev.type == "cuda":
        align = 2 * x.element_size()  # a flow pair is one 4- or 8-byte load
        if flows_prop.data_ptr() % align or flows_check.data_ptr() % align:
            raise ValueError(f"prop_fill: flows must be {align}-byte aligned")
        if n > 65535:
            raise ValueError(f"prop_fill: at most 65535 batch rows, got {n}")
    if isinstance(first_index, torch.Tensor) and first_index.ndim == 1:
        if tuple(first_index.shape) != (n,) or first_index.is_floating_point():
            raise ValueError(f"prop_fill: per-row first indices must be [{n}] integers, got "
                             f"{tuple(first_index.shape)} {first_index.dtype}")
        return first_index.to(dev), 0
    first = int(first_index)
    if first < 0:
        raise ValueError(f"prop_fill: first_index must be >= 0, got {first}")
    return None, first


def _direction(launcher, x, mask, flows_prop, flows_check, interpolation, per_row, first, reverse):
    n, t = x.shape[:2]
    alloc = torch.zeros if first > 0 else torch.empty  # slots before the first stay zero
    feats = alloc(x.shape, dtype=x.dtype, device=x.device)
    masks = alloc(mask.shape, dtype=mask.dtype, device=mask.device)
    step = launcher(x, mask, flows_prop, flows_check, feats, masks, interpolation)
    # each step's restart flags [T, N], made once: the loop copies nothing to the card
    restarts = None if per_row is None else first_flags(t, per_row, x.device)
    slots = range(t - 1, -1, -1) if reverse else range(t)
    prev = None
    for k, s in enumerate(slots):
        if k < first:
            continue
        if k == first:  # the first frame is kept
            feats[:, s], masks[:, s] = x[:, s], mask[:, s]
        else:
            step(s, prev, min(s, prev), None if restarts is None else restarts[k])
        prev = s
    return feats, masks


def prop_fill_plain(x, mask, flows_prop, flows_check, interpolation="nearest", first_index=0, reverse=False):
    """One direction through `prop_step_plain`, on any device."""
    per_row, first = _check(x, mask, flows_prop, flows_check, interpolation, first_index)
    return _direction(_plain_launcher, x, mask, flows_prop, flows_check, interpolation, per_row, first, reverse)


def prop_fill(x, mask, flows_prop, flows_check, interpolation="nearest", first_index=0, reverse=False):
    """One direction of image propagation (the module's docstring): the
    kernel on CUDA tensors, `prop_step_plain` on CPU tensors."""
    per_row, first = _check(x, mask, flows_prop, flows_check, interpolation, first_index)
    forward_only("prop_fill", x, mask, flows_prop, flows_check)
    launcher = _kernel_launcher if x.device.type == "cuda" else _plain_launcher
    return _direction(launcher, x, mask, flows_prop, flows_check, interpolation, per_row, first, reverse)
