"""Image propagation's step wrapper (`ops/cuda/prop_fill.py`) on the CPU.

The wrapper's plain path is held bit for bit against the eager direction
the port ran before the kernel (`_eager_direction`, written out below
as `models/propainter.py::_prop_direction_image` had it: flips, a list
of steps and a stack), and `bidirectional_propagation_image` on it
against the JAX package's, at the 1e-4 of the output's largest
magnitude that `test_torch_generator.py::test_img_propagation` holds.
The kernel itself runs only on a card (`tests/test_torch_cuda.py`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_propainter_nodes_tpu.models import propainter as jpp
from comfyui_propainter_nodes_tpu_torch.models import propainter as tpp
from comfyui_propainter_nodes_tpu_torch.ops.cuda import prop_fill as pf
from comfyui_propainter_nodes_tpu_torch.ops.dilation import binarize
from comfyui_propainter_nodes_tpu_torch.ops.warp import flow_warp
from comfyui_propainter_nodes_tpu_torch.utils import profiling

torch.set_num_threads(1)


def _eager_direction(x_seq, mask_seq, flows_prop, flows_check, interpolation, first_index=0):
    """The eager direction the kernel replaced, [T, N, ...] in and out."""
    per_row = first_index if isinstance(first_index, torch.Tensor) and first_index.ndim == 1 else None
    first = 0 if per_row is not None else int(first_index)
    restarts = pf.first_flags(x_seq.shape[0], per_row, x_seq.device) if per_row is not None else None
    feats, masks = [], []
    for i in range(x_seq.shape[0]):
        if i < first:
            feats.append(torch.zeros_like(x_seq[i]))
            masks.append(torch.zeros_like(mask_seq[i]))
            continue
        if i == first:  # the first frame is kept
            feat_prop, mask_prop = x_seq[i], mask_seq[i]
            feats.append(feat_prop)
            masks.append(mask_prop)
            continue
        feat_current, mask_current = x_seq[i], mask_seq[i]
        flow_prop, flow_check = flows_prop[i - 1], flows_check[i - 1]
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
        if per_row is not None:
            restart = pf.row_flag(restarts[i], feat_prop)
            feat_prop = torch.where(restart, feat_current, feat_prop)
            mask_prop = torch.where(restart, mask_current, mask_prop)
        feats.append(feat_prop)
        masks.append(mask_prop)
    return torch.stack(feats), torch.stack(masks)


def clip_inputs(n, t, h, w, dtype, seed=0):
    """x [N, T, H, W, 3] (zero, with signs, inside the masks), binary masks
    with a moving box, flows [N, T-1, H, W, 2]: a smooth field of a few
    pixels, a quarter of it on half pixels (nearest's ties), a band far
    outside the frame."""
    g = torch.Generator().manual_seed(seed)
    mask = torch.zeros(n, t, h, w, 1, dtype=torch.float64)
    for i in range(n):
        for j in range(t):
            y0, x0 = (2 * i + j) % max(1, h // 2), (3 * j + i) % max(1, w // 2)
            mask[i, j, y0 : y0 + h // 2, x0 : x0 + w // 2] = 1.0
    x = (torch.rand(n, t, h, w, 3, generator=g, dtype=torch.float64) * 2 - 1) * (1 - mask)

    def flows():
        yy = torch.linspace(0, 3, h, dtype=torch.float64)[:, None]
        xx = torch.linspace(0, 3, w, dtype=torch.float64)[None, :]
        base = torch.stack([torch.sin(yy + xx), torch.cos(yy - xx)], -1) * 3
        f = base + torch.randn(n, t - 1, h, w, 2, generator=g, dtype=torch.float64)
        f[..., : h // 4, :, :] = torch.round(f[..., : h // 4, :, :] * 2) / 2
        f[..., -2:, :, 0] += 40.0
        return f

    return [a.to(dtype) for a in (x, mask, flows(), flows())]


def _tn(a):
    return a.movedim(1, 0)


def _per_row(n, t):
    return torch.tensor([(2 * i) % t for i in range(n)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("interpolation", ["nearest", "bilinear"])
@pytest.mark.parametrize("first", [0, 2, "per_row"])
@pytest.mark.parametrize("n", [1, 3])
@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "backward"])
def test_plain_path_is_the_eager_direction(dtype, interpolation, first, n, reverse):
    """The wrapper on CPU tensors, slots in place and the backward pass by
    reversed slots, equals the eager direction (on flipped copies going
    backward) bit for bit: odd 13 x 17 frames, 6 steps, an int first index
    or [N] per-row restarts."""
    t = 6
    x, mask, fp, fc = clip_inputs(n, t, 13, 17, dtype, seed=n)
    fi = _per_row(n, t) if first == "per_row" else first
    before = profiling.counters().get("prop_fill", 0)
    feats, masks = pf.prop_fill(x, mask, fp, fc, interpolation, fi, reverse=reverse)
    assert profiling.counters().get("prop_fill", 0) == before  # the CPU launches nothing
    seqs = [_tn(a) for a in (x, mask, fp, fc)]
    if reverse:
        seqs = [a.flip(0) for a in seqs]
    want_f, want_m = _eager_direction(*seqs, interpolation, fi)
    if reverse:
        want_f, want_m = want_f.flip(0), want_m.flip(0)
    assert feats.dtype == dtype and feats.is_contiguous()
    assert torch.equal(feats, _tn(want_f)) and torch.equal(masks, _tn(want_m))
    # signed zeros too
    assert torch.equal(torch.signbit(feats), torch.signbit(_tn(want_f)))


@pytest.mark.parametrize("interpolation", ["nearest", "bilinear"])
@pytest.mark.parametrize("tv", [None, [7, 4]], ids=["whole", "per_clip"])
def test_bidirectional_matches_jax(interpolation, tv):
    """`bidirectional_propagation_image` (no flips, no stack) against the
    JAX package's on the same inputs, fp32; per-clip real lengths compared
    on the real frames."""
    b = 1 if tv is None else len(tv)
    x, mask, ff, fb = clip_inputs(b, 7, 24, 40, torch.float32, seed=5)
    lengths = [7] * b if tv is None else tv
    for i, n in enumerate(lengths):
        x[i, n:], mask[i, n:], ff[i, n - 1 :], fb[i, n - 1 :] = 0, 0, 0, 0
    tvj = None if tv is None else jnp.asarray(tv)
    tvt = None if tv is None else torch.tensor(tv)
    ref = jpp.bidirectional_propagation_image(
        *(jnp.asarray(a.numpy()) for a in (x, ff, fb, mask)), interpolation, t_valid=tvj
    )
    out = tpp.bidirectional_propagation_image(x, ff, fb, mask, interpolation, t_valid=tvt)
    for o, r in zip(out, ref):
        r = np.asarray(r)
        for i, n in enumerate(lengths):
            scale = max(1.0, float(np.abs(r[i, :n]).max()))
            err = float(np.abs(o[i, :n].numpy() - r[i, :n]).max())
            assert err <= 1e-4 * scale, f"max abs err {err} > 1e-4 * {scale}"


def _bad(case):
    x, mask, fp, fc = clip_inputs(2, 4, 9, 11, torch.float32)
    kw = dict(interpolation="nearest", first_index=0)
    if case == "int_dtype":
        x, mask, fp, fc = (a.to(torch.int32) for a in (x, mask, fp, fc))
    elif case == "mixed_dtype":
        fp = fp.double()
    elif case == "float_first":
        kw["first_index"] = torch.tensor([0.0, 1.0])
    elif case == "mask_channels":
        mask = torch.cat([mask, mask], -1)
    elif case == "flow_steps":
        fc = fc[:, :2]
    elif case == "x_channels":
        x = x[..., :2]
    elif case == "per_row_rows":
        kw["first_index"] = torch.tensor([0, 1, 2])
    elif case == "negative_first":
        kw["first_index"] = -1
    elif case == "non_contiguous":
        x = x.transpose(2, 3).contiguous().transpose(2, 3)
    elif case == "interpolation":
        kw["interpolation"] = "bicubic"
    elif case == "device":
        x, mask, fp, fc = (a.to("meta") for a in (x, mask, fp, fc))
    elif case == "mixed_device":
        mask = mask.to("meta")
    return (x, mask, fp, fc), kw


@pytest.mark.parametrize("case", ["int_dtype", "mixed_dtype", "float_first", "mask_channels",
                                  "flow_steps", "x_channels", "per_row_rows", "negative_first", "non_contiguous",
                                  "interpolation", "device", "mixed_device"])
def test_check_refuses(case):
    """`_check` refuses wrong dtypes, shapes, devices, layouts and arguments
    on both entries, before any step."""
    args, kw = _bad(case)
    for fn in (pf.prop_fill, pf.prop_fill_plain):
        with pytest.raises(ValueError, match="prop_fill"):
            fn(*args, **kw)


@pytest.mark.parametrize("which", range(4))
def test_forward_only_raises_under_grad(which):
    """The kernel has no backward: an input that requires grad raises under
    grad mode and runs under no_grad."""
    args = clip_inputs(1, 3, 5, 7, torch.float32)
    args[which].requires_grad_(True)
    with pytest.raises(ValueError, match="prop_fill: the kernel has no backward"):
        pf.prop_fill(*args)
    with torch.no_grad():
        feats, masks = pf.prop_fill(*args)
    assert feats.shape == args[0].shape and masks.shape == args[1].shape
