"""Recurrent flow completion network.

Port of the JAX package's `models/flow_completion.py`: the P3D encoder
and mid dilation as NDHWC convs, the second-order bidirectional
propagation as a Python loop over frames with a (prev1, prev2) carry,
and the second-order deformable alignment on the deform-conv kernel
(ops/cuda/deform_conv.py). Zero-padded chunks carry their real lengths
(`t_valid`, an int or a [B] tensor: the clip-parallel stage's): the
encoder re-zeroes the padding before each temporal conv and the backward
propagation restarts at the last real frame, so real frames are exact.

Memory plans. Each is exact in the computation it chunks (per-frame
pure, or covered by a halo; a conv may take another algorithm for
another batch size, so values agree within fp32 rounding), and each
engages when the largest activation of the unchunked form, estimated
from the shapes, passes its budget (bytes, sized for an 80 GB card):
  * both temporal directions of `forward_bidirect_flow` in one batched
    call; in turn past BATCH_BYTES (`directions_in_turn`);
  * the encoder on the whole clip; past ENCODE_BYTES in temporal chunks
    of CHUNK_T frames with a HALO_T-frame halo (`_encode_chunked`: the
    four dilated-2 temporal convs see +-8 frames);
  * each encoder call in full rows; past SLAB_BYTES in row slabs with a
    2-row halo at 1/8 (`_slab_plan`, `_encode_slabbed`);
  * the mid dilation on every frame at once; past MID_BYTES in chunks of
    CHUNK_T frames;
  * the decoder in calls that keep one full-res activation within
    DECODE_BYTES (72 frames in bf16 at 1280x720, 32 at 1920x1080).
The budgets keep the fastest form that fits, measured with the plans'
bring-up (CHANGES.md) on path H's 85-pair chunk at 1920x1080 in bf16 (NVIDIA H100
80GB HBM3, 700.00 W; peak above the inputs, median of 3 calls):

  directions  encoder          rows   peak GiB  seconds
  batched     whole            full     38.75    1.116   (path H)
  batched     whole            slabs    35.72    1.186
  batched     temporal chunks  full     35.72    1.424
  in turn     whole            full     31.04    1.198
  in turn     temporal chunks  full     31.04    1.489

So every path up to 1080p on an 80 GB card takes the first row (the
encoder's halo doubles its work in temporal chunks, for 3 GiB); the gates
try, in this order, the directions in turn, temporal chunks, slabs and
mid chunks only where a chunk's estimate passes its budget: above
1920x1080, or for chunks of more than about 115 pairs there.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

from ..ops.conv import leaky_relu, pconv2d, pconv3d
from ..ops.cuda.deform_conv import deform_conv2d
from ..ops.resize import resize_bilinear

Params = Mapping[str, torch.Tensor]

CHANNEL = 128
DEFORM_GROUPS = 16
# budgets of the memory plans, in bytes of the unchunked form's largest
# activation (see the module docstring)
DECODE_BYTES = 4 << 30  # one decoder call's full-res 32-channel activation
ENCODE_BYTES = 8 << 30  # the encoder's half-res 32-channel activation of the clip
SLAB_BYTES = 8 << 30  # the same for one encoder call (the clip or a temporal chunk)
MID_BYTES = 2 << 30  # the mid dilation's 1/8-res 128-channel activation
BATCH_BYTES = 16 << 30  # what both directions in one call hold (`directions_in_turn`)
CHUNK_T = 16  # frames a temporal chunk of the encoder, and of the mid dilation
HALO_T = 8  # the encoder's temporal receptive field: four dilated-2 convs


def _valid_tmask(t: int, t_valid, dtype, device):
    """Mask of real frames: [1, T] for a count (an int), [B, T] for a [B]
    tensor of counts (clip-parallel chunks)."""
    tv = torch.as_tensor(t_valid, device=device)
    ar = torch.arange(t, device=device)
    m = ar[None] < (tv[:, None] if tv.ndim else tv)
    return m.to(dtype)


def _p3d(p: Params, pre: str, x, stride: int, t_valid=None):
    """P3DBlock: (1,3,3) spatial conv + LeakyReLU, then a (3,1,1)
    dilated-2 temporal conv. With t_valid, frames past the real ones are
    zeroed before the temporal conv: the spatial conv's bias makes zero
    padding nonzero, and zeroing restores the temporal conv's own zero
    padding for the real frames, exactly."""
    y = pconv3d(p, pre + ".conv1.0", x, stride=(1, stride, stride), padding=(0, 1, 1))
    y = leaky_relu(y, 0.2)
    if t_valid is not None:
        y = y * _valid_tmask(y.shape[1], t_valid, y.dtype, y.device)[:, :, None, None, None]
    return pconv3d(p, pre + ".conv2.0", y, padding=(2, 0, 0), dilation=(2, 1, 1))


def _deconv(p: Params, pre: str, x):
    """2x bilinear (align_corners=True) + 3x3 conv."""
    n, h, w, c = x.shape
    x = resize_bilinear(x, 2 * h, 2 * w, align_corners=True)
    return pconv2d(p, pre + ".conv", x, padding=(1, 1))


def _second_order_align(p: Params, pre: str, x, extra_feat):
    """SecondOrderDeformableAlignment: x [N,H,W,2C], extra_feat [N,H,W,3C]."""
    n, h, w, _ = x.shape
    o = leaky_relu(pconv2d(p, pre + ".conv_offset.0", extra_feat, padding=(1, 1)), 0.1)
    o = leaky_relu(pconv2d(p, pre + ".conv_offset.2", o, padding=(1, 1)), 0.1)
    o = leaky_relu(pconv2d(p, pre + ".conv_offset.4", o, padding=(1, 1)), 0.1)
    o = pconv2d(p, pre + ".conv_offset.6", o, padding=(1, 1))  # 27*G

    g9 = DEFORM_GROUPS * 9
    o1, o2, mask = o[..., :g9], o[..., g9 : 2 * g9], o[..., 2 * g9 :]
    offset = 5.0 * torch.tanh(torch.cat([o1, o2], dim=-1))
    # torchvision channel layout: (dy, dx) pairs per (group, tap)
    offset = offset.reshape(n, h, w, DEFORM_GROUPS, 9, 2)
    mask = torch.sigmoid(mask).reshape(n, h, w, DEFORM_GROUPS, 9)
    return deform_conv2d(
        x.contiguous(), offset.contiguous(), mask.contiguous(),
        p[pre + ".weight"], p[pre + ".bias"], padding=1,
    )


def _propagate_direction(p: Params, module: str, x_seq, extra_seq, first_index=0):
    """One direction of the second-order propagation. x_seq [T, N, H, W, C]
    in propagation order; extra_seq (forward pass) the other direction's
    features. first_index: the step where propagation (re)starts, an int
    or a [N] tensor (each batch row its own); steps before it are padding
    (zeros for an int; for a tensor they run, their values unused)."""
    t, n, h, w, c = x_seq.shape
    da = f"feat_prop_module.deform_align.{module}"
    bb = f"feat_prop_module.backbone.{module}"
    zeros = x_seq.new_zeros((n, h, w, c))
    per_row = first_index if isinstance(first_index, torch.Tensor) and first_index.ndim == 1 else None
    first = 0 if per_row is not None else int(first_index)
    # each step's restart flags [T, N], made once: the loop copies nothing to the card
    restarts = None if per_row is None else torch.arange(t, device=x_seq.device)[:, None] == per_row.to(x_seq.device)[None]
    prev1, prev2 = zeros, zeros
    outs = []
    for i in range(t):
        if i < first:
            outs.append(zeros)
            continue
        feat_current = x_seq[i]
        restart = None
        if i == first:
            # the reference skips alignment on the first frame
            feat_prop = zeros
        else:
            cond = torch.cat([prev1, feat_current, prev2], dim=-1)
            feat_prop = _second_order_align(p, da, torch.cat([prev1, prev2], dim=-1), cond)
            if per_row is not None:
                restart = restarts[i].reshape(n, 1, 1, 1)
                feat_prop = torch.where(restart, zeros, feat_prop)
        parts = [feat_current] + ([extra_seq[i]] if extra_seq is not None else []) + [feat_prop]
        y = leaky_relu(pconv2d(p, bb + ".0", torch.cat(parts, dim=-1), padding=(1, 1)), 0.1)
        out = feat_prop + pconv2d(p, bb + ".2", y, padding=(1, 1))
        if i == first:
            prev2 = zeros
        else:
            prev2 = prev1 if restart is None else torch.where(restart, zeros, prev1)
        prev1 = out
        outs.append(out)
    return torch.stack(outs)


def _bidirectional_propagation(p: Params, x, t_valid=None):
    """x: [N, T, H, W, C] -> [N, T, H, W, C]. With t_valid (the real
    leading frames, an int or a [N] tensor) the backward pass restarts at
    the last real frame."""
    x_t = x.movedim(1, 0)
    bwd_first = 0 if t_valid is None else x.shape[1] - t_valid
    bwd = _propagate_direction(p, "backward_", x_t.flip(0), None, bwd_first).flip(0)
    fwd = _propagate_direction(p, "forward_", x_t, bwd)
    fused = torch.cat([bwd, fwd], dim=-1)
    t, n, h, w, c2 = fused.shape
    out = pconv2d(p, "feat_prop_module.fusion", fused.reshape(t * n, h, w, c2))
    return out.reshape(t, n, h, w, c2 // 2).movedim(0, 1) + x


def _encode_core(p: Params, xp, t_valid=None):
    """The encoder on an input already edge-padded by 2 in H and W:
    [B,T,H+4,W+4,3] -> (e1 [B,T,H/4,W/4,64], e2 [B,T,H/8,W/8,128])."""
    x = leaky_relu(pconv3d(p, "downsample.0", xp, stride=(1, 2, 2)), 0.2)
    e1 = leaky_relu(_p3d(p, "encoder1.0", x, 1, t_valid), 0.2)
    e1 = leaky_relu(_p3d(p, "encoder1.2", e1, 2, t_valid), 0.2)
    e2 = leaky_relu(_p3d(p, "encoder2.0", e1, 1, t_valid), 0.2)
    e2 = leaky_relu(_p3d(p, "encoder2.2", e2, 2, t_valid), 0.2)
    return e1, e2


def _edge_pad(inputs):
    """The (1,5,5) stride-2 downsample conv's replicate padding of 2."""
    b, t, h, w, c = inputs.shape
    xp = F.pad(inputs.reshape(b * t, h, w, c).permute(0, 3, 1, 2), (2, 2, 2, 2), mode="replicate")
    return xp.permute(0, 2, 3, 1).reshape(b, t, h + 4, w + 4, c)


def _half_res_bytes(shape, esz: int) -> int:
    """The encoder's largest activation: [B, T, H/2, W/2, 32]."""
    b, t, h, w, _ = shape
    return b * t * (h // 2) * (w // 2) * 32 * esz


def _slab_plan(h8: int, nb: int):
    """Row slabs of nb rows at 1/8 (the JAX package's `_slab_plan`):
    (start, length, keep8, keep4, rows) per slab, start and length in
    rows of the edge-padded input (h_xe = 8 h8 + 4 rows), every start a
    multiple of 8 so that slab-local 1/2, 1/4 and 1/8 rows align with
    the global ones, with a halo of 2 rows at 1/8 (16 input rows) that
    covers the encoder's receptive field; keep8 / keep4 are the first
    kept rows at 1/8 and 1/4. The first and last slabs end at the frame
    edges, where the convs' own padding is the global one. nb must be at
    least 2: a slab of fewer rows would not advance past its halo."""
    if nb < 2:
        raise ValueError(f"_slab_plan: a slab holds at least 2 rows at 1/8, got {nb}")
    plan = []
    a = 0
    h_xe = 8 * h8 + 4
    while a < h8:
        nb_i = min(nb, h8 - a)
        if a == 0:
            s, length, k8, k4 = 0, 8 * nb_i + 16, 0, 0
        else:
            s = 8 * (a - 2)
            length = (h_xe - s) if a + nb_i == h8 else 8 * (nb_i + 4)
            k8, k4 = 2, 4
        plan.append((s, min(length, h_xe - s), k8, k4, nb_i))
        a += nb_i
    return plan


def _encode_slabbed(p: Params, inputs, nb: int, t_valid=None):
    """The encoder in row slabs of nb rows at 1/8 (`_slab_plan`): the
    input is edge-padded once and each slab sliced from it."""
    h8 = inputs.shape[2] // 8
    xe = _edge_pad(inputs)
    e1s, e2s = [], []
    for s, length, k8, k4, nb_i in _slab_plan(h8, nb):
        e1c, e2c = _encode_core(p, xe[:, :, s : s + length], t_valid)
        e1s.append(e1c[:, :, k4 : k4 + 2 * nb_i])
        e2s.append(e2c[:, :, k8 : k8 + nb_i])
    return torch.cat(e1s, dim=2), torch.cat(e2s, dim=2)


def _slab_rows(shape, esz: int) -> int | None:
    """Rows at 1/8 of one slab of an encoder call on `shape`, or None when
    its half-res activation is within SLAB_BYTES: a slab of nb rows holds
    4 nb + 16 rows at 1/2 with its halo."""
    if _half_res_bytes(shape, esz) <= SLAB_BYTES:
        return None
    b, t, h, w, _ = shape
    rows2 = SLAB_BYTES / (b * t * (w // 2) * 32 * esz)
    return max(2, min(h // 8, int((rows2 - 16) // 4)))


def _encode_call(p: Params, inputs, t_valid=None):
    """One encoder call, in row slabs past SLAB_BYTES."""
    nb = _slab_rows(inputs.shape, inputs.element_size())
    if nb is not None:
        return _encode_slabbed(p, inputs, nb, t_valid)
    return _encode_core(p, _edge_pad(inputs), t_valid)


def _encode_chunked(p: Params, inputs, t_valid=None):
    """The encoder over temporal chunks of CHUNK_T frames, each encoded
    with up to HALO_T real frames on either side, [s - 8, e + 8) clamped
    to the clip: a kept frame sees the same taps as in the whole clip,
    and at the clip's ends the temporal convs' own zero padding is the
    whole clip's. t_valid (the clip's real frames) carries into each
    chunk's own frames."""
    t = inputs.shape[1]
    e1s, e2s = [], []
    for s in range(0, t, CHUNK_T):
        e = min(t, s + CHUNK_T)
        lo, hi = max(0, s - HALO_T), min(t, e + HALO_T)
        tv = None if t_valid is None else (torch.as_tensor(t_valid) - lo).clamp(0, hi - lo)
        e1c, e2c = _encode_call(p, inputs[:, lo:hi], tv)
        e1s.append(e1c[:, s - lo : e - lo])
        e2s.append(e2c[:, s - lo : e - lo])
    return torch.cat(e1s, dim=1), torch.cat(e2s, dim=1)


def _encode(p: Params, inputs, t_valid=None):
    """[B,T,H,W,3] -> (e1 [B,T,H/4,W/4,64], e2 [B,T,H/8,W/8,128]): on
    the whole clip, or in temporal chunks past ENCODE_BYTES."""
    if _half_res_bytes(inputs.shape, inputs.element_size()) > ENCODE_BYTES:
        return _encode_chunked(p, inputs, t_valid)
    return _encode_call(p, inputs, t_valid)


def _mid_body(p: Params, e2):
    mid = leaky_relu(pconv3d(p, "mid_dilation.0", e2, padding=(0, 3, 3), dilation=(1, 3, 3)), 0.2)
    mid = leaky_relu(pconv3d(p, "mid_dilation.2", mid, padding=(0, 2, 2), dilation=(1, 2, 2)), 0.2)
    return leaky_relu(pconv3d(p, "mid_dilation.4", mid, padding=(0, 1, 1)), 0.2)


def _mid(p: Params, e2):
    """Three dilated spatial convs at 1/8 res, per-frame pure: in chunks
    of CHUNK_T frames past MID_BYTES."""
    if e2.numel() * e2.element_size() <= MID_BYTES:
        return _mid_body(p, e2)
    return torch.cat([_mid_body(p, e2[:, s : s + CHUNK_T]) for s in range(0, e2.shape[1], CHUNK_T)], dim=1)


def _decode(p: Params, prop2, e1_2):
    """prop2 [BT, H/8, W/8, 128], e1_2 [BT, H/4, W/4, 64] -> [BT, H, W, 2]."""
    d2 = leaky_relu(pconv2d(p, "decoder2.0", prop2, padding=(1, 1)), 0.2)
    d2 = leaky_relu(_deconv(p, "decoder2.2", d2), 0.2)
    d2 = d2 + e1_2
    d1 = leaky_relu(pconv2d(p, "decoder1.0", d2, padding=(1, 1)), 0.2)
    d1 = leaky_relu(_deconv(p, "decoder1.2", d1), 0.2)
    up = leaky_relu(pconv2d(p, "upsample.0", d1, padding=(1, 1)), 0.2)
    return _deconv(p, "upsample.2", up)


def flow_complete_forward(p: Params, masked_flows, masks, t_valid=None):
    """masked_flows [B,T,H,W,2], masks [B,T,H,W,1] -> completed [B,T,H,W,2].
    t_valid: the count of real leading frames where T is zero-padded at
    the end (an int, or a [B] tensor); real frames' results are exact."""
    b, t, h, w, _ = masked_flows.shape
    inputs = torch.cat([masked_flows, masks], dim=-1)
    e1, e2 = _encode(p, inputs, t_valid)
    prop = _bidirectional_propagation(p, _mid(p, e2), t_valid).reshape(b * t, h // 8, w // 8, CHANNEL)
    e1 = e1.reshape(b * t, h // 4, w // 4, 64)
    chunk = max(1, DECODE_BYTES // (h * w * 32 * prop.element_size()))
    flow = [_decode(p, prop[i : i + chunk], e1[i : i + chunk]) for i in range(0, b * t, chunk)]
    return (flow[0] if len(flow) == 1 else torch.cat(flow)).reshape(b, t, h, w, 2)


def directions_in_turn(shape, dtype) -> bool:
    """Whether `forward_bidirect_flow` completes the two directions in
    turn for flows of `shape` [B, T, H, W, 2]: what the batched call holds
    through its propagation, per frame of its batch 18 H W values (e1 at
    1/4 with 64 channels; the mid features, both propagation directions,
    the fusion's 256 channels and its output at 1/8), passes BATCH_BYTES."""
    b, t, h, w, _ = shape
    return 2 * b * t * h * w * 18 * dtype.itemsize > BATCH_BYTES


def completion_plan(shape, dtype) -> dict:
    """The forms `forward_bidirect_flow` takes for flows of `shape`
    [B, T, H, W, 2] in `dtype`, by the gates above: the directions, the
    encoder (whole or temporal chunks; the rows of a slab, or None), the
    mid dilation and the frames of a decoder call."""
    b, t, h, w, _ = shape
    esz = dtype.itemsize
    in_turn = directions_in_turn(shape, dtype)
    call = (b if in_turn else 2 * b, t, h, w, 3)
    chunked = _half_res_bytes(call, esz) > ENCODE_BYTES
    encoder_call = (call[0], min(t, CHUNK_T + 2 * HALO_T)) + call[2:] if chunked else call
    return dict(
        directions="in turn" if in_turn else "batched",
        encoder="temporal chunks" if chunked else "whole",
        slab_rows=_slab_rows(encoder_call, esz),
        mid="chunks" if call[0] * t * (h // 8) * (w // 8) * CHANNEL * esz > MID_BYTES else "whole",
        decoder_frames=max(1, DECODE_BYTES // (h * w * 32 * esz)),
    )


def _prefix_flip(t: int, t_valid, device):
    """Time flip of the real prefix of each clip, the padding left at the
    end: a function of [B, T, ...] tensors, for t_valid None (the whole
    clip), an int or a [B] tensor."""
    if t_valid is None:
        return lambda a: a.flip(1)
    tv = torch.as_tensor(t_valid, device=device)
    ar = torch.arange(t, device=device)
    if tv.ndim == 0:
        idx = torch.where(ar < tv, tv - 1 - ar, ar)
        return lambda a: a.index_select(1, idx)
    idx = torch.where(ar[None] < tv[:, None], tv[:, None] - 1 - ar[None], ar[None])  # [B, T]
    return lambda a: torch.take_along_dim(a, idx.reshape(idx.shape + (1,) * (a.ndim - 2)), dim=1)


def forward_bidirect_flow(p: Params, flows_f, flows_b, masks, t_valid=None):
    """Complete both directions, the backward stream time-flipped: in one
    batched call, or in turn past BATCH_BYTES (the JAX package's high-res
    form; the network has no coupling across its batch).
    flows_* [B, T-1, H, W, 2]; masks [B, T, H, W, 1]. t_valid: the count
    of real flows where T-1 is zero-padded at the end, an int or a [B]
    tensor (clip-parallel chunks); the backward stream flips only the
    real prefix, so the padding stays at the end."""
    masks_fwd = masks[:, :-1]
    masks_bwd = masks[:, 1:]
    mf = flows_f * (1 - masks_fwd)
    mb = flows_b * (1 - masks_bwd)
    flip = _prefix_flip(flows_f.shape[1], t_valid, flows_f.device)
    if directions_in_turn(flows_f.shape, flows_f.dtype):
        pf = flow_complete_forward(p, mf, masks_fwd, t_valid)
        return pf, flip(flow_complete_forward(p, flip(mb), flip(masks_bwd), t_valid))
    tv2 = t_valid
    if isinstance(t_valid, torch.Tensor) and t_valid.ndim == 1:
        tv2 = torch.cat([t_valid, t_valid])
    pred = flow_complete_forward(
        p,
        torch.cat([mf, flip(mb)], dim=0),
        torch.cat([masks_fwd, flip(masks_bwd)], dim=0),
        tv2,
    )
    b = flows_f.shape[0]
    return pred[:b], flip(pred[b:])


def combine_flow(flows_f, flows_b, pred_f, pred_b, masks):
    """Keep observed flow outside the mask."""
    masks_fwd = masks[:, :-1]
    masks_bwd = masks[:, 1:]
    out_f = pred_f * masks_fwd + flows_f * (1 - masks_fwd)
    out_b = pred_b * masks_bwd + flows_b * (1 - masks_bwd)
    return out_f, out_b
