"""ProPainter InpaintGenerator (inference, and the training step's forward).

Port of the JAX package's `models/propainter.py` (main path): the
encoder with grouped fusion, image propagation (warp-fill, no weights,
on the prop_fill kernel a step) and feature propagation (first-order
deformable alignment on the deform-conv kernel) as Python loops over
frames, soft split/comp around the 8-block sparse transformer
(ops/attention.py), and the decoder over local frames: full-frame, or
only a crop of it (`decoder_crop`).

Memory plans (per-frame pure, so exact): `encode_features` encodes as
many frames a call as keep its largest activation (1/4 res, 512
channels) within ENCODE_BYTES, and `decoder` decodes as many as keep
its full-res 64-channel activation within DECODE_BYTES. Every path up
to 1920x1080 runs each in one call on an 80 GB card (a streaming window
at 1080p encodes 19 frames, 2.5 GB, and decodes 11, 2.9 GB; the outpaint
node's group of 8 windows on its 768x360 canvas decodes 88, 3.1 GB).

Window batching pads each window's local and reference frame blocks;
`l_t_valid` / `ref_valid` give the real counts (None, an int, or a [B]
tensor per window). Callers zero the masks of padded slots; real-frame
outputs are exact. Image propagation takes real lengths too (`t_valid`,
an int or a [B] tensor): the clip-parallel stage batches padded chunks.
Under `parallel/sequence.py::sequence_sharding` the transformer runs
sequence-parallel over the mesh's model axis. Under
`parallel/spatial.py::spatial_sharding` the forward runs H-split over it:
`encode_features` returns, and `inpaint_generator_from_features` takes,
this rank's feature rows widened by PROP_HALO4 (the flows and masks stay
whole), each step of feature propagation gathers its map over H, and the
forward returns the rank's pixel rows (of the crop, with one). Under
`parallel/sharding.py::tensor_sharding` (the training step's) the
transformer runs tensor-parallel on the rank's shards. Every op is
differentiable: the kernels B2 and B3/B4/B5 take their gradients from
their plain versions (ops/cuda/_grad.py).

Spans (utils/profiling.py), one a call: "feature.encode"
(`encode_features`), and in `inpaint_generator_from_features`
"feature.propagate" (the deformable alignment, B2), "feature.transformer"
(soft split, the transformer blocks on B3/B4/B5, soft comp) and
"feature.decode".
"""

from __future__ import annotations

from typing import Mapping

import torch

from ..ops.attention import soft_comp, soft_split, transformer_stack
from ..ops.conv import leaky_relu, pconv2d
from ..ops.cuda.deform_conv import deform_conv2d
from ..ops.cuda.prop_fill import first_flags, prop_fill, row_flag
from ..ops.pool import max_pool2d
from ..ops.resize import resize_2x_window, resize_bilinear, resize_nearest
from ..ops.warp import flow_warp
from ..parallel.sequence import sequence_active, sequence_parallel_transformer
from ..parallel.sharding import tensor_active
from ..parallel.spatial import ENC_HALO4, PROP_HALO4, Partition, RowSplit, spatial_active, token_rows
from ..utils.profiling import span

Params = Mapping[str, torch.Tensor]

CHANNEL = 128
HIDDEN = 512
DEFORM_GROUPS = 16

_ENC_GROUPS = {10: 2, 12: 4, 14: 8, 16: 1}
# the largest activation of one call, in bytes: the encoder's at 1/4 res
# (512 channels), the decoder's at full res (64 channels)
ENCODE_BYTES = 4 << 30
DECODE_BYTES = 4 << 30


def _partition(h4: int) -> Partition:
    """The H split of a feature grid of h4 rows while `spatial_sharding`
    is active, else one rank's whole grids."""
    sp = spatial_active() or (None, None)
    return Partition(sp[0], sp[1], token_rows(h4))


def _frame_chunks(fn, x, frame_bytes: int, budget: int):
    """fn over x [N, ...] in calls of as many frames as keep
    frame_bytes a frame within budget."""
    step = max(1, budget // frame_bytes)
    if x.shape[0] <= step:
        return fn(x)
    return torch.cat([fn(x[i : i + step]) for i in range(0, x.shape[0], step)])


def encoder(p: Params, x):
    """Encoder: x [N, H, W, 5] -> [N, H/4, W/4, 128] with grouped fusion
    of the layer-7 activation."""
    out = x
    x0 = None
    for i in range(0, 18, 2):
        if i == 8:
            x0 = out
        if i > 8:
            g = _ENC_GROUPS[i]
            n, h, w, _ = out.shape
            xg = x0.reshape(n, h, w, g, -1)
            og = out.reshape(n, h, w, g, -1)
            out = torch.cat([xg, og], dim=-1).reshape(n, h, w, -1)
        stride = (2, 2) if i in (0, 4) else (1, 1)
        out = pconv2d(
            p, f"encoder.layers.{i}", out, stride=stride, padding=(1, 1),
            groups=_ENC_GROUPS.get(i, 1),
        )
        out = leaky_relu(out, 0.2)
    return out


def decoder(p: Params, x):
    """Two 2x (bilinear, align_corners=True) deconvs back to full res, 3ch:
    [N, h4, w4, 128] -> [N, 4 h4, 4 w4, 3], in frame chunks past
    DECODE_BYTES."""
    n, h4, w4, _ = x.shape
    return _frame_chunks(lambda v: _decoder_body(p, v), x, 16 * h4 * w4 * 64 * x.element_size(), DECODE_BYTES)


def _decode_window(p: Params, v, sy: int, sx: int, h4: int, w4: int):
    """The decoder on the block v of feature rows [sy, ..) and columns [sx,
    ..) of a full [h4, w4] map, both 2x upsamples on the full image's grid
    (`resize_2x_window`): full-res rows [4 sy, ..) and columns [4 sx, ..);
    where the block stops inside the frame, its edge rows and columns are
    for the caller's halo to trim."""
    v = resize_2x_window(v, sy, sx, h4, w4)
    v = leaky_relu(pconv2d(p, "decoder.0.conv", v, padding=(1, 1)), 0.2)
    v = leaky_relu(pconv2d(p, "decoder.2", v, padding=(1, 1)), 0.2)
    v = resize_2x_window(v, 2 * sy, 2 * sx, 2 * h4, 2 * w4)
    v = leaky_relu(pconv2d(p, "decoder.4.conv", v, padding=(1, 1)), 0.2)
    return pconv2d(p, "decoder.6", v, padding=(1, 1))


def _decoder_body(p: Params, x):
    """The decoder on one call's frames."""

    def deconv(pre, v):
        n, h, w, _ = v.shape
        v = resize_bilinear(v, 2 * h, 2 * w, align_corners=True)
        return pconv2d(p, pre + ".conv", v, padding=(1, 1))

    x = leaky_relu(deconv("decoder.0", x), 0.2)
    x = leaky_relu(pconv2d(p, "decoder.2", x, padding=(1, 1)), 0.2)
    x = leaky_relu(deconv("decoder.4", x), 0.2)
    return pconv2d(p, "decoder.6", x, padding=(1, 1))


DECODER_HALO4 = 4  # 1/4-res halo rows/cols covering the decoder's
# receptive field (convs +-3.25 at 1/4 incl. the two 2x resizes)


def decoder_crop(p: Params, x, y0: int, x0: int, ch: int, cw: int):
    """`decoder` restricted to the full-res crop [y0:y0+ch, x0:x0+cw) of the
    full [N, h4, w4, 128] quarter-res features x; y0/x0 any full-res
    offsets (the crop need not be aligned). Exact (`decode_rows`)."""
    n, h4, w4, _ = x.shape
    return decode_rows(p, x, 0, h4, w4, y0, y0 + ch, x0, x0 + cw)


def decode_rows(p: Params, x, start: int, h4: int, w4: int, r0: int, r1: int, c0: int, c1: int):
    """The decoder's full-res rows [r0, r1) and columns [c0, c1) from x
    [N, n, w4, 128], feature rows [start, start + n) of a full [h4, w4]
    map that reach DECODER_HALO4 rows past the rows' own (or the frame's
    edge): a crop, or the H split's decode of a rank's rows, full width or
    of a crop. Exact: a block with DECODER_HALO4 rows and columns of halo,
    clamped to x's rows and the frame, goes through the decoder with both
    2x upsamples on the full image's grid (`resize_2x_window`); the halo,
    which takes the conv padding and the resizes' edge rows, is trimmed at
    full res. In frame chunks past DECODE_BYTES."""
    n = x.shape[0]
    if r0 >= r1:
        return x.new_zeros((n, 0, c1 - c0, 3))
    halo = DECODER_HALO4
    sy, ey = max(start, r0 // 4 - halo), min(start + x.shape[1], -(-r1 // 4) + halo)
    sx, ex = max(0, c0 // 4 - halo), min(w4, -(-c1 // 4) + halo)
    block = x[:, sy - start : ey - start, sx:ex]
    frame_bytes = 16 * (ey - sy) * (ex - sx) * 64 * x.element_size()
    v = _frame_chunks(lambda u: _decode_window(p, u, sy, sx, h4, w4), block, frame_bytes, DECODE_BYTES)
    return v[:, r0 - 4 * sy : r1 - 4 * sy, c0 - 4 * sx : c1 - 4 * sx]


def _deformable_alignment(p: Params, pre: str, x, cond, flow, row0: int = 0):
    """First-order alignment: offsets are 3*tanh residuals on the flow.
    x [N,H,W,C] whole; cond [N,Ho,W,2C+5] and flow [N,Ho,W,2] (dx, dy) at
    rows [row0, row0 + Ho) of it (all of them by default)."""
    n, h, w, _ = cond.shape
    o = leaky_relu(pconv2d(p, pre + ".conv_offset.0", cond, padding=(1, 1)), 0.1)
    o = leaky_relu(pconv2d(p, pre + ".conv_offset.2", o, padding=(1, 1)), 0.1)
    o = leaky_relu(pconv2d(p, pre + ".conv_offset.4", o, padding=(1, 1)), 0.1)
    o = pconv2d(p, pre + ".conv_offset.6", o, padding=(1, 1))
    g9 = DEFORM_GROUPS * 9
    o1, o2, mask = o[..., :g9], o[..., g9 : 2 * g9], o[..., 2 * g9 :]
    offset = 3.0 * torch.tanh(torch.cat([o1, o2], dim=-1)).reshape(n, h, w, DEFORM_GROUPS, 9, 2)
    # the reference adds flow.flip(1) to every pair: (dy, dx) += (fy, fx)
    flow_yx = torch.stack([flow[..., 1], flow[..., 0]], dim=-1)
    offset = offset + flow_yx[:, :, :, None, None, :]
    mask = torch.sigmoid(mask).reshape(n, h, w, DEFORM_GROUPS, 9)
    return deform_conv2d(
        x.contiguous(), offset.contiguous(), mask.contiguous(),
        p[pre + ".weight"], p[pre + ".bias"], row0=row0,
    )


def _align_flows(flows):
    """[T-1, ...] -> [T, ...]: step i consumes flows[i-1]; slot 0 is a dummy."""
    return torch.cat([torch.zeros_like(flows[:1]), flows], dim=0)


def _prop_step(p, module, feat_prop, feat_current, mask_current, flow_prop, flow_check, first, row0: int = 0):
    """One step of a learnable direction: the next feat_prop at rows [row0,
    row0 + Ho) of the feature grid, from the previous one (whole), and
    the frame's features, mask and flow at those rows (flow_check whole:
    it is warped with feat_prop)."""
    da = f"feat_prop_module.deform_align.{module}"
    bb = f"feat_prop_module.backbone.{module}"
    warped = flow_warp(torch.cat([flow_check, feat_prop], dim=-1), flow_prop, row0=row0)
    flow_bw_warped, feat_warped = warped[..., :2], warped[..., 2:]
    diff = flow_prop + flow_bw_warped
    mag = torch.sum(flow_prop**2, -1, keepdim=True) + torch.sum(flow_bw_warped**2, -1, keepdim=True)
    valid = (torch.sum(diff**2, -1, keepdim=True) < 0.01 * mag + 0.5).to(feat_prop.dtype)
    cond = torch.cat([feat_current, feat_warped, flow_prop, valid, mask_current], dim=-1)
    aligned = _deformable_alignment(p, da, feat_prop, cond, flow_prop, row0)
    out = torch.where(row_flag(first, feat_current), feat_current, aligned)
    y = leaky_relu(
        pconv2d(p, bb + ".0", torch.cat([feat_current, out, mask_current], dim=-1), padding=(1, 1)),
        0.2,
    )
    return out + pconv2d(p, bb + ".2", y, padding=(1, 1))


def _prop_direction_feature(p, module, x_seq, mask_seq, flows_prop, flows_check, first_index=0, feat=None):
    """Learnable direction: deform-aligned. mask_seq is the 2-channel
    prop mask (mask_in ++ mask_updated).

    feat: the feature grid's `RowSplit` under the H split (the whole grid
    by default). x_seq and mask_seq hold this rank's rows widened by
    PROP_HALO4 (the flows are whole); each step computes the rank's rows,
    all-gathers them into the whole map the next step warps, and returns
    the widened rows of the gathered map."""
    t = x_seq.shape[0]
    fp_all = _align_flows(flows_prop)
    fc_all = _align_flows(flows_check)
    firsts = first_flags(t, first_index, x_seq.device)
    if feat is None:
        feat = RowSplit.whole(x_seq.shape[2])
    a, b = feat.widened(PROP_HALO4)
    n, _, w, c = x_seq[0].shape
    feat_prop = x_seq.new_zeros((n, feat.total, w, c))
    outs = []
    for i in range(t):
        mine = x_seq[i]  # a rank without rows only gathers
        if a < b:
            new = _prop_step(p, module, feat_prop, x_seq[i], mask_seq[i], fp_all[i][:, a:b], fc_all[i], firsts[i], a)
            mine = new[:, feat.lo - a : feat.hi - a]
        feat_prop = feat.gather(mine, 1)
        outs.append(feat_prop[:, a:b])
    return torch.stack(outs)


def bidirectional_propagation_image(x, flows_f, flows_b, mask, interpolation="nearest", t_valid=None):
    """x [B,T,H,W,3]; flows [B,T-1,H,W,2]; mask [B,T,H,W,1] ->
    (prop_frames, updated_masks) [B,T,H,W,*].

    One `prop_fill` a direction (on CUDA one kernel launch a step): the
    backward pass walks the slots from the last frame, so nothing is
    flipped or stacked. t_valid: the count of real leading frames where T
    is zero-padded at the end, an int or a [B] tensor (clip-parallel
    chunks); real frames' results are exact: the backward pass, which
    meets the padding first, restarts at the last real frame."""
    x, flows_f, flows_b, mask = (a.contiguous() for a in (x, flows_f, flows_b, mask))
    bwd_first = 0 if t_valid is None else x.shape[1] - t_valid
    feats_b, masks_b = prop_fill(x, mask, flows_f, flows_b, interpolation, bwd_first, reverse=True)
    return prop_fill(feats_b, masks_b, flows_b, flows_f, interpolation)


def bidirectional_propagation_feature(p: Params, x, flows_f, flows_b, mask, t_valid=None, feat=None):
    """x [B,T,H,W,128]; mask [B,T,H,W,2] -> [B,T,H,W,128]. feat: the H
    split's feature `RowSplit`, the whole grid by default (x and mask at
    the rank's rows widened by PROP_HALO4, flows whole; returns the
    rank's rows)."""
    b, t, h, w, c = x.shape
    if feat is None:
        feat = RowSplit.whole(h)
    xs, ms = x.movedim(1, 0), mask.movedim(1, 0)
    ff, fb = flows_f.movedim(1, 0), flows_b.movedim(1, 0)
    # padded frames sit at the end, so the backward pass restarts at the
    # first real frame
    bwd_first = 0 if t_valid is None else t - t_valid
    feats_b = _prop_direction_feature(
        p, "backward_1", xs.flip(0), ms.flip(0), ff.flip(0), fb.flip(0), bwd_first, feat
    ).flip(0)
    feats_f = _prop_direction_feature(p, "forward_1", feats_b, ms, fb, ff, feat=feat)
    if h == 0:  # a rank of the H split without rows
        return x
    fused_in = torch.cat([feats_b, feats_f, ms], dim=-1).reshape(t * b, h, w, 2 * c + 2)
    y = leaky_relu(pconv2d(p, "feat_prop_module.fuse.0", fused_in, padding=(1, 1)), 0.2)
    y = pconv2d(p, "feat_prop_module.fuse.2", y, padding=(1, 1)).reshape(t, b, h, w, c)
    a = feat.widened(PROP_HALO4)[0]
    return (y + xs).movedim(0, 1)[:, :, feat.lo - a : feat.hi - a]


def img_propagation(masked_frames, flows_f, flows_b, masks, interpolation="nearest", t_valid=None):
    """InpaintGenerator.img_propagation; t_valid as in
    `bidirectional_propagation_image`."""
    return bidirectional_propagation_image(masked_frames, flows_f, flows_b, masks, interpolation, t_valid)


def encode_features(p: Params, masked_frames, masks_in, masks_updated):
    """Per-frame encoder features: [N,H,W,3] + 2 masks -> [N,H/4,W/4,128],
    in frame chunks past ENCODE_BYTES. Under `spatial_sharding`, only the
    rank's feature rows widened by PROP_HALO4: the frames' pixel rows with
    ENC_HALO4 feature rows of halo more (clamped to the frame, so the
    convs pad where the image ends) are encoded and the halo trimmed."""
    with span("feature.encode"):
        n, h, w, _ = masked_frames.shape
        h4 = h // 4
        x = torch.cat([masked_frames, masks_in, masks_updated], dim=-1)
        a, b = _partition(h4).features(h4).widened(PROP_HALO4)
        if a == b:
            return x.new_zeros((n, 0, w // 4, CHANNEL))
        ea, eb = max(0, a - ENC_HALO4), min(h4, b + ENC_HALO4)
        x = x[:, 4 * ea : 4 * eb]
        return _frame_chunks(
            lambda v: encoder(p, v)[:, a - ea : b - ea], x, (eb - ea) * (w // 4) * 512 * x.element_size(), ENCODE_BYTES
        )


def downsample_flow(flows, h: int, w: int):
    """[N, T, H, W, 2] -> 1/4-res (bilinear, align_corners=False) / 4."""
    n_, t_, hh, ww, _ = flows.shape
    f2 = resize_bilinear(flows.reshape(n_ * t_, hh, ww, 2), h, w, align_corners=False)
    return f2.reshape(n_, t_, h, w, 2) / 4.0


def downsample_mask(m, h: int, w: int):
    """[N, T, H, W, 1] -> 1/4-res nearest."""
    n_, t_, hh, ww, _ = m.shape
    return resize_nearest(m.reshape(n_ * t_, hh, ww, 1), h, w).reshape(n_, t_, h, w, 1)


def attention_pool_mask(ds_mask_in_local):
    """[B, l_t, h, w, 1] -> [B, l_t, mh, mw, 1] (7x7/3 max pool, pad 3)."""
    b, l_t, h, w, _ = ds_mask_in_local.shape
    mp = max_pool2d(ds_mask_in_local.reshape(b * l_t, h, w, 1), (7, 7), (3, 3), (3, 3))
    return mp.reshape(b, l_t, mp.shape[1], mp.shape[2], 1)


def _t_valid_mask(b, t, l_t, l_t_valid, ref_valid, device):
    """[B, T] bool validity of (local ++ reference) frame slots, or None."""
    if l_t_valid is None and ref_valid is None:
        return None
    ltv = torch.as_tensor(l_t if l_t_valid is None else l_t_valid, device=device).reshape(-1)
    rfv = torch.as_tensor((t - l_t) if ref_valid is None else ref_valid, device=device).reshape(-1)
    ltv = ltv.expand(b)
    rfv = rfv.expand(b)
    ar_l = torch.arange(l_t, device=device)
    ar_r = torch.arange(t - l_t, device=device)
    return torch.cat([ar_l[None] < ltv[:, None], ar_r[None] < rfv[:, None]], dim=1)


def inpaint_generator_from_features(
    p: Params, enc_feat, ds_flows_f, ds_flows_b, ds_mask_in_local,
    ds_mask_updated_local, mask_pool_l, num_local_frames: int, ori_hw,
    l_t_valid=None, ref_valid=None, crop=None,
):
    """InpaintGenerator.forward after the encoder: feature propagation over
    local frames, soft split, transformer, soft comp, decoder.
    enc_feat [B, T, h, w, 128] -> local frames [B, l_t, H, W, 3] in [-1, 1];
    with crop = (y0, x0, ch, cw), only that full-res window is decoded
    (`decoder_crop`, exact) and the result is [B, l_t, ch, cw, 3].

    Under `spatial_sharding`: enc_feat holds the rank's feature rows
    widened by PROP_HALO4 (`encode_features` gives them), the flows and
    masks are whole, and the result is the rank's rows of the frames
    [B, l_t, rows, W, 3] (of the crop: [B, l_t, rows, cw, 3])."""
    l_t = num_local_frames
    b, t, _, w, _ = enc_feat.shape
    h = ds_mask_in_local.shape[2]
    ori_h, ori_w = ori_hw
    part = _partition(h)
    feat = part.features(h)
    a, wb = feat.widened(PROP_HALO4)
    local_feat, ref_feat = enc_feat[:, :l_t], enc_feat[:, l_t:, feat.lo - a : feat.hi - a]
    with span("feature.propagate"):
        prop_mask_in = torch.cat([ds_mask_in_local, ds_mask_updated_local], dim=-1)[:, :, a:wb]
        local_feat = bidirectional_propagation_feature(
            p, local_feat, ds_flows_f, ds_flows_b, prop_mask_in, t_valid=l_t_valid, feat=feat
        )
    enc_feat = torch.cat([local_feat, ref_feat], dim=1)
    t_valid_mask = _t_valid_mask(b, t, l_t, l_t_valid, ref_valid, enc_feat.device)

    with span("feature.transformer"):
        tok = part.tokens()
        trans_feat = soft_split(p, "ss", enc_feat.reshape(b * t, feat.rows, w, CHANNEL), (feat, tok))
        fh, fw = trans_feat.shape[1], trans_feat.shape[2]
        trans_feat = trans_feat.reshape(b, t, fh, fw, HIDDEN)
        seq = sequence_active()
        if seq is not None:
            # the feature stage's sequence-parallel form: T split over the mesh axis
            trans_feat = sequence_parallel_transformer(
                p, "transformers", trans_feat, (h, w), mask_pool_l, seq[0], t_valid_mask=t_valid_mask, axis=seq[1],
            )
        else:
            trans_feat = transformer_stack(
                p, "transformers", trans_feat, (h, w), mask_pool_l[:, :, tok.lo : tok.hi], t_valid_mask=t_valid_mask,
                split=part, tp=tensor_active(),
            )
        trans_feat = soft_comp(p, "sc", trans_feat.reshape(b * t, fh, fw, HIDDEN), (h, w), (tok, feat))
        enc_feat = enc_feat + trans_feat.reshape(b, t, feat.rows, w, CHANNEL)
    with span("feature.decode"):
        local = enc_feat[:, :l_t].reshape(b * l_t, feat.rows, w, CHANNEL)
        if part.whole:
            if crop is None:
                return torch.tanh(decoder(p, local)).reshape(b, l_t, ori_h, ori_w, 3)
            y0, x0, ch, cw = crop
            return torch.tanh(decoder_crop(p, local, y0, x0, ch, cw)).reshape(b, l_t, ch, cw, 3)
        y0, x0, ch, cw = (0, 0, ori_h, ori_w) if crop is None else crop
        pix = part.pixels(ori_h)
        r0, r1 = min(max(pix.lo, y0), y0 + ch), min(max(pix.hi, y0), y0 + ch)  # the rank's rows of the crop
        x, start = feat.halo(local, DECODER_HALO4, DECODER_HALO4, 1)
        out = decode_rows(p, x, start, h, w, r0, r1, x0, x0 + cw)
        return torch.tanh(out).reshape(b, l_t, r1 - r0, cw, 3)


def inpaint_generator_forward(
    p: Params, masked_frames, flows_f, flows_b, masks_in, masks_updated,
    num_local_frames: int, l_t_valid=None, ref_valid=None,
):
    """InpaintGenerator.forward (inference). masked_frames [B,T,H,W,3] in
    [-1, 1]; flows [B,l_t-1,H,W,2]; masks [B,T,H,W,1] -> [B,l_t,H,W,3];
    under `spatial_sharding`, every input whole, the rank's rows
    [B, l_t, rows, W, 3]."""
    l_t = num_local_frames
    b, t, ori_h, ori_w, _ = masked_frames.shape
    h, w = ori_h // 4, ori_w // 4
    enc_feat = encode_features(
        p,
        masked_frames.reshape(b * t, ori_h, ori_w, 3),
        masks_in.reshape(b * t, ori_h, ori_w, 1),
        masks_updated.reshape(b * t, ori_h, ori_w, 1),
    )
    enc_feat = enc_feat.reshape(b, t, enc_feat.shape[1], w, CHANNEL)
    ds_mask_in_local = downsample_mask(masks_in[:, :l_t], h, w)
    return inpaint_generator_from_features(
        p, enc_feat,
        downsample_flow(flows_f, h, w), downsample_flow(flows_b, h, w),
        ds_mask_in_local, downsample_mask(masks_updated[:, :l_t], h, w),
        attention_pool_mask(ds_mask_in_local), l_t, (ori_h, ori_w),
        l_t_valid=l_t_valid, ref_valid=ref_valid,
    )
