"""RAFT optical flow (large configuration, test mode), bidirectional.

Port of the JAX package's `models/raft.py`: NHWC activations, upstream
weights, the 20-step recurrent update as a Python loop over the
(net, coords) state. The all-pairs correlation of each adjacent pair is
computed once (the backward volume is its transpose) into the
pixel-major 4-level pyramids of both directions: from bf16 maps by one
launch of the corr-pyramid kernel (ops/cuda/corr_pyramid.py: the product
on the tensor cores, every level written from its tile, no float32
volume), from float32 maps as one fp32 `torch.matmul` pooled eagerly
(`corr_pyramids_plain`, also the CPU's build of bf16 maps). The pyramids
are looked up every iteration by the corr-lookup kernel (ops/cuda/corr_lookup.py),
both directions in one launch that writes the compute dtype, with the
blend the caller names or, by default, the one the JAX dispatcher picks
(`lookup_mode`). `raft_forward` is one direction (the JAX package's
memory-lean form); `raft_bi_forward_seqdir` runs the two directions in
turn on it, so one direction's pyramid is live at a time.
`call_bytes` estimates what one call holds in its correlation volume.
With PROPAINTER_TPU_CORR_KERNEL=pallas (read at call time, as the JAX
package reads it) both directions share one zero-padded pyramid and the
lookup takes the padded-map window kernel (ops/cuda/corr_window.py),
the JAX package's padded `lookup_corr` branch.
Compute dtype follows the params (bf16 under fp16="enable"); coords,
convex upsampling and the returned flows stay fp32. On CUDA float32
activations the convs named in ops/conv.py::GEMM_SITES (seven of the
update block's, the mask head's 1x1 and seven of each encoder's) run as
GEMMs over NHWC taps (`conv2d_gemm`); the rest, and every bf16 and CPU
conv, keep cuDNN.
Each call is two spans (utils/profiling.py): "raft.encode" (fnet, cnet
and the pyramids) and "raft.refine" (the update loop and convex
upsampling, `_refine`).
"""

from __future__ import annotations

import os
from typing import Mapping

import torch
import torch.nn.functional as F

from ..ops.conv import batch_norm_eval, instance_norm, pconv2d, pconv2d_many
from ..ops.cuda.corr_lookup import corr_lookup
from ..ops.cuda.corr_pyramid import all_pairs_corr, corr_pyramids, corr_pyramids_plain, pool_pyramid
from ..ops.cuda.corr_window import corr_window_lookup4
from ..ops.patches import unfold
from ..ops.warp import coords_grid
from ..utils.profiling import span

Params = Mapping[str, torch.Tensor]

CORR_LEVELS = 4
CORR_RADIUS = 4
HDIM = 128  # hidden-state channels of the context features
# zero border of the padded pyramid: >= the 10-wide window, so a window
# whose start clamps to the edge lies wholly in zeros
PAD = 2 * CORR_RADIUS + 2
WIN = 2 * CORR_RADIUS + 2


# ---------------------------------------------------------------- encoders


def _residual_block(p: Params, pre: str, x, stride: int, norm: str):
    """extractor.py:5-57 ResidualBlock (instance or batch norm)."""

    def apply_norm(name, v):
        if norm == "instance":
            return instance_norm(v)
        if norm == "batch":
            return batch_norm_eval(p, name, v)
        return v

    y = pconv2d(p, pre + ".conv1", x, stride=(stride, stride), padding=(1, 1))
    y = torch.relu(apply_norm(pre + ".norm1", y))
    y = pconv2d(p, pre + ".conv2", y, padding=(1, 1))
    y = torch.relu(apply_norm(pre + ".norm2", y))
    if stride != 1:
        x = pconv2d(p, pre + ".downsample.0", x, stride=(stride, stride))
        x = apply_norm(pre + ".norm3", x)
    return torch.relu(x + y)


def basic_encoder(p: Params, pre: str, x, norm: str):
    """extractor.py:121-193 BasicEncoder: 1/8-res features."""
    x = pconv2d(p, pre + ".conv1", x, stride=(2, 2), padding=(3, 3))
    if norm == "instance":
        x = instance_norm(x)
    elif norm == "batch":
        x = batch_norm_eval(p, pre + ".norm1", x)
    x = torch.relu(x)
    for layer, stride in (("layer1", 1), ("layer2", 2), ("layer3", 2)):
        x = _residual_block(p, f"{pre}.{layer}.0", x, stride, norm)
        x = _residual_block(p, f"{pre}.{layer}.1", x, 1, norm)
    return pconv2d(p, pre + ".conv2", x)


# ---------------------------------------------------------- corr pyramid


def build_corr_pyramids(fmap1, fmap2, backward: bool = True):
    """(forward, backward) pixel-major pyramids from ONE all-pairs product:
    forward maps are corr[n, p, :] over image-2 coords, backward maps (None
    without `backward`) its transpose over image-1 coords. bf16 maps take
    `corr_pyramids` (one kernel launch on the card); other dtypes the
    eager build."""
    build = corr_pyramids if fmap1.dtype == torch.bfloat16 else corr_pyramids_plain
    return build(fmap1, fmap2, backward)


def build_padded_pyramid(fmap1, fmap2):
    """One direction's zero-padded 4-level pyramid (the JAX package's
    `build_corr_pyramid(pad=True)`), laid out as `build_padded_pyramid_bi`
    lays out each half."""
    n, h, w, _ = fmap1.shape
    corr = all_pairs_corr(fmap1, fmap2)
    level0 = corr.new_zeros((n * h * w, h + 2 * PAD, w + 2 * PAD))
    level0[:, PAD : PAD + h, PAD : PAD + w] = corr.view(n * h * w, h, w)
    del corr
    coarse = pool_pyramid(level0[:, PAD : PAD + h, PAD : PAD + w])[1:]
    return [level0] + [F.pad(m, (PAD, PAD, PAD, PAD)) for m in coarse]


def build_padded_pyramid_bi(fmap1, fmap2):
    """ONE zero-padded 4-level pyramid whose batch is [fwd pixels ++ bwd
    pixels] (the JAX package's `build_corr_pyramid_bi(pad=True)`): pool
    first, then pad each level by PAD. Level 0 is written straight into
    its padded buffer, the backward half from the transposed product."""
    n, h, w, _ = fmap1.shape
    hw = h * w
    corr = all_pairs_corr(fmap1, fmap2)
    level0 = corr.new_zeros((2, n, hw, h + 2 * PAD, w + 2 * PAD))
    level0[0, :, :, PAD : PAD + h, PAD : PAD + w] = corr.view(n, hw, h, w)
    level0[1, :, :, PAD : PAD + h, PAD : PAD + w] = corr.transpose(1, 2).view(n, hw, h, w)
    del corr
    level0 = level0.view(2 * n * hw, h + 2 * PAD, w + 2 * PAD)
    coarse = pool_pyramid(level0[:, PAD : PAD + h, PAD : PAD + w])[1:]
    return [level0] + [F.pad(m, (PAD, PAD, PAD, PAD)) for m in coarse]


def padded_starts(pyramid, coords):
    """Window starts and fractions of the JAX package's padded
    `lookup_corr` branch (models/raft.py there): per level, starts in
    padded coordinates clamped to [0, Hp-10] x [0, Wp-10], fractions cast
    to the map's dtype. coords [M', H8, W8, 2] fp32 (x, y) -> sy, sx
    [4, M] int32 and fy, fx [4, M] fp32, M = M'*H8*W8."""
    flat = coords.reshape(-1, 2)
    sy, sx, fy, fx = [], [], [], []
    for lvl, cmap in enumerate(pyramid):
        c = flat / (2**lvl)
        x0 = torch.floor(c[:, 0])
        y0 = torch.floor(c[:, 1])
        fx.append((c[:, 0] - x0).to(cmap.dtype).float())
        fy.append((c[:, 1] - y0).to(cmap.dtype).float())
        # far-away centroids clamp anyway; bound them before the int cast
        sy.append((y0.clamp(-1e6, 1e6).int() - CORR_RADIUS + PAD).clamp(0, cmap.shape[1] - WIN))
        sx.append((x0.clamp(-1e6, 1e6).int() - CORR_RADIUS + PAD).clamp(0, cmap.shape[2] - WIN))
    return torch.stack(sy), torch.stack(sx), torch.stack(fy), torch.stack(fx)


def lookup_padded(pyramid, coords):
    """The padded branch's lookup: the four-level window kernel, its
    (dy, dx) taps transposed to the reference's (dx, dy) channels.
    coords [M', H8, W8, 2] -> [M', H8, W8, 324] fp32."""
    nb, h8, w8, _ = coords.shape
    taps = corr_window_lookup4(pyramid, *padded_starts(pyramid, coords))
    return taps.transpose(2, 3).reshape(nb, h8, w8, CORR_LEVELS * 81)


def lookup_mode(n: int, h8: int, w8: int, dtype: torch.dtype) -> str:
    """The lookup the JAX package's `raft_bi_forward` takes for a call of
    n frame pairs at h8 x w8 (models/raft.py:540-556 there), from the
    variables it reads, read at call time:
      "pallas"  PROPAINTER_TPU_CORR_KERNEL=pallas: one padded pyramid, B6;
      "lanes"   the lanes lookup (B1, fp32 blend), when the variable is
                unset or "lanes", w8 <= PROPAINTER_TPU_LANES_WMAX (96) and
                one direction's lanes volume is at most
                PROPAINTER_TPU_LANES_BUDGET bytes (1 GiB);
      "map"     otherwise `lookup_corr` (B1 with the map-dtype blend)."""
    kern = os.environ.get("PROPAINTER_TPU_CORR_KERNEL", "lanes")
    if kern == "pallas":
        return "pallas"
    hw_pad_est = -(-(h8 * w8) // 512) * 512
    h0_est = -(-h8 // 16) * 16
    vol_bytes_dir = n * h0_est * w8 * hw_pad_est * dtype.itemsize
    budget = int(os.environ.get("PROPAINTER_TPU_LANES_BUDGET", str(1 << 30)))
    wmax = int(os.environ.get("PROPAINTER_TPU_LANES_WMAX", "96"))
    return "lanes" if kern == "lanes" and vol_bytes_dir <= budget and w8 <= wmax else "map"


def forward_lookup_mode() -> str:
    """The lookup the JAX package's one-direction `raft_forward` takes
    (models/raft.py:423-471 there): never the lanes lookup; "pallas" under
    PROPAINTER_TPU_CORR_KERNEL=pallas, else `lookup_corr` ("map")."""
    return "pallas" if os.environ.get("PROPAINTER_TPU_CORR_KERNEL", "lanes") == "pallas" else "map"


def call_bytes(n: int, h8: int, w8: int, esz: int, mode: str, directions: int = 2) -> float:
    """Peak bytes one RAFT call of n pairs at h8 x w8 holds in its
    correlation volume: the larger of the all-pairs product (V = n *
    (h8 * w8)^2 values in fp32, and its cast to the compute dtype of
    esz bytes) and the pyramids that follow it (per direction 4/3 of V
    in that dtype: the backward level 0 is a contiguous copy of the
    transpose; zero-padded by PAD on each side under "pallas"). At
    1920x1080 in bf16 a pair's product is 3.9 GiB of fp32; the encoders,
    the update loop and the flows it leaves out came to about 3 GiB more
    for 2-pair calls there (the high-res plans' bring-up, CHANGES.md).
    A bf16 call on the card holds only the pyramids (the corr-pyramid
    kernel writes no product), so there the estimate is high by the
    product's share; it stays the eager build's, which the RAFT forms
    were planned on and which the CPU and the "pallas" build still run."""
    hw = h8 * w8
    v = float(n) * hw * hw
    product = v * 4 + (v * esz if esz != 4 else 0)
    per_dir = 4 / 3 * v * esz
    if mode == "pallas":
        per_dir *= (h8 + 2 * PAD) * (w8 + 2 * PAD) / hw
        return max(product, v * esz + directions * per_dir)
    return max(product, directions * per_dir)


# ------------------------------------------------------------ update block


def _motion_encoder(p: Params, flow, corr):
    """update.py:94-112 BasicMotionEncoder."""
    pre = "update_block.encoder"
    cor = torch.relu(pconv2d(p, pre + ".convc1", corr))
    cor = torch.relu(pconv2d(p, pre + ".convc2", cor, padding=(1, 1)))
    flo = torch.relu(pconv2d(p, pre + ".convf1", flow, padding=(3, 3)))
    flo = torch.relu(pconv2d(p, pre + ".convf2", flo, padding=(1, 1)))
    out = torch.relu(pconv2d(p, pre + ".conv", torch.cat([cor, flo], -1), padding=(1, 1)))
    return torch.cat([out, flow], dim=-1)


def _sep_conv_gru(p: Params, h, x):
    """update.py:35-73 SepConvGRU: 1x5 then 5x1 gated updates (z and r,
    convs of one input, as one product on GEMMs: `pconv2d_many`)."""
    pre = "update_block.gru"
    for tag, pad in (("1", (0, 2)), ("2", (2, 0))):
        hx = torch.cat([h, x], dim=-1)
        z, r = (torch.sigmoid(g) for g in pconv2d_many(p, (f"{pre}.convz{tag}", f"{pre}.convr{tag}"), hx, pad))
        q = torch.tanh(pconv2d(p, f"{pre}.convq{tag}", torch.cat([r * h, x], -1), padding=pad))
        h = (1 - z) * h + z * q
    return h


def _update_block(p: Params, net, inp, corr, flow):
    """update.py:131-154 BasicUpdateBlock, without the mask head."""
    motion = _motion_encoder(p, flow, corr)
    net = _sep_conv_gru(p, net, torch.cat([inp, motion], dim=-1))
    fh = torch.relu(pconv2d(p, "update_block.flow_head.conv1", net, padding=(1, 1)))
    delta_flow = pconv2d(p, "update_block.flow_head.conv2", fh, padding=(1, 1))
    return net, delta_flow


def _upsample_mask(p: Params, net):
    """update.py:139-153 mask head, evaluated once on the final `net`
    (inference only consumes the last iteration's mask)."""
    m = torch.relu(pconv2d(p, "update_block.mask.0", net, padding=(1, 1)))
    return 0.25 * pconv2d(p, "update_block.mask.2", m)


def convex_upsample(flow, mask):
    """raft.py:81-92. flow [N, H, W, 2]; mask [N, H, W, 576] with channel
    k*64 + di*8 + dj."""
    n, h, w, _ = flow.shape
    m = torch.softmax(mask.reshape(n, h, w, 9, 8, 8), dim=3)
    patches = unfold(8.0 * flow, (3, 3), (1, 1), (1, 1)).reshape(n, h, w, 9, 2)
    up = torch.einsum("nhwkab,nhwkc->nhwabc", m, patches)  # [N, H, W, 8, 8, 2]
    return up.permute(0, 1, 3, 2, 4, 5).reshape(n, 8 * h, 8 * w, 2)


# ------------------------------------------------------------------ forward


def _refine(params: Params, cnet, lookup, h8: int, w8: int, iters: int):
    """The update loop and convex upsampling, shared by both forms:
    cnet [M, H8, W8, 256] context features in the order of the lookup's
    batch -> flows [M, 8*H8, 8*W8, 2] fp32."""
    with span("raft.refine"):
        cdt = cnet.dtype
        net = torch.tanh(cnet[..., :HDIM])
        inp = torch.relu(cnet[..., HDIM:])
        coords0 = coords_grid(cnet.shape[0], h8, w8, device=cnet.device)
        coords1 = coords0.clone()
        for _ in range(iters):
            corr = lookup(coords1)
            flow = coords1 - coords0
            net, delta = _update_block(params, net, inp, corr.to(cdt), flow.to(cdt))
            coords1 = coords1 + delta.float()
        return convex_upsample(coords1 - coords0, _upsample_mask(params, net).float())


def _lookup_fn(mode: str, fmap1, fmap2, bidirectional: bool):
    """The lookup of one call: "pallas" (B6 on the zero-padded pyramid)
    or B1 with the "lanes" or "map" blend; both directions in one
    pyramid pair (or one padded pyramid) when bidirectional."""
    if mode == "pallas":
        pyr = build_padded_pyramid_bi(fmap1, fmap2) if bidirectional else build_padded_pyramid(fmap1, fmap2)
        return lambda c: lookup_padded(pyr, c)
    pyr_f, pyr_b = build_corr_pyramids(fmap1, fmap2, backward=bidirectional)
    return lambda c: corr_lookup(pyr_f, c, pyr_b, blend=mode)


def raft_forward(params: Params, image1, image2, iters: int = 20, blend: str | None = None):
    """Flow from image1 to image2 (the JAX package's `raft_forward`,
    models/raft.py:423-471 there). Images [N, H, W, 3] in [-1, 1] ->
    [N, H, W, 2] fp32. fnet runs on both images, cnet on image1; one
    direction's pyramid. `blend` names the lookup ("lanes", "map" or
    "pallas"); by default the one JAX's `raft_forward` takes
    (`forward_lookup_mode`)."""
    cdt = params["fnet.conv1.weight"].dtype
    n, h, w, _ = image1.shape
    h8, w8 = h // 8, w // 8
    with span("raft.encode"):
        fmaps = basic_encoder(params, "fnet", torch.cat([image1, image2]).to(cdt), norm="instance")
        lookup = _lookup_fn(blend or forward_lookup_mode(), fmaps[:n], fmaps[n:], bidirectional=False)
        del fmaps
        cnet = basic_encoder(params, "cnet", image1.to(cdt), norm="batch")
    return _refine(params, cnet, lookup, h8, w8, iters)


def raft_bi_forward_seqdir(params: Params, frames, iters: int = 20, blend: str | None = None):
    """Bidirectional flow with the directions in turn (the JAX package's
    `raft_bi_forward_seqdir`, models/raft.py:474-498 there): the forward
    `raft_forward` ends before the backward one starts, so one
    direction's pyramid is live at a time. frames [B, T, H, W, 3] ->
    (flows_fwd, flows_bwd), each [B, T-1, H, W, 2] fp32."""
    b, t, h, w, c = frames.shape
    im1 = frames[:, :-1].reshape(b * (t - 1), h, w, c)
    im2 = frames[:, 1:].reshape(b * (t - 1), h, w, c)
    f_fwd = raft_forward(params, im1, im2, iters, blend).reshape(b, t - 1, h, w, 2)
    f_bwd = raft_forward(params, im2, im1, iters, blend).reshape(b, t - 1, h, w, 2)
    return f_fwd, f_bwd


def raft_bi_forward(params: Params, frames, iters: int = 20, blend: str | None = None):
    """Bidirectional flow over a clip (flow_comp_raft.py:39-58).

    frames: [B, T, H, W, 3] in [-1, 1]. Returns (flows_fwd, flows_bwd),
    each [B, T-1, H, W, 2] fp32. fnet/cnet run once per frame; both
    directions share one batched update loop.

    `blend` names the lookup ("lanes", "map" or "pallas"). By default it
    follows the JAX dispatcher (`lookup_mode`), whose volume clause reads
    this call's n = B * (T-1). The JAX stage plan batches RAFT otherwise
    than a caller may (pairs a call, padded chunks), and the blends differ
    in bf16, so `Pipeline.compute_flow` names the blend the JAX stage
    takes for its clip (`pipeline/stages.py::jax_flow_lookup`) in every
    call it makes."""
    b, t, h, w, c = frames.shape
    n = b * (t - 1)
    cdt = params["fnet.conv1.weight"].dtype
    h8, w8 = h // 8, w // 8
    with span("raft.encode"):
        flat = frames.reshape(b * t, h, w, c).to(cdt)
        fmaps = basic_encoder(params, "fnet", flat, norm="instance")
        cnet_all = basic_encoder(params, "cnet", flat, norm="batch")

        fm = fmaps.reshape(b, t, h8, w8, -1)
        f1 = fm[:, :-1].reshape(n, h8, w8, -1)
        f2 = fm[:, 1:].reshape(n, h8, w8, -1)
        # both directions in one launch, in the maps' dtype
        lookup = _lookup_fn(blend or lookup_mode(n, h8, w8, cdt), f1, f2, bidirectional=True)
        del fmaps, fm, f1, f2

        # context order matches the lookup batch: [fwd image1 ++ bwd image1]
        cn = cnet_all.reshape(b, t, h8, w8, -1)
        cnet = torch.cat([cn[:, :-1], cn[:, 1:]], dim=0).reshape(2 * n, h8, w8, -1)
    flows = _refine(params, cnet, lookup, h8, w8, iters)
    return (
        flows[:n].reshape(b, t - 1, h, w, 2),
        flows[n:].reshape(b, t - 1, h, w, 2),
    )
