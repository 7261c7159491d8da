"""deform_conv_roofline: the modulated deformable conv's share of its
roofline in the profiled clips. The bound is counted from the model's
shapes, whatever implements it: flow completion aligns each of the
T - 1 flows of both directions after the first, in both propagation
modules, at x [1, H/8, W/8, 256]; the feature stage aligns each local
frame after the first of every window, in both directions, at x
[1, H/4, W/4, 128]; 16 offset groups, 128 output channels, the
configuration's precision. The time is the profiled device time of the
kernels named `deform_conv*`, a clip."""

from benchmark.core.roofline import deform_bound_s
from benchmark.reference.pipeline import windows


def canvas_hw(ctx):
    w = ctx.widgets
    if ctx.kind == "outpaint":
        return int(w["height_scale"] * w["height"]) // 8 * 8, int(w["width_scale"] * w["width"]) // 8 * 8
    return w["height"] // 8 * 8, w["width"] // 8 * 8


def bound_s(ctx):
    h, w = canvas_hw(ctx)
    t = ctx.frames
    dt = ctx.config["precision"]
    sub = ctx.widgets["subvideo_length"]
    chunk_flows = [min(t - 1, f + sub + 5) - max(0, f - 5) for f in range(0, t - 1, sub)]
    fc = sum(2 * 2 * (n - 1) for n in chunk_flows) * deform_bound_s(1, h // 8, w // 8, 256, 128, dt)
    fp = sum(2 * (len(nids) - 1) for nids, _ in windows(ctx.widgets, t)) * deform_bound_s(1, h // 4, w // 4, 128, 128, dt)
    return fc + fp


def read(ctx):
    us = ctx.trace.device_us(ctx.lo, ctx.hi, lambda n: "deform_conv" in n)
    if not us:
        return None
    return 100.0 * bound_s(ctx) / (us / 1e6 / ctx.profiled_clips)
