"""mfu_pct: the model FLOPs of every clip of the traced window over its
length, as a share of the card's peak in the configuration's precision
(NVIDIA's H100 SXM data sheet at 700 W: 989 TFLOP/s dense bf16, 67
TFLOP/s float32 without TF32, as the program runs float32). The FLOPs a
clip needs are counted once per cell from the plain reference at the
cell's shapes and stored in `benchmark/counts/<cell>.json`; without that
file the metric is left out."""

from benchmark.core.roofline import PEAK_FLOPS


def read(ctx):
    if not ctx.counts:
        return None
    flops = ctx.counts["model_flops_per_clip"] * len(ctx.clips)
    return 100.0 * flops / ctx.window_s / PEAK_FLOPS[ctx.config["precision"]]
