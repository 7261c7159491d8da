"""corr_lookup_roofline: RAFT's correlation lookup's share of its
roofline in the profiled clips. The bound is counted from the model's
shapes, whatever implements it, and reads no data: every pair of the
clip (T - 1 a direction, both directions) at every one of `raft_iter`
iterations looks up each pixel at 1/8 of the canvas. At each of the 4
pyramid levels a pixel at (x, y) reads the part of its 10x10 window,
rows and columns from (x, y) / 2^l - 4 to + 5, that lies inside the
level's map (the taps outside read as zeros and are never loaded), in
the configuration's precision, plus 8 bytes of coordinates, and writes
4 x 81 values at 6 operations a tap. The time is the profiled device
time of the kernels named `corr_lookup*` or `corr_window*` (B1's lanes
and map-dtype blends, B6, B7), a clip."""

from benchmark.core.roofline import BYTES, bound_s as roofline_bound_s
from benchmark.core.shapes import canvas_hw

LEVELS, RADIUS, TAPS = 4, 4, 4 * 81


def in_map(n: int, lvl: int) -> int:
    """The window's in-map rows (or columns) summed over the n pixels of
    a column (or row) at 1/8, at level `lvl` of n >> lvl (2x2 average
    pools: floor halving)."""
    m = n >> lvl
    return sum(max(0, min((x >> lvl) + RADIUS + 2, m) - max((x >> lvl) - RADIUS, 0)) for x in range(n))


def bound_s(ctx):
    h, w = canvas_hw(ctx)
    h8, w8 = h // 8, w // 8
    dt = ctx.config["precision"]
    lookups = 2 * (ctx.frames - 1) * ctx.widgets["raft_iter"]
    window = sum(in_map(h8, lvl) * in_map(w8, lvl) for lvl in range(LEVELS))
    pixels = lookups * h8 * w8
    return roofline_bound_s(pixels * TAPS * 6, lookups * window * BYTES[dt] + pixels * (TAPS * BYTES[dt] + 8), dt)


def read(ctx):
    us = ctx.trace.device_us(ctx.lo, ctx.hi, lambda n: "corr_lookup" in n or "corr_window" in n)
    if not us:
        return None
    return 100.0 * bound_s(ctx) / (us / 1e6 / ctx.profiled_clips)
