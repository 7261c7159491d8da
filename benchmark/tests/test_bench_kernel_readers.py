"""The kernel readers `corr_lookup_roofline` and `attention_ms` on the CPU:
the lookup's bound against a tap-by-tap count in every cell, and both readers
on a made-up device trace.

    python -m pytest benchmark/tests/test_bench_kernel_readers.py -q
"""

import os
import sys
import types

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark.core import roofline, session  # noqa: E402
from benchmark.core.trace import Trace  # noqa: E402

# H/8, W/8 of each cell's canvas
LOOKUP_SHAPES = {
    "inpaint-360p-fp32.object": (45, 80),
    "outpaint-360p.sides": (45, 96),  # 768x360
    "inpaint-360p.object": (45, 80),
    "inpaint-720p.object": (90, 160),
}


def window_values(h8, w8):
    """Every pixel's 10x10 windows at the 4 levels, taps inside the level's
    map counted one by one, summed over the pixels."""
    y, x = np.meshgrid(np.arange(h8), np.arange(w8), indexing="ij")
    total = 0
    for lvl in range(4):
        hl, wl = h8 >> lvl, w8 >> lvl
        for dy in range(-4, 6):
            rows = (0 <= (y >> lvl) + dy) & ((y >> lvl) + dy < hl)
            for dx in range(-4, 6):
                total += int((rows & (0 <= (x >> lvl) + dx) & ((x >> lvl) + dx < wl)).sum())
    return total


def test_window_values_by_hand():
    # one column of 45: the levels above 0 are 0 wide, so level 0 alone,
    # 36 whole windows of 10 rows, 6 + 7 + 8 + 9 at the top edge and
    # 9 + 8 + 7 + 6 + 5 at the bottom
    assert window_values(45, 1) == 36 * 10 + 30 + 35 == 425
    # 10 x 10: a line reads 6 + 7 + 8 + 9 + 10 + 9 + 8 + 7 + 6 + 5 = 75 at
    # level 0; its whole map at levels 1-3 (5, 2, 1 wide) from each of its
    # 10 pixels: 50, 20, 10
    assert window_values(10, 10) == 75 ** 2 + 50 ** 2 + 20 ** 2 + 10 ** 2


def ctx_of(workload, tr=None):
    spec = session.cell_spec(session.manifest(), workload)
    return types.SimpleNamespace(widgets=session.widgets(spec), frames=24, kind=spec.mix["node"], config=spec.config,
                                 trace=tr, lo=0.0, hi=1e9, profiled_clips=2)


@pytest.mark.parametrize("workload", sorted(LOOKUP_SHAPES))
def test_corr_lookup_bound_counts_every_lookup(workload):
    ctx = ctx_of(workload)
    h8, w8 = LOOKUP_SHAPES[workload]
    dt = ctx.config["precision"]
    esz = roofline.BYTES[dt]
    lookups = 2 * 23 * 20  # both directions of 23 pairs, 20 iterations
    pixels = lookups * h8 * w8
    expect = roofline.bound_s(pixels * 324 * 6, lookups * window_values(h8, w8) * esz + pixels * (8 + 324 * esz), dt)
    reader = session.reader("corr_lookup_roofline")
    assert reader.__globals__["bound_s"](ctx) == pytest.approx(expect, rel=1e-12)


def test_kernel_readers_on_a_trace():
    tr = Trace(device=[
        ("void corr_lookup_map_kernel(Pyramids, float const*, __nv_bfloat16*, long long, long long)", 0.0, 300.0, "kernel"),
        ("void corr_window4_kernel<float>(Levels, int const*)", 400.0, 100.0, "kernel"),
        ("window_attention_split_mma_kernel(Args)", 1000.0, 4000.0, "kernel"),
        ("window_attention_combine_kernel(Args, long long)", 4500.0, 1000.0, "kernel"),  # overlaps by 500 us
        ("void at::native::elementwise_kernel<128, 4>", 6000.0, 900.0, "kernel"),
    ])
    ctx = ctx_of("inpaint-720p.object", tr)
    lookup = session.reader("corr_lookup_roofline")
    assert lookup(ctx) == pytest.approx(100.0 * lookup.__globals__["bound_s"](ctx) / (400e-6 / 2), rel=1e-12)
    assert session.reader("attention_ms")(ctx) == pytest.approx(4.5 / 2)
    empty = ctx_of("inpaint-720p.object", Trace(device=[("void at::native::elementwise_kernel", 0.0, 5.0, "kernel")]))
    assert lookup(empty) is None and session.reader("attention_ms")(empty) is None
