"""The program's span record (utils/profiling.py: `spans`, `dropped`)
read for the benchmark's `program_span` metrics: one span name's time a
clip in the traced window, where the stage timers and spans are
blocking, so each span's time is synchronised on the card.

The spans and the window's clips share a clock: a span's start and end
are `time.perf_counter_ns()`, a clip's `time.perf_counter()`. A program
without the span record (`spans` missing) gives None, as does a window
in which the ring dropped a record or no span of the name started."""

from __future__ import annotations

import importlib

PACKAGE = "comfyui_propainter_nodes_tpu_torch"


def ms_per_clip(ctx, name: str) -> float | None:
    """The summed durations, in ms, of the spans `name` that started in
    [ctx.clips[0][0], ctx.clips[-1][1]], divided by the window's clips."""
    profiling = importlib.import_module(PACKAGE + ".utils.profiling")
    spans, dropped = getattr(profiling, "spans", None), getattr(profiling, "dropped", None)
    if spans is None or dropped is None or not ctx.clips:
        return None
    lo, hi = round(ctx.clips[0][0] * 1e9), round(ctx.clips[-1][1] * 1e9)
    n_dropped, newest_dropped_end = dropped()
    if n_dropped and newest_dropped_end >= lo:
        return None
    mine = [r.end_ns - r.start_ns for r in spans() if r.name == name and lo <= r.start_ns <= hi]
    if not mine:
        return None
    return sum(mine) / 1e6 / len(ctx.clips)
