"""device_idle_pct: the share of the profiled clips' span in which no
device operation runs (the union of kernel, copy and memset intervals).
The clips are profiled with CUDA activity only, so the profiler adds
little host time; the span runs from a one-element fill on the card
just before the first clip's call to one just after the last clip's
return, so the host's work before and after each clip's kernels counts
as idle."""


def read(ctx):
    return 100.0 * (1.0 - ctx.busy_s / ctx.span_s)
