"""attention_ms: device time a clip of the transformer's window
attention, the kernels named `window_attention*` (B3; B4's split and
combine; B5), from the profiled clips' trace. No roofline yet: the
bound needs the windows that the mask occupies in each block, which
this reader cannot count without the clips' masks."""


def read(ctx):
    us = ctx.trace.device_us(ctx.lo, ctx.hi, lambda n: "window_attention" in n)
    return us / 1e3 / ctx.profiled_clips if us else None
