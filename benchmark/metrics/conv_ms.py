"""conv_ms: device time a clip of the library convolutions and matrix
products (cuDNN and cuBLAS kernels, with cuDNN's layout transforms),
the program's own kernels left out. From the profiled clips' trace."""

import re

LIBRARY = re.compile(r"cudnn|xmma|implicit_gemm|gemm|gemv|cutlass|nvjet|cublas|winograd|conv|nhwcToNchw|nchwToNhwc", re.I)
PROGRAM = re.compile(r"corr_lookup|deform_conv|window_attention|corr_window")


def read(ctx):
    us = ctx.trace.device_us(ctx.lo, ctx.hi, lambda n: bool(LIBRARY.search(n)) and not PROGRAM.search(n))
    return us / 1e3 / ctx.profiled_clips if us else None
