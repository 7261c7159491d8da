"""glue_ms: device time a clip of PyTorch's own kernels (elementwise,
copies, cat, gather, index, reductions, softmax, norms): the eager glue
between the networks' convs and the program's kernels. From the
profiled clips' trace."""

import re

OWN = re.compile(r"at::native|at_cuda_detail|CatArrayBatchedCopy|elementwise_kernel|reduce_kernel")
NOT_GLUE = re.compile(r"corr_lookup|deform_conv|window_attention|corr_window|cudnn|xmma|gemm|cutlass|nvjet", re.I)


def read(ctx):
    us = ctx.trace.device_us(ctx.lo, ctx.hi, lambda n: bool(OWN.search(n)) and not NOT_GLUE.search(n))
    return us / 1e3 / ctx.profiled_clips if us else None
