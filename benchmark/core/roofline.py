"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at its 700 W limit) and the least time a piece of work can take on it."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}  # fp32: CUDA cores, TF32 off
BYTES = {"bf16": 2, "fp32": 4}


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """max(operations / peak, bytes / bandwidth), in seconds."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


def deform_bound_s(n: int, h: int, w: int, cin: int, cout: int, dtype: str, groups: int = 16) -> float:
    """The modulated deformable 3x3 conv on x [n, h, w, cin] with one
    output pixel per input pixel: its operations (2 x 9 x cin x cout a
    pixel), and x, the offsets and mask (27 values a group and pixel),
    the output, weights and bias each moved once."""
    m = n * h * w
    esz = BYTES[dtype]
    nbytes = (n * h * w * cin + m * groups * 27 + m * cout) * esz + (9 * cin * cout + cout) * esz
    return bound_s(2.0 * m * 9 * cin * cout, nbytes, dtype)
