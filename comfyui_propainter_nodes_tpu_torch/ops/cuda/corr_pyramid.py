"""RAFT's correlation pyramids: a CUDA kernel a call (csrc/corr_pyramid.cu) + its plain version.

Replaces no TPU kernel: the JAX package leaves the build to XLA
(`models/raft.py::build_corr_pyramid_bi` there: an einsum of the bf16
maps with float32 accumulation, divided by sqrt(C), stored in bf16).

  corr_pyramids(fmap1, fmap2, backward)
      fmap1, fmap2 [N, H, W, C] -> (forward levels, backward levels or None)

Level l of a direction is [N*H*W, H >> l, W >> l] in the maps' dtype:
the forward map of image-1 position p is corr[p, :] over image 2's grid,
the backward map of image-2 position q is corr[:, q] over image 1's
grid, and levels 1-3 are 2x2 average pools of the level below (odd
tails dropped; a level may be empty at tiny sizes). These are the
layouts `models/raft.py` hands the lookups (ops/cuda/corr_lookup.py).

`corr_pyramids_plain` is the eager build: one float32 product of the
upcast maps, divided in place and cast to the maps' dtype, pooled by
`pool_pyramid`; the backward level 0 a contiguous copy of its
transpose. CPU tensors take it. CUDA bf16 tensors take the kernel, one
launch a call on the current stream, counted as "corr_pyramid": the
product on the tensor cores with float32 accumulators (the plain
version's sums in another order), both directions' four levels written
from the tile, no float32 volume; levels 1-3 are bit for bit the plain
pooling of its own level 0. A CUDA tensor of another dtype raises: a
float32 product without TF32 has no tensor-core path, and the eager
build keeps it. The kernel has no backward: under grad mode with an
input that requires grad it raises (RAFT is not trained).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...utils.profiling import kernel
from . import _build
from ._grad import forward_only

LEVELS = 4


def all_pairs_corr(fmap1, fmap2):
    """[N, H, W, C] x2 -> [N, H*W, H*W] correlation / sqrt(C), computed in
    fp32 and stored in the maps' dtype. The scale is applied in place:
    one fp32 product is live, not two (3.9 GiB a pair at 1920x1080)."""
    n, h, w, c = fmap1.shape
    f1 = fmap1.reshape(n, h * w, c).float()
    f2 = fmap2.reshape(n, h * w, c).float()
    corr = torch.matmul(f1, f2.transpose(1, 2))
    corr.div_(math.sqrt(c))
    return corr.to(fmap1.dtype)


def pool_pyramid(level0):
    """[M, H, W] maps -> 4 levels of 2x2 average pools (odd tails dropped;
    a level may be empty at tiny sizes, and then reads as zeros)."""
    pyramid = [level0]
    m = level0
    for _ in range(LEVELS - 1):
        h2, w2 = m.shape[1] // 2, m.shape[2] // 2
        msum = m[:, 0 : 2 * h2 : 2] + m[:, 1 : 2 * h2 : 2]
        m = msum[:, :, 0 : 2 * w2 : 2] * 0.25 + msum[:, :, 1 : 2 * w2 : 2] * 0.25
        pyramid.append(m.contiguous())
    return pyramid


def corr_pyramids_plain(fmap1, fmap2, backward: bool = True):
    """(forward, backward or None) pixel-major pyramids from ONE all-pairs
    product, eagerly, on any device and in any float dtype."""
    n, h, w, _ = fmap1.shape
    corr = all_pairs_corr(fmap1, fmap2)
    fwd = pool_pyramid(corr.reshape(n * h * w, h, w))
    if not backward:
        return fwd, None
    # at n = 1 the reshape of the transpose is a strided view, not a copy
    return fwd, pool_pyramid(corr.transpose(1, 2).reshape(n * h * w, h, w).contiguous())


def inv_sqrt(c: int) -> float:
    """1 / sqrt(C) as a float32 division of float32 values: the factor by
    which eager PyTorch on the card scales a float32 tensor divided by the
    host scalar sqrt(C) (it multiplies by the reciprocal)."""
    return float(np.float32(1.0) / np.float32(math.sqrt(c)))


def _check(fmap1, fmap2):
    if fmap1.dim() != 4 or fmap1.shape != fmap2.shape:
        raise ValueError(f"corr_pyramids: maps must be two [N, H, W, C] of one shape, got "
                         f"{tuple(fmap1.shape)} and {tuple(fmap2.shape)}")
    if min(fmap1.shape) < 1:
        raise ValueError(f"corr_pyramids: empty maps {tuple(fmap1.shape)}")
    if fmap1.dtype != fmap2.dtype or fmap1.device != fmap2.device:
        raise ValueError("corr_pyramids: maps must share one dtype and one device")
    dev = fmap1.device
    if dev.type == "cpu":
        return
    if dev.type != "cuda":
        raise ValueError(f"corr_pyramids: unsupported device {dev}")
    if fmap1.dtype != torch.bfloat16:
        raise ValueError(f"corr_pyramids: CUDA maps must be bf16 (the kernel's only type), got {fmap1.dtype}")
    n, h, w, c = fmap1.shape
    if c % 16:
        raise ValueError(f"corr_pyramids: channels must be a multiple of 16, got {c}")
    if h * w * c >= 2**31:
        raise ValueError(f"corr_pyramids: at most 2**31 - 1 values an image, got {h * w * c}")


def corr_pyramids(fmap1, fmap2, backward: bool = True):
    """Both directions' pyramids (or the forward one alone): the kernel on
    CUDA bf16 maps, `corr_pyramids_plain` on CPU ones (the module's
    docstring)."""
    _check(fmap1, fmap2)
    if fmap1.device.type == "cpu":
        return corr_pyramids_plain(fmap1, fmap2, backward)
    forward_only("corr_pyramid", fmap1, fmap2)
    f1, f2 = fmap1.contiguous(), fmap2.contiguous()
    if f1.data_ptr() % 16 or f2.data_ptr() % 16:
        raise ValueError("corr_pyramids: maps must be 16-byte aligned")
    n, h, w, c = f1.shape
    m = n * h * w

    def levels():
        return [torch.empty((m, h >> lvl, w >> lvl), dtype=f1.dtype, device=f1.device) for lvl in range(LEVELS)]

    fwd = levels()
    bwd = levels() if backward else None
    ptrs = [t.data_ptr() for t in fwd] + ([t.data_ptr() for t in bwd] if backward else [None] * LEVELS)
    with kernel("corr_pyramid"):
        status = _build.library().propainter_corr_pyramid(
            f1.data_ptr(), f2.data_ptr(), *ptrs, n, h, w, c, inv_sqrt(c),
            torch.cuda.current_stream(f1.device).cuda_stream,
        )
        _build.check(status, "corr_pyramid")
    return fwd, bwd
