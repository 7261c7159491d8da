"""JAX flat params -> upstream (torch state-dict) layout.

The exact inverse of the JAX package's `utils/checkpoint.py::
convert_state_dict`: HWIO -> OIHW, DHWIO -> OIDHW, (in, out) -> (out, in)
for ".weight" keys, everything else unchanged, same key names. The
port's modules therefore hold upstream-layout tensors, and a real `.pth`
loads into them without conversion.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def from_jax_params(flat: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    out: dict[str, torch.Tensor] = {}
    for key, val in flat.items():
        arr = np.asarray(val)
        if key.endswith(".weight"):
            if arr.ndim == 4:  # HWIO -> OIHW
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 5:  # DHWIO -> OIDHW
                arr = arr.transpose(4, 3, 0, 1, 2)
            elif arr.ndim == 2:  # (in, out) -> (out, in)
                arr = arr.transpose(1, 0)
        out[key] = torch.from_numpy(np.array(arr, order="C"))
    return out


def to_device(
    params: Mapping[str, torch.Tensor], device, dtype: torch.dtype
) -> dict[str, torch.Tensor]:
    """Cast + move a param dict (floating tensors only are cast)."""
    return {
        k: v.to(device=device, dtype=dtype if v.is_floating_point() else v.dtype)
        for k, v in params.items()
    }
