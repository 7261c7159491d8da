"""The three networks' weights from their `.jax.npz` files.

The files hold flat {state_dict_key: array} dicts in the converted
layout (conv HWIO, conv3d DHWIO, linear (in, out)); the reference turns
them back into upstream layouts (OIHW, OIDHW, (out, in)) itself.
"""

from __future__ import annotations

import os

import numpy as np
import torch

FILES = {
    "raft": "raft-things.jax.npz",
    "flow_completion": "recurrent_flow_completion.jax.npz",
    "inpaint_generator": "ProPainter.jax.npz",
}
_TO_UPSTREAM = {4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2), 2: (1, 0)}


def to_upstream(key: str, arr: np.ndarray) -> np.ndarray:
    if key.endswith(".weight") and arr.ndim in _TO_UPSTREAM:
        return np.ascontiguousarray(arr.transpose(_TO_UPSTREAM[arr.ndim]))
    return arr


def load(folder: str, device) -> dict:
    """{model: {key: float32 tensor on device}} for the three networks."""
    out = {}
    for model, name in FILES.items():
        with np.load(os.path.join(folder, name)) as z:
            out[model] = {k: torch.from_numpy(to_upstream(k, z[k])).to(device=device, dtype=torch.float32)
                          for k in z.files}
    return out
