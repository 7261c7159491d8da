"""Torch checkpoint -> the JAX package's flat layout, and its `.jax.npz` cache.

The port's own copy of the JAX package's `utils/checkpoint.py`: a
`.pth` state dict converts once into a flat {name: ndarray} dict in the
JAX layouts,

  conv2d   weight  OIHW   -> HWIO
  conv3d   weight  OIDHW  -> DHWIO
  linear   weight  (o, i) -> (i, o)
  everything else kept as is,

names in the torch spelling without the DataParallel "module." prefix,
`num_batches_tracked` dropped. `convert_state_dict` is the inverse of
`utils/params.py::from_jax_params`, which gives the port its
upstream-layout tensors back. The cache it writes (`save_params`, one
`.jax.npz`) is the file the JAX package writes: either package reads the
other's.
"""

from __future__ import annotations

import os
from typing import Mapping

import numpy as np
import torch

_DROP_SUFFIXES = ("num_batches_tracked",)


def convert_state_dict(state: Mapping) -> dict[str, np.ndarray]:
    """A torch state dict (tensors or ndarrays) in the JAX layout."""
    out: dict[str, np.ndarray] = {}
    for key, val in state.items():
        if key.startswith("module."):
            key = key[len("module.") :]
        if key.endswith(_DROP_SUFFIXES):
            continue
        arr = np.asarray(val.detach().cpu().numpy() if isinstance(val, torch.Tensor) else val)
        if key.endswith(".weight"):
            if arr.ndim == 4:  # conv2d OIHW -> HWIO
                arr = arr.transpose(2, 3, 1, 0)
            elif arr.ndim == 5:  # conv3d OIDHW -> DHWIO
                arr = arr.transpose(2, 3, 4, 1, 0)
            elif arr.ndim == 2:  # linear (out, in) -> (in, out)
                arr = arr.transpose(1, 0)
        out[key] = np.ascontiguousarray(arr)
    return out


def load_torch_checkpoint(path: str) -> dict[str, np.ndarray]:
    """A .pth file (its "state_dict" where it has one), converted."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    return convert_state_dict(state)


def save_params(params: Mapping[str, np.ndarray], path: str) -> None:
    np.savez(path, **params)


def load_params(path: str) -> dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def convert_or_load_cached(pth_path: str, cache_dir: str) -> dict[str, np.ndarray]:
    """The .pth converted once, cached as <cache_dir>/<name>.jax.npz."""
    os.makedirs(cache_dir, exist_ok=True)
    base = os.path.splitext(os.path.basename(pth_path))[0]
    npz = os.path.join(cache_dir, base + ".jax.npz")
    if os.path.exists(npz):
        return load_params(npz)
    params = load_torch_checkpoint(pth_path)
    save_params(params, npz)
    return params


def filter_prefix(params: Mapping[str, np.ndarray], prefix: str) -> dict[str, np.ndarray]:
    """Sub-tree view: {k[len(prefix):]: v for keys starting with prefix}."""
    return {k[len(prefix) :]: v for k, v in params.items() if k.startswith(prefix)}
