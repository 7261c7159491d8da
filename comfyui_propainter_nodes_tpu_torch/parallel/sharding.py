"""Sharding rules: which dims of which parameters split over the mesh.

Counterpart of the JAX package's `parallel/sharding.py`, its rule table
copied: the transformer's q/k/v and FFN fc1 are column parallel (their
output dim splits over "model"), the attention proj and fc2 row parallel
(their input dim splits), everything else is whole on every rank; video
batches split their leading (clip) axis over "data". Specs name the dims
of the JAX checkpoint layout, where a linear weight is (in, out); the
port holds upstream (out, in) weights, so `shard_params` reverses a 2-D
weight's spec. Training builds on these; inference runs whole weights.
"""

from __future__ import annotations

from typing import Mapping

import torch

from .mesh import DATA_AXIS, MODEL_AXIS, Mesh

# name suffix -> spec; the first match wins
_COL_PARALLEL = (".query.weight", ".key.weight", ".value.weight", ".fc1.0.weight")
_COL_BIAS = (".query.bias", ".key.bias", ".value.bias", ".fc1.0.bias")
_ROW_PARALLEL = (".proj.weight", ".fc2.1.weight")


def param_spec(name: str) -> tuple:
    """The mesh axis of each dim of param `name` in the JAX layout (None:
    whole); () for a param that is whole on every rank."""
    if name.endswith(_COL_PARALLEL):
        return (None, MODEL_AXIS)
    if name.endswith(_COL_BIAS):
        return (MODEL_AXIS,)
    if name.endswith(_ROW_PARALLEL):
        return (MODEL_AXIS, None)
    return ()


def shard_params(params: Mapping[str, torch.Tensor], mesh: Mesh) -> dict[str, torch.Tensor]:
    """This rank's slice of every param of a flat upstream-layout dict:
    each split dim keeps its `mesh.index(axis)`-th contiguous part."""
    out = {}
    for name, v in params.items():
        spec = param_spec(name)
        if name.endswith(".weight") and v.ndim == 2:
            spec = spec[::-1]  # (in, out) in JAX, (out, in) here
        for dim, axis in enumerate(spec):
            if axis is None:
                continue
            n = mesh.shape[axis]
            if v.shape[dim] % n:
                raise ValueError(f"shard_params: {name} dim {dim} ({v.shape[dim]}) does not split {n} ways")
            size = v.shape[dim] // n
            v = v.narrow(dim, mesh.index(axis) * size, size)
        out[name] = v.contiguous()
    return out


def batch_spec() -> tuple:
    """Video batches split their leading (clip) axis over "data"."""
    return (DATA_AXIS,)
