"""Sharding rules: which dims of which parameters split over the mesh.

Counterpart of the JAX package's `parallel/sharding.py`, its rule table
copied: the transformer's q/k/v and FFN fc1 are column parallel (their
output dim splits over "model"), the attention proj and fc2 row parallel
(their input dim splits), everything else is whole on every rank; video
batches split their leading (clip) axis over "data". Specs name the dims
of the JAX checkpoint layout, where a linear weight is (in, out); the
port holds upstream (out, in) weights, so `shard_params` reverses a 2-D
weight's spec. Inference runs whole weights; the training step runs
each rank on its shards, with the collectives GSPMD inserts in the JAX
step written out (`copy_to`, `reduce_from`, `tensor_sharding`).
"""

from __future__ import annotations

from contextlib import contextmanager
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


# ---------------------------------------------------- tensor parallelism
#
# GSPMD inserts the JAX step's collectives; here they are written out, as
# Megatron places them: `copy_to` in front of each column-parallel layer
# (its input is whole on every rank; the ranks' gradients of it are
# partial and are summed), `reduce_from` behind each row-parallel one (its
# rank's partial product is summed; the gradient of the sum is whole on
# every rank). With them in place, every whole param gets its whole
# gradient on every model rank.


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh: Mesh, axis: str):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_reduce(grad, ctx.axis), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh: Mesh, axis: str):
        return mesh.all_reduce(x, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def copy_to(x: torch.Tensor, mesh: Mesh, axis: str = MODEL_AXIS) -> torch.Tensor:
    """x itself forward; backward, its gradient summed over `axis`."""
    return x if mesh.shape[axis] == 1 else _CopyTo.apply(x, mesh, axis)


def reduce_from(x: torch.Tensor, mesh: Mesh, axis: str = MODEL_AXIS) -> torch.Tensor:
    """x summed over `axis` forward; backward, the gradient as it is."""
    return x if mesh.shape[axis] == 1 else _ReduceFrom.apply(x, mesh, axis)


# (mesh, axis) while a tensor-parallel forward runs; the generator's
# transformer call (models/propainter.py) reads it, as it reads
# `sequence_active`
_ACTIVE: tuple[Mesh, str] | None = None


def tensor_active() -> tuple[Mesh, str] | None:
    return _ACTIVE


@contextmanager
def tensor_sharding(mesh: Mesh, axis: str = MODEL_AXIS):
    """Run the transformer stacks inside tensor-parallel over `axis`, on
    `shard_params` shards: each rank holds its heads of q/k/v and its
    share of the FFN's hidden channels (`ops/attention.py`, `tp`)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = (mesh, axis)
    try:
        yield
    finally:
        _ACTIVE = prev
