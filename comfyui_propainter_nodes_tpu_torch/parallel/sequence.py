"""Sequence parallelism for the temporal sparse transformer.

Counterpart of the JAX package's `parallel/sequence.py`. The masked
windows attend over all frames, which couples every T position: the
tokens [B, T, f_h, f_w, C] split over T on the mesh's model axis
(contiguous shares); queries, layer norms, the FFN and the clean-window
branch stay frame-local; the occupied branch all-gathers K, V and the
pooled K/V over the shares and builds its window and rolled segments
from the gathered K/V (`ops/attention.py`, `seq`). With 4 heads, a head
scatter would stop at 4 ranks; gathered K/V scales with the axis.
"""

from __future__ import annotations

from contextlib import contextmanager

import torch
import torch.nn.functional as F

from ..ops.attention import transformer_stack
from .mesh import MODEL_AXIS, Mesh

# (mesh, axis) while a sequence-parallel forward runs; the generator's
# transformer call (models/propainter.py) reads it, so the feature stage
# picks T-sharding per resolution without the model taking a mesh
_ACTIVE: tuple[Mesh, str] | None = None


def sequence_active() -> tuple[Mesh, str] | None:
    return _ACTIVE


@contextmanager
def sequence_sharding(mesh: Mesh, axis: str = MODEL_AXIS):
    """Route the transformer stacks run inside to
    `sequence_parallel_transformer` over `axis`."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = (mesh, axis)
    try:
        yield
    finally:
        _ACTIVE = prev


def sequence_parallel_transformer(
    params, pre: str, tokens: torch.Tensor, fold_size, mask: torch.Tensor, mesh: Mesh,
    depths: int = 8, t_dilation: int = 2, t_valid_mask: torch.Tensor | None = None, axis: str = MODEL_AXIS,
) -> torch.Tensor:
    """The transformer stack with T split over `axis`.

    tokens [B, T, f_h, f_w, C], the same on every rank of the axis; T is
    zero-padded up to a multiple of the axis size, the padded frames
    masked out through t_valid_mask (the attention's key masks drop
    them: exact), and the gathered output sliced back to T.
    mask [B, l_t, H, W, 1] is the whole sparsity mask."""
    t_in = tokens.shape[1]
    n = mesh.shape[axis]
    t = -(-t_in // n) * n
    tv = t_valid_mask if t_valid_mask is not None else torch.ones(t_in, dtype=torch.bool)
    tv = tv.to(tokens.device)
    if t != t_in:
        tokens = F.pad(tokens, (0, 0, 0, 0, 0, 0, 0, t - t_in))
        tv = torch.cat([tv, tv.new_zeros(tv.shape[:-1] + (t - t_in,))], dim=-1)
    share = t // n
    i = mesh.index(axis)
    out = transformer_stack(
        params, pre, tokens[:, i * share : (i + 1) * share], fold_size, mask,
        depths=depths, t_dilation=t_dilation, t_valid_mask=tv, seq=(mesh, axis), t_total=t,
    )
    return mesh.all_gather(out, axis, dim=1)[:, :t_in]
