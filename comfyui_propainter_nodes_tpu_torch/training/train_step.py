"""Training step for the InpaintGenerator (port of the JAX package's
`training/train_step.py`).

Data parallelism over clips on the mesh's "data" axis, Megatron tensor
parallelism over the transformer's width on "model"
(`parallel/sharding.py`: `shard_params`, `copy_to`, `reduce_from`,
`tensor_sharding`), AdamW (lr 1e-4, betas (0.9, 0.99), eps 1e-8 outside
the root, decoupled weight decay 1e-4 on the pre-step params: optax's
`adamw` step). The JAX step leaves the collectives to GSPMD; here they are
written out:
  * each rank takes its contiguous share of the batch's clips;
  * `masked_l1`'s numerator and denominator are summed over the data
    ranks before the division (`reduce_from`), so every rank's loss is
    the global one;
  * the transformer's collectives sit in the forward (`copy_to` before
    each column-parallel layer, `reduce_from` after each row-parallel
    one), so every whole param gets its whole gradient on every model
    rank;
  * after the backward, every gradient is summed over the data ranks.
Each rank's optimizer holds its own shards. The forward runs B2 and the
window-attention kernel on the card, each differentiable through its
plain version (ops/cuda/_grad.py), in fp32 with TF32 off (`full_fp32`).
The step's three parts are stage timers (`utils/profiling.py`):
"train_forward", "train_backward" (the gradient sum over the data ranks
included) and "train_update".
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from ..models.propainter import inpaint_generator_forward
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh
from ..parallel.sharding import reduce_from, shard_params, tensor_sharding
from ..pipeline.stages import full_fp32
from ..utils.profiling import stage_timer
from .losses import reconstruction_loss

BATCH_KEYS = ("frames", "masks", "flows_f", "flows_b")


class TrainState(NamedTuple):
    params: dict  # name -> leaf tensor (the rank's shard of a split param)
    opt_state: torch.optim.Optimizer
    step: int


def make_optimizer(params, lr: float = 1e-4) -> torch.optim.AdamW:
    return torch.optim.AdamW(list(params), lr=lr, betas=(0.9, 0.99), eps=1e-8, weight_decay=1e-4)


def init_state(params: dict, mesh: Mesh | None = None, lr: float = 1e-4, device=None) -> TrainState:
    """Trainable fp32 copies of upstream-layout params (`get_params`,
    `from_jax_params`; never shared with the caller's tensors): the rank's
    shards under a mesh, on the mesh's device, else on `device` (the card
    by default)."""
    if mesh is not None:
        dev = mesh.device
        params = shard_params(params, mesh)
    else:
        dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_state: no CUDA card; pass device='cpu' to train on the host")
    leaves = {k: v.detach().to(dev, torch.float32, copy=True).requires_grad_() for k, v in params.items()}
    return TrainState(leaves, make_optimizer(leaves.values(), lr), 0)


def _rank_clips(a, mesh: Mesh | None, like: torch.Tensor) -> torch.Tensor:
    """The rank's contiguous share of the clips (leading axis) of a batch
    array, in the params' dtype (`like`'s: fp32 from `init_state`) on
    their device; an inference tensor is cloned (autograd cannot save one
    for backward)."""
    a = torch.as_tensor(a).to(like.device, like.dtype)
    if mesh is not None and mesh.shape[DATA_AXIS] > 1:
        dp = mesh.shape[DATA_AXIS]
        if a.shape[0] % dp:
            raise ValueError(f"train step: {a.shape[0]} clips do not split over {dp} data ranks")
        n = a.shape[0] // dp
        a = a[mesh.index(DATA_AXIS) * n : (mesh.index(DATA_AXIS) + 1) * n]
    return a.clone() if a.is_inference() else a


def loss_fn(params: dict, batch: dict, num_local_frames: int, total=None) -> torch.Tensor:
    """The JAX step's loss: `reconstruction_loss` of the generator on the
    masked frames (masks as both the input and the updated masks) against
    the local frames. total: the sum over the data ranks (None: one rank)."""
    frames, masks = batch["frames"], batch["masks"]
    pred = inpaint_generator_forward(
        params, frames * (1.0 - masks), batch["flows_f"], batch["flows_b"], masks, masks, num_local_frames
    )
    l_t = num_local_frames
    return reconstruction_loss(pred, frames[:, :l_t], masks[:, :l_t], total=total)


def _sum_grads(params: dict, mesh: Mesh) -> None:
    """Every gradient summed over the data ranks, in one all_reduce."""
    grads = [p.grad for p in params.values()]
    flat = mesh.all_reduce(torch.cat([g.reshape(-1) for g in grads]), DATA_AXIS)
    off = 0
    for g in grads:
        g.copy_(flat[off : off + g.numel()].view_as(g))
        off += g.numel()


def make_train_step(mesh: Mesh | None, num_local_frames: int, lr: float = 1e-4):
    """The step: step(state, batch) -> (state, loss), the global loss.

    Batch dict (leading axis = clips, split over "data"; arrays or tensors):
      frames  [B, T, H, W, 3] target frames in [-1, 1]
      masks   [B, T, H, W, 1]
      flows_f/flows_b [B, l_t-1, H, W, 2]
    The state's params and optimizer are updated in place."""
    dp = 1 if mesh is None else mesh.shape[DATA_AXIS]
    tp = mesh is not None and mesh.shape[MODEL_AXIS] > 1
    total = (lambda s: reduce_from(s, mesh, DATA_AXIS)) if dp > 1 else None

    def step(state: TrainState, batch: dict):
        params, opt = state.params, state.opt_state
        like = next(iter(params.values()))
        rank_batch = {k: _rank_clips(batch[k], mesh, like) for k in BATCH_KEYS}
        fp32 = full_fp32() if like.is_cuda else contextlib.nullcontext()
        split = tensor_sharding(mesh) if tp else contextlib.nullcontext()
        for group in opt.param_groups:
            group["lr"] = lr
        with fp32:
            with split, stage_timer("train_forward"):
                loss = loss_fn(params, rank_batch, num_local_frames, total)
            opt.zero_grad(set_to_none=True)
            with stage_timer("train_backward"):
                loss.backward()
                for p in params.values():
                    if p.grad is None:  # optax decays a param that the loss does not reach; AdamW skips it
                        p.grad = torch.zeros_like(p)
                if dp > 1:
                    _sum_grads(params, mesh)
            with stage_timer("train_update"):
                opt.step()
        return TrainState(params, opt, state.step + 1), loss.detach()

    return step
