"""Gradients through the port's kernels: the kernel runs forward, the
backward is its plain version's.

The JAX package has no backward kernel (no Pallas kernel has a
`custom_vjp`); its training step differentiates the kernels' XLA twins,
which are what it runs off a TPU. The port's counterpart is `TwinGrad`:
its forward launches the kernel, and its backward re-runs the wrapper's
plain version under `torch.enable_grad()` on detached copies of the saved
inputs and returns `torch.autograd.grad` of that, for the floating
inputs the kernel's gradient covers (occupancy, additive biases, row
origins and shapes get None). A wrapper takes it only when grad mode is on
and one of those inputs requires grad (`wants_grad`): under
`torch.inference_mode()` or `torch.no_grad()` the kernel launches as it
always did. Kernels whose outputs nothing differentiates (B1, B6, B7)
call `forward_only`, which raises where a gradient is asked for, so that
no kernel output silently lacks a `grad_fn`.
"""

from __future__ import annotations

import torch


def wants_grad(*tensors) -> bool:
    """Grad mode is on and one of the tensors (None allowed) requires grad."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def forward_only(name: str, *tensors) -> None:
    """Raise where a gradient through a forward-only kernel is asked for."""
    if wants_grad(*tensors):
        raise ValueError(
            f"{name}: the kernel has no backward; call it under torch.no_grad() or "
            "torch.inference_mode(), or on inputs that do not require grad"
        )


class TwinGrad(torch.autograd.Function):
    """launch(*inputs, **kw) forward; backward: the gradients of
    plain(*inputs, **kw) with respect to the first n_diff inputs (None
    for the others). inputs are tensors or None."""

    @staticmethod
    def forward(ctx, launch, plain, n_diff: int, kw: dict, *inputs):
        ctx.plain, ctx.n_diff, ctx.kw = plain, n_diff, kw
        ctx.save_for_backward(*inputs)
        return launch(*inputs, **kw)

    @staticmethod
    def backward(ctx, grad):
        inputs = ctx.saved_tensors
        needs = [i < ctx.n_diff and ctx.needs_input_grad[4 + i] for i in range(len(inputs))]
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(n) for t, n in zip(inputs, needs)]
            out = ctx.plain(*leaves, **ctx.kw)
            got = iter(torch.autograd.grad(out, [t for t, n in zip(leaves, needs) if n], grad))
        return (None, None, None, None) + tuple(next(got) if n else None for n in needs)


def twin_grad(name: str, launch, plain, n_diff: int, inputs: tuple, **kw):
    """`TwinGrad` for CUDA inputs; fp32 only (the training step's
    precision, as in the JAX package): other dtypes raise."""
    if inputs[0].dtype != torch.float32:
        raise ValueError(f"{name}: gradients are computed for fp32 inputs only, got {inputs[0].dtype}")
    return TwinGrad.apply(launch, plain, n_diff, kw, *inputs)
