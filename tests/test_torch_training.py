"""The port's training step (`training/`) against the JAX package's, on
the CPU: the losses, AdamW against optax's adamw, the kernels' twin
gradients (`ops/cuda/_grad.py::TwinGrad`), and JAX's `make_train_step` on
`make_mesh(1)` at its own test case (b 2, l_t 2, n_ref 1, 32x40, zero
flows: tests/test_sharding.py::_tiny_batch).

Tolerances: the losses rtol 1e-6 (fp32, a few sums); AdamW rtol 1e-6 (the
same arithmetic, fp32); the twin gradients by `gradcheck` in float64; the
step's losses rtol 2e-5 (JAX's own test's). The step's params after two
fp32 steps cannot all hold JAX's atol 1e-5, rtol 1e-4: in fp32 this
problem's gradients are resolved to about 1e-5 of the largest one (the
port's own fp32 gradient of the offset net's conv_offset.4 weight is 4%
of that tensor's largest entry away from its float64 gradient: bilinear
sampling and leaky ReLU switch sides on rounding), and AdamW moves a
component by about lr whatever its size, so a component whose gradient
sign rounds apart lands up to 2 lr a step away. The fp32 test holds the
share of such components (under 2e-3; 8.1e-4 measured) and their bound
(2 lr a step); the
float64 test in tests/test_torch_training_steps.py holds every param at
JAX's bounds.

The generator loss's gradient (`training/train_step.py::loss_fn`) is held
against `jax.grad` of the same loss, built from the JAX package's public
`inpaint_generator_forward` and `reconstruction_loss`, in float64 at the
same case with seeded smooth flows, so that the warps and the deformable
samples leave the integer grid (where bilinear sampling has kinks): each
tensor within 1e-9 of its largest |g| (5.2e-15 measured). The attention
key biases' gradients are zero in exact arithmetic (a key bias adds one
constant to all of a query's logits, which softmax ignores): both sides
are rounding noise there (about 1e-21 against a largest gradient of
0.12), so they are held at 1e-9 of the largest gradient of all."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from comfyui_propainter_nodes_tpu.models.propainter import inpaint_generator_forward
from comfyui_propainter_nodes_tpu.parallel.mesh import make_mesh
from comfyui_propainter_nodes_tpu.training import losses as jlosses
from comfyui_propainter_nodes_tpu.training import train_step as jts
from comfyui_propainter_nodes_tpu.utils.weights import random_params
from comfyui_propainter_nodes_tpu_torch.ops.cuda import deform_conv as b2
from comfyui_propainter_nodes_tpu_torch.ops.cuda import window_attention as b34
from comfyui_propainter_nodes_tpu_torch.ops.cuda import window_attention_halo as b5
from comfyui_propainter_nodes_tpu_torch.ops.cuda._grad import TwinGrad
from comfyui_propainter_nodes_tpu_torch.training import losses as tlosses
from comfyui_propainter_nodes_tpu_torch.training import train_step as tts
from comfyui_propainter_nodes_tpu_torch.utils.checkpoint import convert_state_dict
from comfyui_propainter_nodes_tpu_torch.utils.params import from_jax_params

torch.set_num_threads(1)

LR = 1e-4


def tiny_batch(b=2, l_t=2, n_ref=1, h=32, w=40, seed=0, flows=None):
    """tests/test_sharding.py::_tiny_batch as numpy: uniform frames, masks
    of density 0.2, zero flows (or `flows(rng, shape)`)."""
    rng = np.random.default_rng(seed)
    t = l_t + n_ref
    batch = {
        "frames": rng.uniform(-1, 1, (b, t, h, w, 3)).astype(np.float32),
        "masks": (rng.uniform(size=(b, t, h, w, 1)) > 0.8).astype(np.float32),
    }
    for k in ("flows_f", "flows_b"):
        shape = (b, l_t - 1, h, w, 2)
        batch[k] = np.zeros(shape, np.float32) if flows is None else flows(rng, shape).astype(np.float32)
    return batch


# ------------------------------------------------------------------ losses


@pytest.mark.parametrize("empty", [False, True])
def test_losses_match_jax(empty):
    rng = np.random.default_rng(3)
    pred = rng.uniform(-1, 1, (2, 3, 8, 10, 3)).astype(np.float32)
    target = rng.uniform(-1, 1, (2, 3, 8, 10, 3)).astype(np.float32)
    mask = np.zeros((2, 3, 8, 10, 1), np.float32) if empty else (rng.uniform(size=(2, 3, 8, 10, 1)) > 0.7).astype(np.float32)
    j = [jnp.asarray(a) for a in (pred, target, mask)]
    t = [torch.from_numpy(a) for a in (pred, target, mask)]
    np.testing.assert_allclose(float(tlosses.l1(*t[:2])), float(jlosses.l1(*j[:2])), rtol=1e-6)
    np.testing.assert_allclose(float(tlosses.masked_l1(*t)), float(jlosses.masked_l1(*j)), rtol=1e-6)
    np.testing.assert_allclose(
        float(tlosses.reconstruction_loss(*t, 2.0, 0.5)), float(jlosses.reconstruction_loss(*j, 2.0, 0.5)), rtol=1e-6
    )
    if empty:  # the hole term is 0 / 1e-8
        assert float(tlosses.masked_l1(*t)) == 0.0


# -------------------------------------------------------------- optimizer


def test_adamw_is_optax_adamw():
    """Three steps on a seeded dict with seeded gradients: decoupled decay
    on the pre-step params, eps outside the root (eps_root 0)."""
    rng = np.random.default_rng(5)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in (("a", (4, 6)), ("b", (7,)))}
    grads = [{k: (rng.standard_normal(v.shape) * 10.0 ** rng.integers(-9, 1, v.shape)).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    opt = jts.make_optimizer(LR)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = opt.init(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    topt = tts.make_optimizer(tp.values(), LR)
    for g in grads:
        upd, js = opt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        for k, v in tp.items():
            v.grad = torch.from_numpy(g[k])
        topt.step()
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=0)


# -------------------------------------------------- the kernels' gradients


def _b2_args(rng):
    n, h, w, cin, cout, g = 1, 5, 6, 4, 3, 2
    x = rng.standard_normal((n, h, w, cin))
    offset = rng.uniform(-1.7, 1.7, (n, h, w, g, 9, 2)) + 0.31  # off the integer grid
    mask = rng.uniform(0.1, 1.0, (n, h, w, g, 9))
    weight = rng.standard_normal((cout, cin, 3, 3)) * 0.3
    bias = rng.standard_normal(cout) * 0.1
    return (x, offset, mask, weight, bias), dict(padding=1, row0=0), 5


def _b34_args(rng):
    nw, nh, t, wsz, ch, rl, pl = 4, 2, 2, 3, 4, 5, 3
    b = 2
    f = [rng.standard_normal(s) for s in [(nw, nh, t, wsz, ch)] * 3 + [(nw, nh, rl, ch)] * 2 + [(b, nh, pl, ch)] * 2]
    occ = np.array([True, False, True, True])
    biases = [np.where(rng.uniform(size=(b, n)) > 0.2, 0.0, -1e9) for n in (t * wsz, rl, pl)]
    return (*f, occ, *biases), dict(n_win_per_b=nw // b), 7


def _b5_args(rng):
    b, t, ts, c, nh = 1, 2, 1, 4, 2
    ws = (3, 5)
    hp, wp = 3, 10
    eh, ew = 2, 3
    f = [rng.standard_normal((b, t, hp, wp, c)) for _ in range(3)]
    f += [rng.standard_normal((b, ts, hp + 2 * eh, wp + 2 * ew, c)) for _ in range(2)]
    f += [rng.standard_normal((b, nh, 3, c // nh)) for _ in range(2)]
    occ = np.array([[True, False]])
    biases = [np.zeros((b, t * 15)), np.zeros((b, ts)), np.zeros((b, 3))]
    return (*f, occ, *biases), dict(window_size=ws, n_head=nh), 7


CASES = {
    "B2": (b2.deform_conv2d_plain, _b2_args),
    "B3": (b34.window_attention_plain, _b34_args),
    "B4": (b34.window_attention_tiled_plain, _b34_args),
    "B5": (b5.window_attention_halo_plain, _b5_args),
}


@pytest.mark.parametrize("kernel", sorted(CASES))
def test_twin_grad_function(kernel):
    """`TwinGrad` with the launch replaced by the plain version: gradcheck
    in float64 over the differentiable inputs, and None for the others
    (occupancy, biases) even where they require grad."""
    plain, make = CASES[kernel]
    arrays, kw, n_diff = make(np.random.default_rng(11))
    inputs = [torch.from_numpy(np.asarray(a)) for a in arrays]

    def fn(*diff):
        return TwinGrad.apply(plain, plain, n_diff, kw, *diff, *inputs[n_diff:])

    diff = [t.double().requires_grad_() for t in inputs[:n_diff]]
    assert torch.autograd.gradcheck(fn, diff, eps=1e-6, atol=1e-6)
    rest = [t.double().requires_grad_() if t.is_floating_point() else t for t in inputs[n_diff:]]
    out = TwinGrad.apply(plain, plain, n_diff, kw, *diff, *rest)
    out.sum().backward()
    assert all(t.grad is not None for t in diff)
    assert all(t.grad is None for t in rest)


# ---------------------------------------------------------------- the step


L_T = 2


def smooth_flows(rng, shape):
    """Seeded smooth flows [B, n, H, W, 2]: per map and component a sine
    across the frame plus an offset, a pixel or two, off the integer grid."""
    b, n, h, w, _ = shape
    yy, xx = np.meshgrid(np.arange(h) / h, np.arange(w) / w, indexing="ij")
    out = np.empty(shape)
    for i in np.ndindex(b, n, 2):
        amp, fy, fx, phase, shift = rng.uniform([0.5, 0.5, 0.5, 0.0, -1.5], [2.0, 2.0, 2.0, 6.3, 1.5])
        out[i[0], i[1], ..., i[2]] = amp * np.sin(2 * np.pi * (fy * yy + fx * xx) + phase) + shift + 0.137
    return out


def batch64():
    return {k: v.astype(np.float64) for k, v in tiny_batch(flows=smooth_flows).items()}


def raw64():
    return {k: v.astype(np.float64) for k, v in random_params("inpaint_generator").items()}


def test_loss_gradient_matches_jax_float64():
    raw, batch = raw64(), batch64()

    def jax_loss(p, bt):
        m, fr = bt["masks"], bt["frames"]
        pred = inpaint_generator_forward(p, fr * (1 - m), bt["flows_f"], bt["flows_b"], m, m, L_T)
        return jlosses.reconstruction_loss(pred, fr[:, :L_T], m[:, :L_T])

    with jax.enable_x64(True):
        jl, jg = jax.jit(jax.value_and_grad(jax_loss))(
            {k: jnp.asarray(v) for k, v in raw.items()}, {k: jnp.asarray(v) for k, v in batch.items()}
        )
        jg = {k: np.asarray(v) for k, v in jg.items()}
    params = {k: v.requires_grad_() for k, v in from_jax_params(raw).items()}
    loss = tts.loss_fn(params, {k: torch.from_numpy(v) for k, v in batch.items()}, L_T)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-12)
    tg = convert_state_dict({k: torch.zeros_like(v) if v.grad is None else v.grad for k, v in params.items()})
    assert tg.keys() == jg.keys()
    gmax = max(np.abs(g).max() for g in jg.values())
    for k, g in jg.items():
        scale = gmax if k.endswith(".attention.key.bias") else np.abs(g).max()
        err = np.abs(tg[k] - g).max()
        assert err <= 1e-9 * scale, f"{k}: max |d| {err}, scale {scale}"


def _jax_steps(raw, batch, l_t, steps):
    mesh = make_mesh(1)
    state = jts.init_state(raw, mesh)
    step = jts.make_train_step(mesh, num_local_frames=l_t)
    losses = []
    for _ in range(steps):
        state, loss = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        losses.append(float(loss))
    return losses, {k: np.asarray(v) for k, v in state.params.items()}


def _port_steps(raw, batch, l_t, steps):
    state = tts.init_state(from_jax_params(raw), device="cpu")
    step = tts.make_train_step(None, l_t)
    losses = []
    for _ in range(steps):
        state, loss = step(state, batch)
        losses.append(float(loss))
    return losses, convert_state_dict(state.params)


def test_train_step_matches_jax():
    """Two fp32 steps of JAX's `make_train_step` on make_mesh(1) and the
    port's, from the same weights, on JAX's test batch: each step's loss;
    every param, in JAX's layout: all but a share under 2e-3 of the
    components within JAX's bounds, every component within 2 lr a step
    (see the module docstring)."""
    raw = random_params("inpaint_generator")
    batch = tiny_batch()
    jl, jp = _jax_steps(raw, batch, L_T, 2)
    tl, tp = _port_steps(raw, batch, L_T, 2)
    np.testing.assert_allclose(tl, jl, rtol=2e-5)
    assert tp.keys() == jp.keys()
    off = total = 0
    for k, ref in jp.items():
        d = np.abs(tp[k] - ref)
        assert d.max() <= 2 * 2 * LR * (1 + 1e-3), (k, d.max())
        off += int((d > 1e-5 + 1e-4 * np.abs(ref)).sum())
        total += d.size
    assert off < 2e-3 * total, f"{off} of {total} components outside JAX's bounds"
