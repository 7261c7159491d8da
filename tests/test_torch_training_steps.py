"""Two training steps of the port against two of the JAX package's
`make_train_step` on make_mesh(1), in float64 on the CPU (JAX's state
built with its `make_optimizer`), at JAX's step test case (b 2, l_t 2,
n_ref 1, 32x40) with the seeded smooth flows of
tests/test_torch_training.py: each step's loss rtol 2e-5 and every param
after the second step within atol 1e-5, rtol 1e-4 (JAX's own bounds,
tests/test_sharding.py), which fp32 cannot give for every component
(tests/test_torch_training.py says why)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from comfyui_propainter_nodes_tpu.parallel.mesh import make_mesh
from comfyui_propainter_nodes_tpu.training import train_step as jts
from comfyui_propainter_nodes_tpu_torch.training import train_step as tts
from comfyui_propainter_nodes_tpu_torch.utils.checkpoint import convert_state_dict
from comfyui_propainter_nodes_tpu_torch.utils.params import from_jax_params
from test_torch_training import L_T, batch64, raw64

torch.set_num_threads(1)


def test_train_steps_match_jax_float64():
    raw, batch = raw64(), batch64()
    with jax.enable_x64(True):
        jp = {k: jnp.asarray(v) for k, v in raw.items()}
        state = jts.TrainState(jp, jts.make_optimizer().init(jp), jnp.zeros((), jnp.int32))
        step = jts.make_train_step(make_mesh(1), num_local_frames=L_T)
        jl = []
        for _ in range(2):
            state, loss = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
            jl.append(float(loss))
        jp = {k: np.asarray(v) for k, v in state.params.items()}
    leaves = {k: v.requires_grad_() for k, v in from_jax_params(raw).items()}
    tstate = tts.TrainState(leaves, tts.make_optimizer(leaves.values()), 0)
    tstep = tts.make_train_step(None, L_T)
    tl = []
    for _ in range(2):
        tstate, loss = tstep(tstate, batch)
        tl.append(float(loss))
    assert tstate.step == 2 and next(iter(tstate.params.values())).dtype == torch.float64
    np.testing.assert_allclose(tl, jl, rtol=2e-5)
    tp = convert_state_dict(tstate.params)
    assert tp.keys() == jp.keys()
    for k, ref in jp.items():
        np.testing.assert_allclose(tp[k], ref, atol=1e-5, rtol=1e-4, err_msg=k)
