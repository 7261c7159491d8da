"""The port's training step on gloo ranks (processes of their own,
tests/torch_parallel_ranks.py::train_program) on the CPU, mirroring
tests/test_sharding.py::test_sharded_step_matches_single_device:

  * mesh (2, 2), data and tensor parallelism, one step on JAX's test batch
    (b 2, l_t 2, n_ref 1, 32x40, zero flows), against the single-process
    port and JAX's `make_train_step` on make_mesh(1): every rank's loss
    within rtol 2e-5 of both; the rank's shard of every param within
    atol 1e-5, rtol 1e-4 (JAX's bounds) of the single process's, and of
    the tensor-parallel q/k/v, proj, fc1 and fc2 weights and the pooling
    conv's weight of JAX's;
  * mesh (2, 1), data parallelism over two clips with unequal masks (0.5
    and 0.05 of the pixels), against the single process: the loss (the
    global one, which the mean of the two clips' losses is not) and every
    param at the same bounds."""

import numpy as np
import torch

from comfyui_propainter_nodes_tpu.utils.weights import random_params
from comfyui_propainter_nodes_tpu_torch.parallel.mesh import Mesh
from comfyui_propainter_nodes_tpu_torch.parallel.sharding import shard_params
from comfyui_propainter_nodes_tpu_torch.training import train_step as tts
from comfyui_propainter_nodes_tpu_torch.utils.params import from_jax_params
from test_torch_training import L_T, _jax_steps, tiny_batch
from torch_parallel_ranks import Ranks, train_program

torch.set_num_threads(1)

SPLIT = (".attention.query.weight", ".attention.key.weight", ".attention.value.weight", ".attention.proj.weight",
         ".mlp.fc1.0.weight", ".mlp.fc2.1.weight", ".attention.pool_layer.weight")


def single_step(raw, batch):
    state = tts.init_state(from_jax_params(raw), device="cpu")
    state, loss = tts.make_train_step(None, L_T)(state, batch)
    return loss.item(), {k: v.detach() for k, v in state.params.items()}


def assert_close(got: dict, want: dict, keys) -> None:
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=1e-5, rtol=1e-4, err_msg=k)


def check_ranks(results, shape, loss, params, jax_checks=None) -> None:
    n = shape[0] * shape[1]
    assert len(results) == n
    for r, res in enumerate(results):
        assert res["shape"] == {"data": shape[0], "model": shape[1]}
        assert res["coords"] == {"data": r // shape[1], "model": r % shape[1]}
        mesh = Mesh(shape, r, "cpu")
        np.testing.assert_allclose(res["losses"][0], loss, rtol=2e-5)
        want = shard_params(params, mesh)
        assert res["params"].keys() == want.keys()
        assert_close(res["params"], want, want)
        if jax_checks is not None:
            jloss, jparams = jax_checks
            np.testing.assert_allclose(res["losses"][0], jloss, rtol=2e-5)
            assert_close(res["params"], shard_params(jparams, mesh), [k for k in want if k.endswith(SPLIT)])


def test_mesh_2x2_step_matches_single_and_jax(tmp_path):
    raw, batch = random_params("inpaint_generator"), tiny_batch()
    ranks = Ranks(train_program, 4, tmp_path, 2, raw, batch, L_T, 1)
    loss, params = single_step(raw, batch)
    jl, jp = _jax_steps(raw, batch, L_T, 1)
    results = ranks.join()
    assert any(v.shape != params[k].shape for k, v in results[1]["params"].items())  # the ranks hold shards
    check_ranks(results, (2, 2), loss, params, (jl[0], from_jax_params(jp)))


def test_data_parallel_loss_is_global(tmp_path):
    raw = random_params("inpaint_generator")
    batch = tiny_batch()
    rng = np.random.default_rng(9)
    for i, density in enumerate((0.5, 0.05)):
        batch["masks"][i] = (rng.uniform(size=batch["masks"][i].shape) < density).astype(np.float32)
    ranks = Ranks(train_program, 2, tmp_path, 1, raw, batch, L_T, 1)
    loss, params = single_step(raw, batch)
    per_clip = [single_step(raw, {k: v[i : i + 1] for k, v in batch.items()})[0] for i in range(2)]
    assert abs(np.mean(per_clip) - loss) > 1e-3 * loss  # a mean of the ranks' losses would be another number
    check_ranks(ranks.join(), (2, 1), loss, params)
