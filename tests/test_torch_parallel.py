"""The port's multi-device inference (`parallel/`, the mesh branches of
`pipeline/stages.py`) on the CPU: ranks are processes of their own over
gloo (tests/torch_parallel_ranks.py), each holding its whole output,
against the single-process port and against the JAX package on its
8-device virtual mesh, mirroring tests/test_sharding.py (same shapes and
seeds).

Tolerances: the single-process port bit for bit in fp32 (the ranks run the
same per-chunk arithmetic); the JAX package within one uint8 level (the
port's node tests' tolerance); the sequence-parallel transformer at atol
2e-5 (JAX's own test: the gathered keys reduce in another order); the
sequence-parallel pipeline within one level on less than 1e-4 of the
values (JAX's own test)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_propainter_nodes_tpu.config import PipelineConfig as JaxConfig
from comfyui_propainter_nodes_tpu.ops.attention import transformer_stack as jax_transformer_stack
from comfyui_propainter_nodes_tpu.parallel import mesh as jmesh
from comfyui_propainter_nodes_tpu.parallel import sharding as jsharding
from comfyui_propainter_nodes_tpu.parallel.sequence import sequence_parallel_transformer as jax_seq_transformer
from comfyui_propainter_nodes_tpu.pipeline.stages import Pipeline as JaxPipeline
from comfyui_propainter_nodes_tpu.utils import weights as jax_weights
from comfyui_propainter_nodes_tpu_torch.config import PipelineConfig
from comfyui_propainter_nodes_tpu_torch.ops.attention import transformer_stack
from comfyui_propainter_nodes_tpu_torch.parallel import mesh as tmesh
from comfyui_propainter_nodes_tpu_torch.parallel import sharding as tsharding
from comfyui_propainter_nodes_tpu_torch.pipeline.stages import Pipeline
from comfyui_propainter_nodes_tpu_torch.utils import weights
from comfyui_propainter_nodes_tpu_torch.utils.params import from_jax_params
from torch_parallel_ranks import Ranks, make_inputs, pipeline_program, transformer_program

torch.set_num_threads(1)

T, H, W = 16, 48, 64
MODELS = ("raft", "flow_completion", "inpaint_generator")
VARS = ("PROPAINTER_TPU_WINDOW_BATCH", "PROPAINTER_TPU_SEQ", "PROPAINTER_TPU_CLIP_PARALLEL")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in VARS:
        monkeypatch.delenv(k, raising=False)


def widgets(subvideo_length: int) -> dict:
    return dict(ref_stride=4, neighbor_length=4, subvideo_length=subvideo_length, raft_iter=1, fp16="disable")


def jax_process(seed: int, wd: dict, mesh=None) -> np.ndarray:
    params = [jax_weights.get_params(m, allow_random=True) for m in MODELS]
    frames, masks, orig = (jnp.asarray(a) for a in make_inputs(seed, T, H, W))
    pipe = JaxPipeline(*params, JaxConfig(**wd, process_size=(W, H)), mesh=mesh)
    return np.asarray(pipe.process(frames, masks, masks, orig))


def port_process(seed: int, wd: dict) -> np.ndarray:
    params = [weights.get_params(m, allow_random=True) for m in MODELS]
    frames, masks, orig = (torch.from_numpy(a) for a in make_inputs(seed, T, H, W))
    pipe = Pipeline(*params, PipelineConfig(**wd, process_size=(W, H)), device="cpu")
    return pipe.process(frames, masks, masks, orig).numpy()


def assert_within_one_level(out: np.ndarray, ref: np.ndarray, share: float = 1.0) -> None:
    d = np.abs(out - ref)
    assert d.max() <= 1.0 and (d > 0).mean() < share, f"max |d| {d.max()}, share > 0: {(d > 0).mean():.2e}"


def check_ranks(results, shape: dict, single: np.ndarray, jax_ref: np.ndarray, jax_share: float = 1.0) -> None:
    """Every rank: the mesh's shape, the whole video, the single-process
    port's bytes exactly, the JAX package's within one level."""
    for r, res in enumerate(results):
        assert res["shape"] == shape and res["coords"] == {"data": r // shape["model"], "model": r % shape["model"]}
        out = res["out"].numpy()
        assert out.shape == (T, H, W, 3)
        np.testing.assert_array_equal(out, single)
        assert_within_one_level(out, jax_ref, jax_share)


# ---------------------------------------------------------------- the mesh


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_mesh_shape_defaults_are_jax_make_mesh(n):
    assert jax.device_count() >= 8
    j = jmesh.make_mesh(n).shape
    assert tmesh.mesh_shape(n) == (j[jmesh.DATA_AXIS], j[jmesh.MODEL_AXIS])
    assert tmesh.DATA_AXIS == jmesh.DATA_AXIS and tmesh.MODEL_AXIS == jmesh.MODEL_AXIS


def test_param_spec_is_the_jax_rule_table():
    with open(os.path.join(os.path.dirname(tsharding.__file__), "..", "utils", "param_specs.json")) as f:
        names = [k for model in json.load(f).values() for k in model]
    for name in names:
        assert tsharding.param_spec(name) == tuple(jsharding.param_spec(name)), name
    # every rule of the table is met
    assert {tsharding.param_spec(n) for n in names} == {(), (None, "model"), ("model",), ("model", None)}
    assert tsharding.batch_spec() == tuple(jsharding.batch_spec())


def test_shard_params_slices_at_2x4():
    """tests/test_sharding.py's placement test at mesh (2, 4), with random
    values: each rank's slice of the upstream-layout weights is the JAX
    shard of its device, transposed where the layouts are."""
    rng = np.random.default_rng(0)
    q = "transformers.transformer.0.attention.query.weight"
    raw = {
        q: rng.standard_normal((512, 512)).astype(np.float32),
        "transformers.transformer.0.attention.query.bias": rng.standard_normal(512).astype(np.float32),
        "transformers.transformer.0.attention.proj.weight": rng.standard_normal((512, 512)).astype(np.float32),
        "transformers.transformer.0.mlp.fc1.0.weight": rng.standard_normal((512, 1960)).astype(np.float32),
        "encoder.layers.0.weight": rng.standard_normal((3, 3, 5, 64)).astype(np.float32),
    }
    jax_mesh = jmesh.make_mesh(8)
    sharded = jsharding.shard_params(raw, jax_mesh)
    port = from_jax_params(raw)
    for rank in range(8):
        mine = tsharding.shard_params(port, tmesh.Mesh(tmesh.mesh_shape(8), rank, "cpu"))
        device = jax_mesh.devices.flat[rank]
        for name, arr in sharded.items():
            (shard,) = [s for s in arr.addressable_shards if s.device == device]
            expected = from_jax_params({name: np.asarray(shard.data)})[name]
            torch.testing.assert_close(mine[name], expected, rtol=0, atol=0)
    assert tuple(mine[q].shape) == (128, 512)  # (512, 128) in JAX's (in, out)


# ----------------------------------------------------------- the pipelines


def test_clip_parallel_chunked_pipeline_2_data_ranks(tmp_path):
    """Stages 1-3's chunks (subvideo_length 6: 2 RAFT chunks, 3
    completion and 3 image-propagation chunks, padded to 4) split over 2
    data ranks; the windows too."""
    wd = widgets(6)
    ranks = Ranks(pipeline_program, 2, tmp_path, 1, {}, wd, 1, T, H, W)
    single = port_process(1, wd)
    jax_ref = jax_process(1, wd, jmesh.make_mesh(2, model_parallel=1))
    results = ranks.join()
    assert all(r["clip_parallel"] for r in results)
    check_ranks(results, {"data": 2, "model": 1}, single, jax_ref)


def test_window_data_parallel_4_ranks(tmp_path, monkeypatch):
    """tests/test_sharding.py's window test: 4 data ranks, windows in
    groups of 4 (PROPAINTER_TPU_WINDOW_BATCH), one chunk a stage."""
    env = {"PROPAINTER_TPU_WINDOW_BATCH": "4"}
    wd = widgets(80)
    ranks = Ranks(pipeline_program, 4, tmp_path, 1, env, wd, 0, T, H, W)
    monkeypatch.setenv("PROPAINTER_TPU_WINDOW_BATCH", "4")
    single = port_process(0, wd)
    jax_ref = jax_process(0, wd, jmesh.make_mesh(4, model_parallel=1))
    check_ranks(ranks.join(), {"data": 4, "model": 1}, single, jax_ref)


def test_sequence_parallel_pipeline_t_sel_not_dividing(tmp_path, monkeypatch):
    """Mesh (1, 2) at 48 rows: the feature stage's transformer split over
    2 model ranks; a window's T_sel of 7 (5 local + 2 reference slots)
    does not divide 2, so T is padded and the padding masked. JAX on its
    mesh (1, 2) under PROPAINTER_TPU_SEQ=1."""
    env = {"PROPAINTER_TPU_WINDOW_BATCH": "4", "PROPAINTER_TPU_SEQ": "1"}
    wd = widgets(80)
    ranks = Ranks(pipeline_program, 2, tmp_path, 2, env, wd, 2, T, H, W)
    monkeypatch.setenv("PROPAINTER_TPU_WINDOW_BATCH", "4")
    single = port_process(2, wd)
    monkeypatch.setenv("PROPAINTER_TPU_SEQ", "1")
    jax_ref = jax_process(2, wd, jmesh.make_mesh(2, model_parallel=2))
    results = ranks.join()
    assert all(r["seq"] and not r["clip_parallel"] for r in results)
    for r, res in enumerate(results):
        assert res["shape"] == {"data": 1, "model": 2} and res["coords"] == {"data": 0, "model": r}
        out = res["out"].numpy()
        assert out.shape == (T, H, W, 3)
        # the gathered-KV attention reduces in another order than the single-process kernel's plain version
        assert_within_one_level(out, single, 1e-4)
        assert_within_one_level(out, jax_ref, 1e-4)
    np.testing.assert_array_equal(results[0]["out"].numpy(), results[1]["out"].numpy())


def test_sequence_parallel_transformer_4_ranks(tmp_path):
    """tests/test_sharding.py's transformer test: 8 frames over 4 model
    ranks, the last frame padding, occupied windows, temporal dilation."""
    rng = np.random.default_rng(7)
    b, t, fh, fw, c = 1, 8, 10, 18, 512
    l_t, h4, w4 = 4, 28, 52
    raw = {k: v for k, v in jax_weights.random_params("inpaint_generator").items() if k.startswith("transformers.")}
    tokens = (rng.standard_normal((b, t, fh, fw, c)) * 0.1).astype(np.float32)
    mask = np.zeros((b, l_t, fh, fw, 1), np.float32)
    mask[:, :, 2:5, 3:10] = 1.0
    tv = np.asarray([True] * 7 + [False])
    port_params = from_jax_params(raw)
    args = (port_params, torch.from_numpy(tokens), (h4, w4), torch.from_numpy(mask), torch.from_numpy(tv))
    ranks = Ranks(transformer_program, 4, tmp_path, *args)
    single = transformer_stack(port_params, "transformers", args[1], (h4, w4), args[3], t_valid_mask=args[4])
    jax_ref = jax_seq_transformer(
        {k: jnp.asarray(v) for k, v in raw.items()}, "transformers", jnp.asarray(tokens), (h4, w4),
        jnp.asarray(mask), jmesh.make_mesh(4, model_parallel=4), t_valid_mask=jnp.asarray(tv),
    )
    for out in ranks.join():
        np.testing.assert_allclose(out.numpy(), np.asarray(jax_ref), atol=2e-5, rtol=1e-4)
        np.testing.assert_allclose(out.numpy(), single.numpy(), atol=2e-5, rtol=1e-4)


def test_model_ranks_choose_the_h_split_from_512_rows(monkeypatch):
    """mp > 1 at 512 rows or more is the spatial H split (the JAX package's
    rule), below it sequence parallelism; PROPAINTER_TPU_SEQ=1 / 0 forces
    the choice. The split itself runs in tests/test_torch_spatial.py."""
    pipe = Pipeline({}, {}, {}, PipelineConfig(**widgets(80), process_size=(16, 512)), mesh=tmesh.Mesh((1, 2), 0, "cpu"))
    assert not pipe._seq_selected(512) and pipe._seq_selected(511)
    monkeypatch.setenv("PROPAINTER_TPU_SEQ", "1")
    assert pipe._seq_selected(512)
    monkeypatch.setenv("PROPAINTER_TPU_SEQ", "0")
    assert not pipe._seq_selected(511)
    one = Pipeline({}, {}, {}, PipelineConfig(**widgets(80), process_size=(16, 512)), mesh=tmesh.Mesh((2, 1), 0, "cpu"))
    assert not one._seq_selected(511)  # one model rank: neither form
