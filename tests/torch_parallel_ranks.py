"""Rank programs for tests/test_torch_parallel.py, run in processes of
their own (torch.multiprocessing, spawn): this module imports torch and
the port only, so a rank starts without jax.

`Ranks` starts n ranks of one program over gloo (a file:// rendezvous
under the test's tmp_path, a 60 s collective timeout); each rank writes
its result to rank{r}.pt there; `join` waits for all with a timeout and
fails on a rank that raised or hung."""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

COLLECTIVE_TIMEOUT_S = 60


def make_inputs(seed: int, t: int, h: int, w: int, box=(16, 32, 20, 44)):
    """tests/test_sharding.py's clip: frames [1, T, H, W, 3] in [-1, 1],
    the box mask [1, T, H, W, 1] at rows box[0]:box[1], cols box[2]:box[3]
    (16:32, 20:44), original frames [T, H, W, 3] in [0, 255), numpy
    float32."""
    rng = np.random.default_rng(seed)
    frames = rng.uniform(-1, 1, (1, t, h, w, 3)).astype(np.float32)
    masks = np.zeros((1, t, h, w, 1), np.float32)
    masks[:, :, box[0] : box[1], box[2] : box[3]] = 1.0
    orig = rng.uniform(0, 255, (t, h, w, 3)).astype(np.float32)
    return frames, masks, orig


def _rank_main(program, rank: int, n: int, rendezvous: str, out_dir: str, args: tuple) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{rendezvous}", rank=rank, world_size=n,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S),
    )
    try:
        torch.save(program(*args), os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


class Ranks:
    """n ranks of `program(*args)`, started on construction."""

    def __init__(self, program, n: int, tmp_path, *args):
        self.dir = str(tmp_path)
        ctx = mp.get_context("spawn")
        rendezvous = os.path.join(self.dir, "rendezvous")
        self.procs = [
            ctx.Process(target=_rank_main, args=(program, r, n, rendezvous, self.dir, args)) for r in range(n)
        ]
        for p in self.procs:
            p.start()

    def join(self, timeout_s: float = 240.0) -> list:
        """Every rank's result, in rank order; raises if a rank failed or
        is still running after timeout_s (it is then terminated)."""
        deadline = datetime.datetime.now() + datetime.timedelta(seconds=timeout_s)
        for p in self.procs:
            p.join(max(0.0, (deadline - datetime.datetime.now()).total_seconds()))
        hung = [r for r, p in enumerate(self.procs) if p.is_alive()]
        for r in hung:
            self.procs[r].terminate()
            self.procs[r].join(10)
        assert not hung, f"ranks {hung} still running after {timeout_s} s"
        codes = [p.exitcode for p in self.procs]
        assert codes == [0] * len(codes), f"rank exit codes {codes}"
        return [torch.load(os.path.join(self.dir, f"rank{r}.pt")) for r in range(len(self.procs))]


def pipeline_program(
    model_parallel: int, env: dict, widgets: dict, seed: int, t: int, h: int, w: int, box=(16, 32, 20, 44), crop=None,
) -> dict:
    """One rank of `Pipeline.process` on `make_inputs(seed, t, h, w, box)`
    (with `crop`) with a mesh of the world's ranks (model_parallel of them
    on the model axis), CPU, random weights, fp32."""
    from comfyui_propainter_nodes_tpu_torch.config import PipelineConfig
    from comfyui_propainter_nodes_tpu_torch.parallel.mesh import make_mesh
    from comfyui_propainter_nodes_tpu_torch.pipeline.stages import Pipeline
    from comfyui_propainter_nodes_tpu_torch.utils import weights

    os.environ.update(env)
    mesh = make_mesh(model_parallel=model_parallel, device="cpu")
    params = [weights.get_params(m, allow_download=False, allow_random=True) for m in ("raft", "flow_completion", "inpaint_generator")]
    pipe = Pipeline(*params, PipelineConfig(**widgets, process_size=(w, h)), mesh=mesh)
    frames, masks, orig = (torch.from_numpy(a) for a in make_inputs(seed, t, h, w, box))
    out = pipe.process(frames, masks, masks, orig, crop)
    return dict(out=out, shape=dict(mesh.shape), coords=dict(mesh.coords), clip_parallel=pipe._clip_parallel(),
                seq=pipe._seq_selected(h))


def transformer_program(params: dict, tokens, fold_size, mask, tv) -> torch.Tensor:
    """One rank of `sequence_parallel_transformer` over all the world's
    ranks on the model axis."""
    from comfyui_propainter_nodes_tpu_torch.parallel.mesh import make_mesh
    from comfyui_propainter_nodes_tpu_torch.parallel.sequence import sequence_parallel_transformer

    mesh = make_mesh(model_parallel=dist.get_world_size(), device="cpu")
    return sequence_parallel_transformer(params, "transformers", tokens, fold_size, mask, mesh, t_valid_mask=tv)


def spatial_program(params: dict, args: tuple, num_local_frames: int, env: dict) -> torch.Tensor:
    """One rank of `spatial_parallel_window_predict` over all the world's
    ranks on the model axis (with the variables `env`): the whole
    predicted local frames."""
    from comfyui_propainter_nodes_tpu_torch.parallel.mesh import make_mesh
    from comfyui_propainter_nodes_tpu_torch.parallel.spatial import spatial_parallel_window_predict

    os.environ.update(env)
    mesh = make_mesh(model_parallel=dist.get_world_size(), device="cpu")
    return spatial_parallel_window_predict(params, mesh, num_local_frames)(*args)


def halo_program(x: torch.Tensor, bounds: list, cases: list) -> list:
    """One rank's `halo_rows` (for each (above, below, circular) of cases)
    and `gather_rows` of its rows `bounds[rank]` of x along dim 1."""
    from comfyui_propainter_nodes_tpu_torch.parallel.mesh import MODEL_AXIS, make_mesh
    from comfyui_propainter_nodes_tpu_torch.parallel.spatial import RowSplit

    mesh = make_mesh(model_parallel=dist.get_world_size(), device="cpu")
    rows = RowSplit(mesh, MODEL_AXIS, bounds, x.shape[1])
    mine = x[:, rows.lo : rows.hi]
    return [rows.halo(mine, a, b, 1, circ) for a, b, circ in cases] + [rows.gather(mine, 1)]


def train_program(model_parallel: int, raw: dict, batch: dict, num_local_frames: int, steps: int) -> dict:
    """One rank of the port's training step (`make_train_step` on a mesh of
    the world's ranks, model_parallel of them on the model axis, CPU) from
    the JAX-layout params raw, `steps` steps on the whole batch (numpy):
    each step's loss and the rank's params after the last."""
    from comfyui_propainter_nodes_tpu_torch.parallel.mesh import make_mesh
    from comfyui_propainter_nodes_tpu_torch.training.train_step import init_state, make_train_step
    from comfyui_propainter_nodes_tpu_torch.utils.params import from_jax_params

    mesh = make_mesh(model_parallel=model_parallel, device="cpu")
    state = init_state(from_jax_params(raw), mesh)
    step = make_train_step(mesh, num_local_frames)
    losses = []
    for _ in range(steps):
        state, loss = step(state, batch)
        losses.append(float(loss))
    return dict(losses=losses, params={k: v.detach() for k, v in state.params.items()}, shape=dict(mesh.shape),
                coords=dict(mesh.coords))
