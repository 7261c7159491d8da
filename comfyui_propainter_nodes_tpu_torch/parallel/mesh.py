"""The rank mesh: the ranks of a torch.distributed process group as a
(data, model) grid.

Counterpart of the JAX package's `parallel/mesh.py`:
  * "data":  clip and window parallelism: each data rank runs whole
             per-chunk or per-window programs on its contiguous share of
             a batch, and the results are all-gathered
             (`pipeline/stages.py::Pipeline._chunk_mapped`);
  * "model": sequence parallelism of the transformer: tokens split over
             T, the attention's key/value segments all-gathered
             (`parallel/sequence.py`), or the frames' rows
             (`parallel/spatial.py`); in training, the transformer's
             width (tensor parallelism, `parallel/sharding.py`).
Rank r sits at (r // model, r % model), as device r of the JAX mesh. The
collectives are `Mesh.all_gather`, tiled along one tensor dim like
`jax.lax.all_gather(..., tiled=True)`, and `Mesh.all_reduce`, a sum (the
training step's tensor-parallel products, loss sums and gradients); the
spatial H split's halos move point to point (`Mesh.send_recv`).

Backend: NCCL when every rank has a card of its own, gloo when ranks
share a card or run on the CPU (`backend_for`). Gloo all-gathers and
all-reduces CUDA tensors itself but sends and receives
only host tensors, so `send_recv` passes a card's tensors through the
host under gloo; where a backend does not take a tensor, the collective
raises.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


def mesh_shape(n: int, model_parallel: int | None = None) -> tuple[int, int]:
    """(data, model) for n ranks: model defaults to 4 where 4 divides n,
    else 2 where n is even, else 1 (the generator has 4 attention heads),
    as the JAX package's `make_mesh`."""
    if model_parallel is None:
        model_parallel = 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)
    if n % model_parallel:
        raise ValueError(f"make_mesh: {n} ranks do not split into model groups of {model_parallel}")
    return n // model_parallel, model_parallel


def backend_for(ranks_per_host: int, device_type: str) -> str:
    """"nccl" when each of a host's ranks has a card of its own, else
    "gloo" (ranks that share a card, or run on the CPU)."""
    if device_type == "cuda" and torch.cuda.device_count() >= ranks_per_host:
        return "nccl"
    return "gloo"


class Mesh:
    """One rank's view of the (data, model) grid: the grid's shape (a
    mapping, as `mesh.shape[...]` in JAX), the rank's coordinates, its
    device and one process group per axis of size > 1 (the ranks that
    share its other coordinate)."""

    def __init__(self, shape: tuple[int, int], rank: int, device, groups: dict | None = None):
        dp, mp = shape
        self.shape = {DATA_AXIS: dp, MODEL_AXIS: mp}
        self.rank = rank
        self.coords = {DATA_AXIS: rank // mp, MODEL_AXIS: rank % mp}
        self.device = torch.device(device)
        self.groups = groups or {}

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def global_rank(self, axis: str, q: int) -> int:
        """The process group rank of the rank at index q of `axis` that
        shares this rank's other coordinate."""
        mp = self.shape[MODEL_AXIS]
        if axis == MODEL_AXIS:
            return self.coords[DATA_AXIS] * mp + q
        return q * mp + self.coords[MODEL_AXIS]

    def send_recv(self, sends: dict, recv_rows: dict, axis: str, like: torch.Tensor) -> dict:
        """Point to point along `axis`: sends[q] to the rank at index q, and
        from each index q of recv_rows a tensor shaped like `like` with
        recv_rows[q] = (dim, n) rows along dim; every transfer posted in
        one batch, then waited on. Returns {q: received}."""
        group = self.groups[axis]
        stage = torch.device("cpu") if like.is_cuda and dist.get_backend(group) == "gloo" else like.device
        ops, got = [], {}
        for q, t in sends.items():
            ops.append(dist.P2POp(dist.isend, t.to(stage).contiguous(), self.global_rank(axis, q), group))
        for q, (dim, n) in recv_rows.items():
            shape = list(like.shape)
            shape[dim] = n
            got[q] = torch.empty(shape, dtype=like.dtype, device=stage)
            ops.append(dist.P2POp(dist.irecv, got[q], self.global_rank(axis, q), group))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return {q: t.to(like.device) for q, t in got.items()}

    def all_reduce(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum of every rank's x along `axis`, as a new tensor (x is
        left as it is)."""
        if self.shape[axis] == 1:
            return x
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=self.groups[axis])
        return out

    def all_gather(self, x: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
        """Every rank's x along `axis`, concatenated along `dim` in rank
        order (tiled)."""
        n = self.shape[axis]
        if n == 1:
            return x
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=self.groups[axis])
        return torch.cat(parts, dim=dim)


def make_mesh(n_devices: int | None = None, model_parallel: int | None = None, device=None) -> Mesh:
    """This rank's mesh over the default process group, shaped (data,
    model) by `mesh_shape`. Where the group is not initialised yet, it is
    from torchrun's environment (env://, backend by `backend_for`).
    n_devices, where given, must be the world size. The rank runs on
    cuda:{rank % device_count} unless `device` names another (the tests
    pass "cpu"). Every rank must call it, in the same order as its other
    group calls: it creates the axis groups."""
    if not dist.is_initialized():
        world = int(os.environ["WORLD_SIZE"])
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        dist.init_process_group(backend_for(local, "cpu" if str(device) == "cpu" else "cuda"), init_method="env://")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh: {n_devices} devices asked for, the process group has {world} ranks")
    dp, mp = mesh_shape(world, model_parallel)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA card; pass device='cpu' to run the ranks on the CPU")
        device = f"cuda:{rank % torch.cuda.device_count()}"
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    elif dist.get_backend() == "nccl":
        raise ValueError("make_mesh: NCCL ranks run on CUDA cards; use gloo for CPU ranks")
    groups = {}
    # every rank creates every group, in one order
    if dp > 1:
        for m in range(mp):
            ranks = [d * mp + m for d in range(dp)]
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[DATA_AXIS] = g
    if mp > 1:
        for d in range(dp):
            ranks = [d * mp + m for m in range(mp)]
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[MODEL_AXIS] = g
    return Mesh((dp, mp), rank, device, groups)
