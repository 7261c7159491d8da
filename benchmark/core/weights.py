"""Seeded random weights for the three networks, written as the
`.jax.npz` checkpoint caches the nodes load.

Shapes and key order come from a frozen copy of the program's spec
(`param_specs.json` beside this file, the converted layouts: conv HWIO,
conv3d DHWIO, linear (in, out)). Each network's values are drawn on the
device in two calls of a `torch.Generator` seeded from `--seed`, one
normal and one uniform, then cut into leaves and scaled by the fan-in
rule of the program's `random_params`: running variances uniform in
[0.5, 1.5], running means normal with sd 0.1, tensors of two or more
axes normal with sd 1/sqrt(fan-in), the fan-out last, the rest normal
with sd 0.05.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch

SPEC = os.path.join(os.path.dirname(__file__), "param_specs.json")
FILES = {
    "raft": "raft-things.jax.npz",
    "flow_completion": "recurrent_flow_completion.jax.npz",
    "inpaint_generator": "ProPainter.jax.npz",
}


def spec() -> dict:
    with open(SPEC) as f:
        return json.load(f)


def draw(seed: int, device) -> dict:
    """{model: {key: float32 tensor on device}} in the converted layout."""
    out = {}
    for mi, (model, leaves) in enumerate(spec().items()):
        gen = torch.Generator(device=device)
        gen.manual_seed((int(seed) * 3 + mi) % (1 << 63))
        total = sum(math.prod(s) for s in leaves.values())
        normal = torch.randn(total, generator=gen, device=device)
        uniform = torch.rand(total, generator=gen, device=device)
        params, at = {}, 0
        for key, shape in leaves.items():
            n = math.prod(shape)
            z, u = normal[at : at + n].view(shape), uniform[at : at + n].view(shape)
            at += n
            if key.endswith(".running_var"):
                params[key] = 0.5 + u
            elif key.endswith(".running_mean"):
                params[key] = 0.1 * z
            elif len(shape) >= 2:
                params[key] = z / math.sqrt(math.prod(shape[:-1]))
            else:
                params[key] = 0.05 * z
        out[model] = params
    return out


def write(params: dict, folder: str) -> int:
    """Write each network's `.jax.npz` into folder; returns the bytes."""
    os.makedirs(folder, exist_ok=True)
    total = 0
    for model, leaves in params.items():
        path = os.path.join(folder, FILES[model])
        np.savez(path, **{k: v.cpu().numpy() for k, v in leaves.items()})
        total += os.path.getsize(path)
    return total
