"""Weights: local checkpoints or seeded random init.

`random_params(model, seed)` draws exactly the numpy arrays the JAX
package's `random_params` draws (same spec file, same key order, same
`default_rng` calls), in the converted layout (HWIO / DHWIO / (in, out)).
`get_params` returns upstream-layout torch tensors: a local `.pth` loads
as it is, a local `.jax.npz` and random weights go through
`utils.params.from_jax_params`. Nothing is downloaded.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from .params import from_jax_params

MODEL_FILES = {
    "raft": "raft-things.pth",
    "flow_completion": "recurrent_flow_completion.pth",
    "inpaint_generator": "ProPainter.pth",
}

_SPEC_PATH = os.path.join(os.path.dirname(__file__), "param_specs.json")


def weights_dir() -> str:
    """Where local checkpoints are looked up (PROPAINTER_WEIGHTS overrides)."""
    return os.environ.get(
        "PROPAINTER_WEIGHTS",
        os.path.join(os.path.dirname(os.path.dirname(__file__)), "weights"),
    )


def load_spec() -> dict[str, dict[str, list[int]]]:
    with open(_SPEC_PATH) as f:
        return json.load(f)


def random_params(model: str, seed: int = 0) -> dict[str, np.ndarray]:
    """Fan-in-scaled random params in the converted (JAX) layouts."""
    spec = load_spec()[model]
    rng = np.random.default_rng(seed)
    out = {}
    for key, shape in spec.items():
        shape = tuple(shape)
        if key.endswith(".running_var"):
            arr = rng.uniform(0.5, 1.5, shape)
        elif key.endswith(".running_mean"):
            arr = rng.normal(0, 0.1, shape)
        elif len(shape) >= 2:
            # converted layouts put fan-out last (HWIO / DHWIO / (in, out))
            fan_in = int(np.prod(shape[:-1]))
            arr = rng.normal(0, 1.0 / np.sqrt(fan_in), shape)
        else:
            arr = rng.normal(0, 0.05, shape)
        out[key] = arr.astype(np.float32)
    return out


def _load_pth(path: str) -> dict[str, torch.Tensor]:
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    out = {}
    for key, val in state.items():
        if key.startswith("module."):
            key = key[len("module.") :]
        if key.endswith("num_batches_tracked"):
            continue
        out[key] = val.float()
    return out


def get_params(
    model: str, allow_random: bool = False, seed: int = 0
) -> dict[str, torch.Tensor]:
    """Upstream-layout CPU float32 params for `model` ('raft' |
    'flow_completion' | 'inpaint_generator')."""
    d = weights_dir()
    fname = MODEL_FILES[model]
    pth = os.path.join(d, fname)
    npz = os.path.join(d, os.path.splitext(fname)[0] + ".jax.npz")
    if os.path.exists(pth):
        return _load_pth(pth)
    if os.path.exists(npz):
        with np.load(npz) as z:
            return from_jax_params({k: z[k] for k in z.files})
    if allow_random:
        return from_jax_params(random_params(model, seed))
    raise FileNotFoundError(
        f"no weights for {model}: place {fname} or "
        f"{os.path.basename(npz)} in {d} (or set PROPAINTER_WEIGHTS), "
        "or pass allow_random=True"
    )
