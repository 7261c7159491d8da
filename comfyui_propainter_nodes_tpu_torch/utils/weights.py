"""Weights: checkpoint download and checksum, the conversion cache, seeded
random init.

The port's copy of the JAX package's `utils/weights.py`:
  * checkpoints come from the upstream release (PRETRAIN_MODEL_URL) into
    `weights_dir()` (PROPAINTER_TPU_WEIGHTS, as the JAX package reads
    it): `download_model` retries 3 times, refuses a file under 1 MiB or
    one whose digest differs from its pin, and renames the `.part` file
    into place only when it passed;
  * pins live in `known_sha256.json` beside this module (`write_pins`;
    none ship); without a pin the first verified file records its digest
    in a `<file>.sha256` sidecar and every later load checks it
    (`verify_checksum`);
  * `get_params` looks where the JAX package looks, in its order: the
    `.jax.npz` cache (utils/checkpoint.py, the file both packages write),
    the `.pth` (checksum, convert, write the cache), the download, then,
    where allowed, `random_params`; the result is cached in-process by
    model name, as in JAX;
  * `random_params(model, seed)` draws exactly the numpy arrays the JAX
    package draws (same spec file, same key order, same `default_rng`
    calls), in the converted layout.
`get_params` returns upstream-layout CPU float32 torch tensors
(`utils/params.py::from_jax_params`).
"""

from __future__ import annotations

import hashlib
import json
import os
import urllib.request

import numpy as np
import torch

from .checkpoint import load_params, load_torch_checkpoint, save_params
from .params import from_jax_params

PRETRAIN_MODEL_URL = "https://github.com/sczhou/ProPainter/releases/download/v0.1.0/"

MODEL_FILES = {
    "raft": "raft-things.pth",
    "flow_completion": "recurrent_flow_completion.pth",
    "inpaint_generator": "ProPainter.pth",
}

_SPEC_PATH = os.path.join(os.path.dirname(__file__), "param_specs.json")
_PINS_PATH = os.path.join(os.path.dirname(__file__), "known_sha256.json")
_PARAM_CACHE: dict[str, dict[str, torch.Tensor]] = {}


def known_sha256() -> dict[str, str]:
    """The pinned digests of the release files, by file name (empty until
    `write_pins` records some)."""
    if not os.path.exists(_PINS_PATH):
        return {}
    with open(_PINS_PATH) as f:
        return json.load(f)


def write_pins(digests: dict[str, str]) -> str:
    """Add observed checkpoint digests to the pinned table; returns its path."""
    merged = {**known_sha256(), **digests}
    with open(_PINS_PATH, "w") as f:
        json.dump(merged, f, indent=2, sort_keys=True)
        f.write("\n")
    return _PINS_PATH


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def verify_checksum(path: str) -> str:
    """Check `path` against its pin, or else its `.sha256` sidecar; with
    neither, record the digest in the sidecar. Returns the digest; raises
    IOError on a mismatch."""
    digest = _sha256(path)
    expected = known_sha256().get(os.path.basename(path))
    sidecar = path + ".sha256"
    if expected is None and os.path.exists(sidecar):
        with open(sidecar) as f:
            expected = f.read().strip()
    if expected is None:
        with open(sidecar, "w") as f:
            f.write(digest)
    elif digest != expected:
        raise IOError(f"checksum mismatch for {path}: got {digest}, expected {expected}")
    return digest


def weights_dir() -> str:
    """Where checkpoints and caches live (PROPAINTER_TPU_WEIGHTS overrides)."""
    return os.environ.get(
        "PROPAINTER_TPU_WEIGHTS",
        os.path.join(os.path.dirname(os.path.dirname(__file__)), "weights"),
    )


def download_model(url: str, dest: str, retries: int = 3) -> None:
    """url -> dest through dest.part: each try fetches, checks the size (at
    least 1 MiB) and the pin, then renames and verifies; any failure is
    retried, and the last one raises RuntimeError."""
    last_err = None
    for _ in range(retries):
        try:
            tmp = dest + ".part"
            urllib.request.urlretrieve(url, tmp)
            if os.path.getsize(tmp) < 1 << 20:
                raise IOError(f"suspiciously small download: {url}")
            expected = known_sha256().get(os.path.basename(dest))
            if expected is not None and _sha256(tmp) != expected:
                raise IOError(f"checksum mismatch for {url}")
            os.replace(tmp, dest)
            verify_checksum(dest)
            return
        except Exception as e:  # noqa: BLE001 - any transport or check failure is retried
            last_err = e
    raise RuntimeError(f"failed to download {url}: {last_err}")


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


def get_params(
    model: str, allow_download: bool = True, allow_random: bool = False, seed: int = 0
) -> dict[str, torch.Tensor]:
    """Upstream-layout CPU float32 params for `model` ('raft' |
    'flow_completion' | 'inpaint_generator'), cached in-process by model."""
    if model in _PARAM_CACHE:
        return _PARAM_CACHE[model]
    d = weights_dir()
    fname = MODEL_FILES[model]
    npz = os.path.join(d, os.path.splitext(fname)[0] + ".jax.npz")
    pth = os.path.join(d, fname)
    if os.path.exists(npz):
        flat = load_params(npz)
    elif os.path.exists(pth):
        verify_checksum(pth)
        flat = load_torch_checkpoint(pth)
        save_params(flat, npz)
    elif allow_download:
        try:
            os.makedirs(d, exist_ok=True)
            download_model(PRETRAIN_MODEL_URL + fname, pth)
        except Exception as e:  # noqa: BLE001 - an air-gapped host falls back where allowed
            if not allow_random:
                raise RuntimeError(
                    f"cannot obtain weights for {model}: {e}. Place {fname} or "
                    f"{os.path.basename(npz)} in {d} (or set PROPAINTER_TPU_WEIGHTS), "
                    "or pass allow_random=True."
                ) from e
            flat = random_params(model, seed)
        else:
            flat = load_torch_checkpoint(pth)
            save_params(flat, npz)
    elif allow_random:
        flat = random_params(model, seed)
    else:
        raise FileNotFoundError(f"no weights for {model} in {d}")
    params = {k: v.float() if v.is_floating_point() else v for k, v in from_jax_params(flat).items()}
    _PARAM_CACHE[model] = params
    return params
