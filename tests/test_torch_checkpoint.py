"""The port's checkpoint conversion and weights cache (`utils/checkpoint.py`,
`utils/weights.py`) against the JAX package's, on files each test writes
under its tmp_path. `urllib.request.urlretrieve` is patched in every test:
a download copies a local file or fails, and nothing reaches the network."""

import os
import shutil
import urllib.request

import numpy as np
import pytest
import torch

from comfyui_propainter_nodes_tpu.utils import checkpoint as jckpt
from comfyui_propainter_nodes_tpu.utils import weights as jweights
from comfyui_propainter_nodes_tpu_torch.utils import checkpoint as ckpt
from comfyui_propainter_nodes_tpu_torch.utils import weights
from comfyui_propainter_nodes_tpu_torch.utils.params import from_jax_params


@pytest.fixture(autouse=True)
def _offline(monkeypatch, tmp_path):
    """No network, an empty in-process cache, weights and pins under tmp_path."""
    def refuse(url, dest):
        raise OSError(f"no network in tests: {url}")

    monkeypatch.setattr(urllib.request, "urlretrieve", refuse)
    monkeypatch.setattr(weights, "_PARAM_CACHE", {})
    monkeypatch.setattr(weights, "_PINS_PATH", str(tmp_path / "known_sha256.json"))
    monkeypatch.setenv("PROPAINTER_TPU_WEIGHTS", str(tmp_path / "weights"))
    os.makedirs(tmp_path / "weights")


def fake_state_dict(seed=0) -> dict:
    """A seeded torch state dict with DataParallel's prefix and every
    layout the conversion handles."""
    g = torch.Generator().manual_seed(seed)
    shapes = {
        "module.conv.weight": (8, 4, 3, 3), "module.conv.bias": (8,), "module.conv3d.weight": (6, 4, 1, 3, 3),
        "module.fc.weight": (5, 7), "module.fc.bias": (5,), "module.bn.running_mean": (8,),
        "module.bn.weight": (8,),
    }
    state = {k: torch.randn(s, generator=g) for k, s in shapes.items()}
    state["module.bn.num_batches_tracked"] = torch.tensor(3)
    return state


def raft_pth(path: str) -> dict:
    """Writes raft's seeded random weights, upstream layout, as a .pth;
    returns them."""
    state = from_jax_params(weights.random_params("raft", seed=3))
    torch.save(state, path)
    return state


def test_convert_state_dict_is_jax_and_inverts_from_jax_params():
    state = fake_state_dict()
    got, want = ckpt.convert_state_dict(state), jckpt.convert_state_dict(state)
    assert got.keys() == want.keys() and "bn.num_batches_tracked" not in got
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    back = from_jax_params(got)
    for k, v in state.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(back[k[len("module."):]], v)
    sub, jsub = ckpt.filter_prefix(got, "fc."), jckpt.filter_prefix(want, "fc.")
    assert sub.keys() == jsub.keys() == {"weight", "bias"}
    assert all(np.array_equal(sub[k], jsub[k]) for k in sub)


def test_npz_cache_is_shared_with_jax(tmp_path):
    flat = jweights.random_params("flow_completion")
    jckpt.save_params(flat, str(tmp_path / "a.jax.npz"))
    port_read = ckpt.load_params(str(tmp_path / "a.jax.npz"))
    ckpt.save_params(port_read, str(tmp_path / "b.jax.npz"))
    jax_read = jckpt.load_params(str(tmp_path / "b.jax.npz"))
    assert port_read.keys() == flat.keys() == jax_read.keys()
    for k in flat:
        np.testing.assert_array_equal(port_read[k], flat[k])
        np.testing.assert_array_equal(jax_read[k], flat[k])
    # the .pth -> cache conversion of each package gives the other's file
    pth = str(tmp_path / "raft-things.pth")
    raft_pth(pth)
    mine = ckpt.convert_or_load_cached(pth, str(tmp_path / "port"))
    theirs = jckpt.load_params(str(tmp_path / "port" / "raft-things.jax.npz"))
    for k in mine:
        np.testing.assert_array_equal(theirs[k], mine[k])


def test_get_params_order_pth_becomes_cache(tmp_path):
    d = tmp_path / "weights"
    state = raft_pth(str(d / "raft-things.pth"))
    got = weights.get_params("raft", allow_download=False)
    assert (d / "raft-things.jax.npz").exists() and (d / "raft-things.pth.sha256").exists()
    for k, v in state.items():
        assert got[k].dtype == torch.float32 and torch.equal(got[k], v)
    # the cache comes first: a changed .pth is not read again
    weights._PARAM_CACHE.clear()
    torch.save({k: v + 1 for k, v in state.items()}, str(d / "raft-things.pth"))
    again = weights.get_params("raft", allow_download=False)
    assert all(torch.equal(again[k], v) for k, v in state.items())
    # and the JAX package reads the port's cache as its own
    jax_flat = jckpt.load_params(str(d / "raft-things.jax.npz"))
    assert all(torch.equal(from_jax_params(jax_flat)[k], v) for k, v in state.items())


def test_get_params_in_process_cache_and_random(tmp_path):
    with pytest.raises(FileNotFoundError):
        weights.get_params("raft", allow_download=False)
    a = weights.get_params("raft", allow_download=True, allow_random=True)  # the download fails: random weights
    assert weights.get_params("raft") is a  # cached by model, as in JAX
    want = from_jax_params(jweights.random_params("raft"))
    assert all(torch.equal(a[k], v) for k, v in want.items())
    weights._PARAM_CACHE.clear()
    with pytest.raises(RuntimeError, match="cannot obtain weights"):
        weights.get_params("raft", allow_download=True)
    assert weights.weights_dir() == str(tmp_path / "weights")


def test_checksum_sidecar_and_pins(tmp_path):
    p = tmp_path / "model.pth"
    p.write_bytes(b"weights-v1" * 1000)
    d1 = weights.verify_checksum(str(p))  # first sight: the sidecar records it
    assert (tmp_path / "model.pth.sha256").read_text() == d1 == jweights._sha256(str(p))
    assert weights.verify_checksum(str(p)) == d1
    p.write_bytes(b"weights-v2" * 1000)
    with pytest.raises(IOError, match="checksum mismatch"):
        weights.verify_checksum(str(p))
    q = tmp_path / "pinned.pth"
    q.write_bytes(b"x" * 100)
    assert weights.write_pins({"pinned.pth": "0" * 64}) == weights._PINS_PATH
    assert weights.known_sha256() == {"pinned.pth": "0" * 64}
    with pytest.raises(IOError):
        weights.verify_checksum(str(q))  # the pin wins over a missing sidecar


def test_download_model_retries_checks_size_and_renames(tmp_path, monkeypatch):
    src = tmp_path / "release.bin"
    src.write_bytes(os.urandom((1 << 20) + 17))
    calls = []

    def flaky(url, dest):
        calls.append(dest)
        if len(calls) == 1:
            raise OSError("connection reset")
        shutil.copyfile(src, dest)

    monkeypatch.setattr(urllib.request, "urlretrieve", flaky)
    dest = str(tmp_path / "weights" / "ProPainter.pth")
    weights.download_model("https://example.invalid/ProPainter.pth", dest)
    assert len(calls) == 2 and all(c == dest + ".part" for c in calls)
    assert not os.path.exists(dest + ".part") and open(dest, "rb").read() == src.read_bytes()
    assert open(dest + ".sha256").read() == jweights._sha256(str(src))

    small = tmp_path / "small.bin"
    small.write_bytes(b"tiny")
    monkeypatch.setattr(urllib.request, "urlretrieve", lambda url, d: shutil.copyfile(small, d))
    tiny_dest = str(tmp_path / "weights" / "raft-things.pth")
    with pytest.raises(RuntimeError, match="suspiciously small"):
        weights.download_model("https://example.invalid/raft-things.pth", tiny_dest, retries=2)
    assert not os.path.exists(tiny_dest)

    monkeypatch.setattr(urllib.request, "urlretrieve", lambda url, d: shutil.copyfile(src, d))
    weights.write_pins({"recurrent_flow_completion.pth": "f" * 64})
    pinned_dest = str(tmp_path / "weights" / "recurrent_flow_completion.pth")
    with pytest.raises(RuntimeError, match="checksum mismatch"):
        weights.download_model("https://example.invalid/recurrent_flow_completion.pth", pinned_dest)
    assert not os.path.exists(pinned_dest)


def test_get_params_downloads_then_caches(tmp_path, monkeypatch):
    """No cache, no .pth: the download (a patched copy of a local .pth),
    then the conversion into the cache, as the JAX package does."""
    src = str(tmp_path / "upstream.pth")
    state = raft_pth(src)
    assert os.path.getsize(src) > 1 << 20  # past the size check
    urls = []
    monkeypatch.setattr(urllib.request, "urlretrieve", lambda url, d: (urls.append(url), shutil.copyfile(src, d)))
    got = weights.get_params("raft")
    assert urls == [weights.PRETRAIN_MODEL_URL + "raft-things.pth"]
    assert (tmp_path / "weights" / "raft-things.jax.npz").exists()
    assert all(torch.equal(got[k], v) for k, v in state.items())
