"""PyTorch port vs the JAX package: RAFT and the flow completion network.

Same numpy inputs and the same seeded random weights (`random_params`,
carried across by `from_jax_params`) on the CPU, in fp32. JAX runs its
CPU paths (the Pallas kernels' XLA twins). Per-model tolerance: 1e-4 of
the output's largest magnitude (fp32 reassociation through a few dozen
layers and recurrent steps)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_propainter_nodes_tpu.models import flow_completion as jfc
from comfyui_propainter_nodes_tpu.models import raft as jraft
from comfyui_propainter_nodes_tpu.utils.weights import random_params
from comfyui_propainter_nodes_tpu_torch.models import flow_completion as tfc
from comfyui_propainter_nodes_tpu_torch.models import raft as traft
from comfyui_propainter_nodes_tpu_torch.utils.params import from_jax_params

torch.set_num_threads(1)


def _params(raw):
    return {k: jnp.asarray(v) for k, v in raw.items()}, from_jax_params(raw)


def _close_rel(port, ref, rel=1e-4):
    ref = np.asarray(ref)
    port = port.detach().numpy() if hasattr(port, "detach") else np.asarray(port)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(port - ref).max())
    assert err <= rel * scale, f"max abs err {err} > {rel} * {scale}"


def test_raft_bi_forward():
    """128x160 (smaller maps degenerate the level-3 pyramid), 3 frames,
    2 iterations."""
    pj, pt = _params(random_params("raft", seed=1))
    rng = np.random.default_rng(0)
    frames = rng.uniform(-1, 1, (1, 3, 128, 160, 3)).astype(np.float32)
    ref_f, ref_b = jraft.raft_bi_forward(pj, jnp.asarray(frames), iters=2)
    out_f, out_b = traft.raft_bi_forward(pt, torch.from_numpy(frames), iters=2)
    _close_rel(out_f, ref_f)
    _close_rel(out_b, ref_b)


def test_forward_bidirect_flow_and_combine():
    pj, pt = _params(random_params("flow_completion", seed=2))
    rng = np.random.default_rng(1)
    ff = (rng.standard_normal((1, 4, 64, 96, 2)) * 3).astype(np.float32)
    fb = (rng.standard_normal((1, 4, 64, 96, 2)) * 3).astype(np.float32)
    masks = np.zeros((1, 5, 64, 96, 1), np.float32)
    masks[:, :, 20:40, 30:60] = 1.0
    ref = jfc.forward_bidirect_flow(pj, jnp.asarray(ff), jnp.asarray(fb), jnp.asarray(masks))
    out = tfc.forward_bidirect_flow(pt, torch.from_numpy(ff), torch.from_numpy(fb), torch.from_numpy(masks))
    for o, r in zip(out, ref):
        _close_rel(o, r)
    comb_ref = jfc.combine_flow(jnp.asarray(ff), jnp.asarray(fb), *ref, jnp.asarray(masks))
    comb = tfc.combine_flow(torch.from_numpy(ff), torch.from_numpy(fb), *out, torch.from_numpy(masks))
    for o, r in zip(comb, comb_ref):
        _close_rel(o, r)


@pytest.mark.parametrize(
    "frames_a_call, jax_env",
    [
        (3, {"PROPAINTER_TPU_FC_CHUNK_AREA": "1"}),
        (1, {"PROPAINTER_TPU_FC_CHUNK_AREA": "1", "PROPAINTER_TPU_FC_BIGAREA": "1", "PROPAINTER_TPU_FC_SLAB_NB": "3"}),
    ],
    ids=["decode_3_frames", "decode_1_frame"],
)
def test_forward_bidirect_flow_decoded_in_chunks(monkeypatch, frames_a_call, jax_env):
    """The port's decoder in calls of `frames_a_call` frames (its memory
    budget lowered to that) against the JAX package's high-res path
    (directions in turn, temporal-halo-chunked encoder, decoder in chunks
    of 8 frames; of 2 and a row-slabbed encoder in the second case), both
    forced at 64x96: 9 frames, so 16 batched entries and a short last
    call."""
    pj, pt = _params(random_params("flow_completion", seed=2))
    rng = np.random.default_rng(6)
    ff = (rng.standard_normal((1, 8, 64, 96, 2)) * 2).astype(np.float32)
    fb = (rng.standard_normal((1, 8, 64, 96, 2)) * 2).astype(np.float32)
    masks = (rng.uniform(size=(1, 9, 64, 96, 1)) > 0.7).astype(np.float32)
    for k, v in jax_env.items():
        monkeypatch.setenv(k, v)
    ref = jfc.forward_bidirect_flow(pj, jnp.asarray(ff), jnp.asarray(fb), jnp.asarray(masks))
    calls = []
    decode = tfc._decode
    monkeypatch.setattr(tfc, "_decode", lambda p, prop, e1: calls.append(prop.shape[0]) or decode(p, prop, e1))
    monkeypatch.setattr(tfc, "DECODE_BYTES", frames_a_call * 64 * 96 * 32 * 4)
    out = tfc.forward_bidirect_flow(pt, torch.from_numpy(ff), torch.from_numpy(fb), torch.from_numpy(masks))
    assert calls == [frames_a_call] * (16 // frames_a_call) + [16 % frames_a_call] * (16 % frames_a_call > 0)
    for o, r in zip(out, ref):
        _close_rel(o, r)


def _padded_clips(rng, lengths, n, h, w, c, scale):
    """[B, n, h, w, c] values with each clip's frames past its real length
    zeroed, as the clip-parallel stages pad their chunks."""
    x = (rng.standard_normal((len(lengths), n, h, w, c)) * scale).astype(np.float32)
    for i, tv in enumerate(lengths):
        x[i, tv:] = 0.0
    return x


def _valid(tv, b):
    """(JAX t_valid, port t_valid, per-clip lengths) of an int or a list."""
    if isinstance(tv, int):
        return jnp.asarray(tv), tv, [tv] * b
    return jnp.asarray(tv), torch.tensor(tv), tv


@pytest.mark.parametrize("tv", [3, [4, 2]], ids=["scalar", "per_clip"])
def test_forward_bidirect_flow_t_valid(tv):
    """Zero-padded chunks of 4 flows with their real lengths (an int, or a
    [B] tensor: the clip-parallel completion's) against the JAX
    `forward_bidirect_flow(..., t_valid)` and the port on each clip's real
    frames alone, on the real frames."""
    pj, pt = _params(random_params("flow_completion", seed=2))
    rng = np.random.default_rng(5)
    b = 1 if isinstance(tv, int) else len(tv)
    tvj, tvt, lengths = _valid(tv, b)
    ff = _padded_clips(rng, lengths, 4, 64, 96, 2, 3.0)
    fb = _padded_clips(rng, lengths, 4, 64, 96, 2, 3.0)
    masks = np.zeros((b, 5, 64, 96, 1), np.float32)
    for i, n in enumerate(lengths):
        masks[i, : n + 1, 20:40, 30:60] = 1.0
    ref = jfc.forward_bidirect_flow(pj, jnp.asarray(ff), jnp.asarray(fb), jnp.asarray(masks), tvj)
    out = tfc.forward_bidirect_flow(pt, torch.from_numpy(ff), torch.from_numpy(fb), torch.from_numpy(masks), tvt)
    for i, n in enumerate(lengths):
        alone = tfc.forward_bidirect_flow(
            pt, torch.from_numpy(ff[i : i + 1, :n]), torch.from_numpy(fb[i : i + 1, :n]),
            torch.from_numpy(masks[i : i + 1, : n + 1]),
        )
        for o, r, a in zip(out, ref, alone):
            _close_rel(o[i, :n], np.asarray(r)[i, :n])
            _close_rel(o[i : i + 1, :n], a.numpy())


@pytest.mark.parametrize("tv", [5, [6, 4]], ids=["scalar", "per_clip"])
def test_img_propagation_t_valid(tv):
    """Image propagation of zero-padded chunks of 6 frames with their real
    lengths against the JAX `bidirectional_propagation_image(...,
    t_valid)` and the port on each clip's real frames alone."""
    from comfyui_propainter_nodes_tpu.models import propainter as jpp
    from comfyui_propainter_nodes_tpu_torch.models import propainter as tpp

    rng = np.random.default_rng(6)
    b = 1 if isinstance(tv, int) else len(tv)
    tvj, tvt, lengths = _valid(tv, b)
    x = _padded_clips(rng, lengths, 6, 32, 48, 3, 0.5)
    ff = _padded_clips(rng, [n - 1 for n in lengths], 5, 32, 48, 2, 2.0)
    fb = _padded_clips(rng, [n - 1 for n in lengths], 5, 32, 48, 2, 2.0)
    m = np.zeros((b, 6, 32, 48, 1), np.float32)
    for i, n in enumerate(lengths):
        m[i, :n, 8:20, 10:30] = 1.0
    ref = jpp.bidirectional_propagation_image(*(jnp.asarray(a) for a in (x, ff, fb, m)), "nearest", t_valid=tvj)
    out = tpp.img_propagation(*(torch.from_numpy(a) for a in (x, ff, fb, m)), "nearest", t_valid=tvt)
    for i, n in enumerate(lengths):
        alone = tpp.img_propagation(
            *(torch.from_numpy(a[i : i + 1, :k]) for a, k in ((x, n), (ff, n - 1), (fb, n - 1), (m, n))), "nearest"
        )
        for o, r, a in zip(out, ref, alone):
            _close_rel(o[i, :n], np.asarray(r)[i, :n])
            np.testing.assert_array_equal(o[i : i + 1, :n].numpy(), a.numpy())
