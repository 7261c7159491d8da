"""The high-res memory plans of the port against its unchunked forms and
against the JAX package's plans.

Each plan is forced at a small size: in the port by lowering its budget
(`monkeypatch` on the module constant), in the JAX package by its own
variable (PROPAINTER_TPU_FC_CHUNK_AREA, _FC_BIGAREA, _FC_SLAB_NB,
_PP_CHUNK_AREA). Inputs come from seeded numpy generators, weights from
`random_params`; fp32 on the CPU. Tolerances: against the port's
unchunked form atol 1e-5 (the same arithmetic; a conv may take another
algorithm for another batch); against the JAX package 1e-4 of the
output's largest magnitude, as tests/test_torch_models.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_propainter_nodes_tpu.models import flow_completion as jfc
from comfyui_propainter_nodes_tpu.models import propainter as jpp
from comfyui_propainter_nodes_tpu.utils.weights import random_params
from comfyui_propainter_nodes_tpu_torch.config import PipelineConfig
from comfyui_propainter_nodes_tpu_torch.models import flow_completion as tfc
from comfyui_propainter_nodes_tpu_torch.models import propainter as tpp
from comfyui_propainter_nodes_tpu_torch.pipeline import stages
from comfyui_propainter_nodes_tpu_torch.utils.params import from_jax_params
from test_torch_streaming import moving_box_clip, port_pipeline, stream

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def fc_params():
    raw = random_params("flow_completion", seed=2)
    return {k: jnp.asarray(v) for k, v in raw.items()}, from_jax_params(raw)


@pytest.fixture(scope="module")
def pp_params():
    raw = random_params("inpaint_generator", seed=3)
    return {k: jnp.asarray(v) for k, v in raw.items()}, from_jax_params(raw)


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def close_port(out, ref, atol=1e-5):
    np.testing.assert_allclose(_np(out), _np(ref), rtol=0, atol=atol)


def close_jax(out, ref, rel=1e-4):
    out, ref = _np(out), _np(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(out - ref).max())
    assert err <= rel * scale, f"max abs err {err} > {rel} * {scale}"


def fc_inputs(seed, t, h, w):
    """Completion network inputs [1, t, h, w, 3]: flows and a binary mask."""
    rng = np.random.default_rng(seed)
    flows = rng.standard_normal((1, t, h, w, 2)) * 2
    masks = rng.uniform(size=(1, t, h, w, 1)) > 0.7
    return np.concatenate([flows, masks], -1).astype(np.float32)


# ------------------------------------------------------------ row slabs


@pytest.mark.parametrize("nb", [2, 3, 8])
@pytest.mark.parametrize("h8", [8, 9, 17, 135])
def test_slab_plan_is_jax(h8, nb):
    assert tfc._slab_plan(h8, nb) == jfc._slab_plan(h8, nb)


@pytest.mark.parametrize("nb", [1, 0, -2])
def test_slab_plan_rejects_slabs_below_two_rows(nb):
    with pytest.raises(ValueError, match="at least 2"):
        tfc._slab_plan(17, nb)


@pytest.mark.parametrize("nb", [2, 3])
def test_encode_slabbed(fc_params, nb):
    """64x48 (8 rows at 1/8), 2 frames: slabs of 2 and 3 rows, a short last."""
    pj, pt = fc_params
    x = fc_inputs(0, 2, 64, 48)
    out = tfc._encode_slabbed(pt, torch.from_numpy(x), nb)
    whole = tfc._encode_core(pt, tfc._edge_pad(torch.from_numpy(x)))
    ref = jfc._encode_slabbed(pj, jnp.asarray(x), None, None, nb)
    for o, u, r in zip(out, whole, ref):
        close_port(o, u)
        close_jax(o, r)


def test_slab_rows_follow_the_budget(monkeypatch):
    """Past SLAB_BYTES a call takes slabs of as many rows as keep one
    slab's half-res rows (4 nb + 16) within it; within it, none."""
    shape = (1, 4, 64, 96, 3)
    assert tfc._slab_rows(shape, 4) is None
    monkeypatch.setattr(tfc, "SLAB_BYTES", 4 * 48 * 32 * 4 * (4 * 3 + 16))
    assert tfc._slab_rows(shape, 4) == 3
    monkeypatch.setattr(tfc, "SLAB_BYTES", 1)
    assert tfc._slab_rows(shape, 4) == 2


# ------------------------------------------------------ temporal chunks


@pytest.mark.parametrize("t", [20, 37])
def test_encode_chunked(fc_params, t):
    """32x48, 20 frames (the first chunk's halo meets both clip ends, a
    4-frame tail) and 37 (three chunks, a 5-frame tail)."""
    pj, pt = fc_params
    x = fc_inputs(t, t, 32, 48)
    out = tfc._encode_chunked(pt, torch.from_numpy(x))
    whole = tfc._encode_core(pt, tfc._edge_pad(torch.from_numpy(x)))
    e1p, e2 = jfc._encode_chunked(pj, jnp.asarray(x), None)
    for o, u, r in zip(out, whole, (jfc._unpack_w2(e1p), e2)):
        close_port(o, u)
        close_jax(o, r)


def test_encode_takes_chunks_and_slabs_past_their_budgets(fc_params, monkeypatch):
    """ENCODE_BYTES and SLAB_BYTES lowered: `_encode` runs temporal chunks
    and each chunk in slabs of 2 rows, against the whole encoder and the
    JAX package's chunked, slabbed encoder (FC_SLAB_NB=2)."""
    pj, pt = fc_params
    x = fc_inputs(5, 18, 64, 96)
    whole = tfc._encode(pt, torch.from_numpy(x))
    calls = []
    slabbed = tfc._encode_slabbed
    monkeypatch.setattr(tfc, "_encode_slabbed", lambda p, v, nb, *tv: calls.append((v.shape[1], nb)) or slabbed(p, v, nb, *tv))
    monkeypatch.setattr(tfc, "ENCODE_BYTES", 0)
    monkeypatch.setattr(tfc, "SLAB_BYTES", 1)
    out = tfc._encode(pt, torch.from_numpy(x))
    assert calls == [(18, 2), (10, 2)]
    for k, v in {"PROPAINTER_TPU_FC_BIGAREA": "1", "PROPAINTER_TPU_FC_SLAB_NB": "2"}.items():
        monkeypatch.setenv(k, v)
    e1p, e2 = jfc._encode_chunked(pj, jnp.asarray(x), None)
    for o, u, r in zip(out, whole, (jfc._unpack_w2(e1p), e2)):
        close_port(o, u)
        close_jax(o, r)


def test_mid_in_frame_chunks(fc_params, monkeypatch):
    """20 frames at 1/8 of 64x96: chunks of 16 and 4 past MID_BYTES."""
    pj, pt = fc_params
    e2 = (np.random.default_rng(9).standard_normal((1, 20, 8, 12, 128)) * 0.5).astype(np.float32)
    whole = tfc._mid(pt, torch.from_numpy(e2))
    calls = []
    body = tfc._mid_body
    monkeypatch.setattr(tfc, "_mid_body", lambda p, v: calls.append(v.shape[1]) or body(p, v))
    monkeypatch.setattr(tfc, "MID_BYTES", 0)
    out = tfc._mid(pt, torch.from_numpy(e2))
    assert calls == [16, 4]
    monkeypatch.setenv("PROPAINTER_TPU_FC_BIGAREA", "1")
    close_port(out, whole)
    close_jax(out, jfc._mid(pj, jnp.asarray(e2)))


# -------------------------------------------------- directions in turn


def _flows_and_masks(seed, n, h, w):
    rng = np.random.default_rng(seed)
    ff = (rng.standard_normal((1, n, h, w, 2)) * 2).astype(np.float32)
    fb = (rng.standard_normal((1, n, h, w, 2)) * 2).astype(np.float32)
    masks = (rng.uniform(size=(1, n + 1, h, w, 1)) > 0.7).astype(np.float32)
    return ff, fb, masks


def test_forward_bidirect_flow_directions_in_turn(fc_params, monkeypatch):
    """6 pairs at 64x96: past BATCH_BYTES one direction a network call,
    against the batched call and the JAX package's high-res form
    (FC_CHUNK_AREA=1: directions in turn, chunked encoder and decoder)."""
    pj, pt = fc_params
    ff, fb, masks = _flows_and_masks(4, 6, 64, 96)
    args = [torch.from_numpy(a) for a in (ff, fb, masks)]
    batched = tfc.forward_bidirect_flow(pt, *args)
    batches = []
    complete = tfc.flow_complete_forward
    monkeypatch.setattr(tfc, "flow_complete_forward", lambda p, f, m, *tv: batches.append(f.shape[0]) or complete(p, f, m, *tv))
    monkeypatch.setattr(tfc, "BATCH_BYTES", 0)
    assert tfc.directions_in_turn(args[0].shape, torch.float32)
    out = tfc.forward_bidirect_flow(pt, *args)
    assert batches == [1, 1]
    monkeypatch.setenv("PROPAINTER_TPU_FC_CHUNK_AREA", "1")
    ref = jfc.forward_bidirect_flow(pj, jnp.asarray(ff), jnp.asarray(fb), jnp.asarray(masks))
    for o, u, r in zip(out, batched, ref):
        close_port(o, u)
        close_jax(o, r)


def test_complete_flow_chunk_directions_in_turn(fc_params, monkeypatch):
    """`Pipeline.complete_flow_chunk` past BATCH_BYTES (completed and
    combined one direction a network call) against the batched chunk and
    the JAX package's high-res completion and combine."""
    pj, pt = fc_params
    ff, fb, masks = _flows_and_masks(7, 5, 64, 96)
    pipe = stages.Pipeline({}, pt, {}, PipelineConfig(fp16="disable", process_size=(96, 64)), device="cpu")
    args = [torch.from_numpy(a) for a in (ff, fb, masks)]
    batched = pipe.complete_flow_chunk(*args)
    monkeypatch.setattr(tfc, "BATCH_BYTES", 0)
    out = pipe.complete_flow_chunk(*args)
    monkeypatch.setenv("PROPAINTER_TPU_FC_CHUNK_AREA", "1")
    jargs = [jnp.asarray(a) for a in (ff, fb, masks)]
    ref = jfc.combine_flow(*jargs[:2], *jfc.forward_bidirect_flow(pj, *jargs), jargs[2])
    for o, u, r in zip(out, batched, ref):
        close_port(o, u)
        close_jax(o, r)


# ------------------------------------- the inpaint generator's frame chunks


def test_encode_features_in_frame_chunks(pp_params, monkeypatch):
    """9 frames at 32x48: calls of 4 frames past ENCODE_BYTES, against one
    call and the JAX package's 4-frame chunks (PP_CHUNK_AREA=1)."""
    pj, pt = pp_params
    rng = np.random.default_rng(11)
    x = rng.uniform(-1, 1, (9, 32, 48, 3)).astype(np.float32)
    m1 = (rng.uniform(size=(9, 32, 48, 1)) > 0.6).astype(np.float32)
    m2 = (rng.uniform(size=(9, 32, 48, 1)) > 0.6).astype(np.float32)
    args = [torch.from_numpy(a) for a in (x, m1, m2)]
    whole = tpp.encode_features(pt, *args)
    calls = []
    encoder = tpp.encoder
    monkeypatch.setattr(tpp, "encoder", lambda p, v: calls.append(v.shape[0]) or encoder(p, v))
    monkeypatch.setattr(tpp, "ENCODE_BYTES", 4 * 8 * 12 * 512 * 4)
    out = tpp.encode_features(pt, *args)
    assert calls == [4, 4, 1]
    monkeypatch.setenv("PROPAINTER_TPU_PP_CHUNK_AREA", "1")
    close_port(out, whole)
    close_jax(out, jpp.encode_features(pj, *[jnp.asarray(a) for a in (x, m1, m2)]))


def test_decoder_in_frame_chunks(pp_params, monkeypatch):
    """5 frames of 8x12 features (32x48 out): calls of 2 frames past
    DECODE_BYTES, against one call and the JAX package's 2-frame chunks."""
    pj, pt = pp_params
    x = (np.random.default_rng(12).standard_normal((5, 8, 12, 128)) * 0.5).astype(np.float32)
    whole = tpp.decoder(pt, torch.from_numpy(x))
    calls = []
    body = tpp._decoder_body
    monkeypatch.setattr(tpp, "_decoder_body", lambda p, v: calls.append(v.shape[0]) or body(p, v))
    monkeypatch.setattr(tpp, "DECODE_BYTES", 2 * 32 * 48 * 64 * 4)
    out = tpp.decoder(pt, torch.from_numpy(x))
    assert calls == [2, 2, 1]
    monkeypatch.setenv("PROPAINTER_TPU_PP_CHUNK_AREA", "1")
    close_port(out, whole)
    close_jax(out, jpp.decoder(pj, jnp.asarray(x)))


# ------------------------------------------------- everything forced at once


def test_streaming_with_every_plan_forced(monkeypatch):
    """process_streaming at 32x48 over 12 frames, subvideo_length 6, with
    every plan forced (RAFT a pair a call with the directions in turn; the
    completion's directions in turn, temporal chunks, slabs of 2 rows, mid
    chunks, one-frame decodes; the generator's one-frame encodes and
    decodes) against the unforced run: within one uint8 level, and the
    differing bytes counted (no more than one in a thousand)."""
    t, h, w = 12, 32, 48
    frames, masks = moving_box_clip(t, h, w)
    cfg = dict(ref_stride=3, neighbor_length=6, subvideo_length=6, raft_iter=1, fp16="disable")
    plain = stream(port_pipeline(cfg, h, w), frames, masks)[0]
    for mod, name, value in (
        (stages, "RAFT_CALL_BYTES", 1), (tfc, "BATCH_BYTES", 0), (tfc, "ENCODE_BYTES", 0), (tfc, "SLAB_BYTES", 1),
        (tfc, "MID_BYTES", 0), (tfc, "DECODE_BYTES", 1), (tpp, "ENCODE_BYTES", 1), (tpp, "DECODE_BYTES", 1),
    ):
        monkeypatch.setattr(mod, name, value)
    assert stages.raft_form(PipelineConfig(**cfg, process_size=(w, h)), 7, (h, w)) == "per pair, directions in turn"
    forced = stream(port_pipeline(cfg, h, w), frames, masks)[0]
    assert forced.min() >= 0
    d = np.abs(forced - plain)
    assert d.max() <= 1.0
    assert (d > 0).sum() <= d.size // 1000, int((d > 0).sum())
