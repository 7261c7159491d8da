"""RAFT's lookup follows the JAX package's dispatcher: the gate, the
map-dtype blend of B1 and RAFT in that mode, against the JAX package.

The JAX `raft_bi_forward` (models/raft.py:540-580 there) takes the lanes
lookup (fp32 fractions, one rounding) only for small enough volumes and
w8 <= 96; otherwise `lookup_corr`, which rounds the fractions to the
maps' dtype and blends in it. The port's `lookup_mode` makes the same
choice and B1 (`corr_lookup(..., blend="map")`) computes the second
arithmetic. Inputs come from seeded numpy generators; JAX runs on the
CPU, where `lookup_corr` takes its slice-window form. Tolerances: the
lookups are bit-equal (assert_array_equal); RAFT in bf16 within 2e-2 of
the largest flow (bf16 convolutions round at other places in the two
frameworks through a few dozen layers: measured 0.8%).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_propainter_nodes_tpu.models import raft as jraft
from comfyui_propainter_nodes_tpu.ops import deform_conv as jdc
from comfyui_propainter_nodes_tpu.ops.pallas import corr_lanes as jlanes
from comfyui_propainter_nodes_tpu.utils.weights import random_params
from comfyui_propainter_nodes_tpu_torch.models import raft as traft
from comfyui_propainter_nodes_tpu_torch.ops.cuda import corr_lookup as b1
from comfyui_propainter_nodes_tpu_torch.utils.params import from_jax_params
from test_torch_corr_lookup_blocks import block_model

torch.set_num_threads(1)

JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _maps_and_coords(rng, n, h, w, where):
    """Both directions' 4-level maps of n pairs at h x w (levels h x w ..
    h/8 x w/8) as numpy, and coords [2n, h, w, 2]: within 6 px of each
    pixel, or wholly outside every level's map."""
    sizes = [(h >> lvl, w >> lvl) for lvl in range(4)]
    fwd = [rng.standard_normal((n * h * w, a, b)).astype(np.float32) * 2 for a, b in sizes]
    bwd = [rng.standard_normal((n * h * w, a, b)).astype(np.float32) * 2 for a, b in sizes]
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    coords = np.stack([xx, yy], -1)[None] + rng.uniform(-6, 6, (2 * n, h, w, 2)).astype(np.float32)
    if where == "outside":
        coords = np.where(rng.uniform(size=coords.shape) < 0.5, -200.0, 400.0) + coords
    return fwd, bwd, coords.astype(np.float32)


def _jax_lookup_corr(fwd, bwd, coords, dt):
    """JAX `lookup_corr(padded=True)` on the [fwd ++ bwd] pyramid, padded
    by its _PAD zero border."""
    pyr = [
        jnp.pad(jnp.concatenate([jnp.asarray(a), jnp.asarray(b)]).astype(JDT[dt]), ((0, 0), (10, 10), (10, 10)))
        for a, b in zip(fwd, bwd)
    ]
    return np.asarray(jraft.lookup_corr(pyr, jnp.asarray(coords), padded=True).astype(jnp.float32))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("where", ["near", "outside"])
def test_map_blend_is_jax_lookup_corr(dt, where):
    """2 pairs of 12x20 maps (155,520 outputs a direction pair): the
    map-dtype plain lookup equals JAX `lookup_corr` bit for bit in both
    dtypes; in fp32 the lanes blend does too."""
    fwd, bwd, coords = _maps_and_coords(np.random.default_rng(3), 2, 12, 20, where)
    ref = _jax_lookup_corr(fwd, bwd, coords, dt)
    tf = [torch.from_numpy(a).to(dt) for a in fwd]
    tb = [torch.from_numpy(a).to(dt) for a in bwd]
    out = b1.corr_lookup(tf, torch.from_numpy(coords), tb, blend="map")
    assert out.dtype == dt and out.shape == (4, 12, 20, 324)
    np.testing.assert_array_equal(out.float().numpy(), ref)
    if where == "outside":
        assert not ref.any()
    lanes = b1.corr_lookup(tf, torch.from_numpy(coords), tb).float().numpy()
    if dt == torch.float32:
        np.testing.assert_array_equal(lanes, ref)
    elif where == "near":
        assert (lanes != ref).any()  # the fault the map blend repairs


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w", [(2, 17, 24), (1, 17, 23)])
def test_block_model_map_blend_is_the_plain_lookup(n, h, w, dt):
    """B1's block mapping with the map-dtype blend (kernel arithmetic: fp32
    operations, each rounded to bf16) equals the map-dtype plain lookup
    bit for bit; each window element loaded once, each output written
    once; a ragged last block and the direction boundary inside a block."""
    fwd_np, bwd_np, coords = _maps_and_coords(np.random.default_rng(h * w + n), n, h, w, "near")
    coords[0, :2] = -50.0
    fwd = [torch.from_numpy(a).to(dt) for a in fwd_np]
    bwd = [torch.from_numpy(a).to(dt) for a in bwd_np]
    coords = torch.from_numpy(coords)
    out, loads, writes = block_model(fwd, bwd, coords, blend="map")
    assert (loads == 1).all() and (writes == 1).all()
    ref = b1.corr_lookup_plain(fwd, coords, bwd, blend="map")
    assert out.dtype == ref.dtype == dt
    assert torch.equal(out, ref)
    assert torch.count_nonzero(out[0, :2]) == 0


def test_plain_lookup_rejects_unknown_blend():
    fwd, bwd, coords = _maps_and_coords(np.random.default_rng(0), 1, 8, 8, "near")
    with pytest.raises(ValueError, match="blend"):
        b1.corr_lookup([torch.from_numpy(a) for a in fwd], torch.from_numpy(coords),
                       [torch.from_numpy(a) for a in bwd], blend="einsum")


# ------------------------------------------------------------------ the gate


class _Chose(Exception):
    pass


def _raise(branch):
    def f(*a, **k):
        raise _Chose(branch)

    return f


@pytest.fixture(scope="module")
def raft_shapes():
    return {k: v.shape for k, v in random_params("raft", seed=1).items()}


def _jax_branch(monkeypatch, shapes, n, h8, w8, dt):
    """Which lookup the JAX `raft_bi_forward` takes on a TPU for n pairs
    at h8 x w8: traced with abstract inputs (`jax.eval_shape`), its two
    pyramid builders replaced by probes that name the branch."""
    monkeypatch.setattr(jdc, "_USE_PALLAS", True)
    monkeypatch.setattr(jlanes, "build_corr_pyramids_lanes", _raise("lanes"))
    monkeypatch.setattr(jraft, "build_corr_pyramid_bi", _raise("map"))
    spec = {k: jax.ShapeDtypeStruct(s, JDT[dt]) for k, s in shapes.items()}
    frames = jax.ShapeDtypeStruct((1, n + 1, 8 * h8, 8 * w8, 3), jnp.float32)
    with pytest.raises(_Chose) as chose:
        jax.eval_shape(lambda p, f: jraft.raft_bi_forward(p, f, iters=1), spec, frames)
    return str(chose.value)


ENVS = {
    "default": {},
    "budget 500e6": {"PROPAINTER_TPU_LANES_BUDGET": "500000000"},
    "wmax 160, budget 2 GiB": {"PROPAINTER_TPU_LANES_WMAX": "160", "PROPAINTER_TPU_LANES_BUDGET": str(2 << 30)},
    "einsum": {"PROPAINTER_TPU_CORR_KERNEL": "einsum"},
}
# the default choices: the main path (24 frames at 640x360) takes the lanes
# blend in bf16, path A (1280x720 in 4-frame calls) and a 41-frame clip the map
# blend; on the outpaint canvas (768x360, w8 = 96, the lanes' widest) 24 frames
# take the lanes blend and 27 frames, past the 1 GiB volume, the map blend
EXPECTED_DEFAULT = {
    (23, 45, 80): "lanes", (3, 90, 160): "map", (40, 45, 80): "map",
    (23, 45, 96): "lanes", (26, 45, 96): "map",
}


@pytest.mark.parametrize("env", list(ENVS))
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h8,w8", list(EXPECTED_DEFAULT))
def test_gate_chooses_as_jax(monkeypatch, raft_shapes, env, dt, n, h8, w8):
    for k in ("PROPAINTER_TPU_CORR_KERNEL", "PROPAINTER_TPU_LANES_BUDGET", "PROPAINTER_TPU_LANES_WMAX"):
        monkeypatch.delenv(k, raising=False)
    for k, v in ENVS[env].items():
        monkeypatch.setenv(k, v)
    mode = traft.lookup_mode(n, h8, w8, dt)
    assert mode == _jax_branch(monkeypatch, raft_shapes, n, h8, w8, dt)
    if env == "default":
        assert mode == (EXPECTED_DEFAULT[(n, h8, w8)] if dt == torch.bfloat16 else "map")


def test_gate_takes_the_padded_kernel_under_the_switch(monkeypatch):
    monkeypatch.setenv("PROPAINTER_TPU_CORR_KERNEL", "pallas")
    assert traft.lookup_mode(23, 45, 80, torch.bfloat16) == "pallas"


# ------------------------------------------------------------------ RAFT


def test_raft_bf16_map_blend_matches_jax(monkeypatch):
    """RAFT in bf16 at 64x96, 3 frames, 2 iterations, with the map blend
    forced (PROPAINTER_TPU_LANES_WMAX=0), against the JAX RAFT in bf16 on
    the CPU (which takes `lookup_corr`): within 2e-2 of the largest flow."""
    monkeypatch.delenv("PROPAINTER_TPU_CORR_KERNEL", raising=False)
    monkeypatch.setenv("PROPAINTER_TPU_LANES_WMAX", "0")
    raw = random_params("raft", seed=1)
    pj = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in raw.items()}
    pt = {k: v.to(torch.bfloat16) for k, v in from_jax_params(raw).items()}
    frames = np.random.default_rng(0).uniform(-1, 1, (1, 3, 64, 96, 3)).astype(np.float32)
    blends = []
    real = traft.corr_lookup
    monkeypatch.setattr(traft, "corr_lookup", lambda *a, blend: blends.append(blend) or real(*a, blend=blend))
    out = traft.raft_bi_forward(pt, torch.from_numpy(frames), iters=2)
    assert blends == ["map", "map"]
    ref = jraft.raft_bi_forward(pj, jnp.asarray(frames), iters=2)
    for o, r in zip(out, ref):
        r = np.asarray(r, dtype=np.float32)
        assert o.dtype == torch.float32 and o.shape == r.shape
        assert np.isfinite(o.numpy()).all()
        assert np.abs(o.numpy() - r).max() <= 2e-2 * np.abs(r).max()
