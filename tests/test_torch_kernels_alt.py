"""The port's kernels behind the JAX package's switches and size gate:
plain versions vs the JAX Pallas kernels.

B7/B6, the window lookup from zero-padded maps (one and four levels), with
RAFT under PROPAINTER_TPU_CORR_KERNEL=pallas, which takes B6, and B4, the
segment-tiled window attention. On the CPU each wrapper takes its
plain version; the JAX side runs the Pallas kernel in interpret mode, as
the JAX package's own tests do (tests/test_pallas_kernels.py,
tests/test_pallas_attention.py). The CUDA kernels are held against the
plain versions in tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from comfyui_propainter_nodes_tpu.models import raft as jraft
from comfyui_propainter_nodes_tpu.ops import deform_conv as jdc
from comfyui_propainter_nodes_tpu.ops.pallas import window_attention as jwa
from comfyui_propainter_nodes_tpu.ops.pallas.corr_lookup import corr_window_lookup4_pallas, corr_window_lookup_pallas
from comfyui_propainter_nodes_tpu.utils.weights import random_params
from comfyui_propainter_nodes_tpu_torch.models import raft as traft
from comfyui_propainter_nodes_tpu_torch.ops.cuda import corr_window as b67
from comfyui_propainter_nodes_tpu_torch.ops.cuda import window_attention as b34
from comfyui_propainter_nodes_tpu_torch.utils.params import from_jax_params

torch.set_num_threads(1)


def _starts(rng, m, hp, wp):
    return (rng.integers(0, hp - 10, m).astype(np.int32), rng.integers(0, wp - 10, m).astype(np.int32),
            rng.uniform(0, 1, m).astype(np.float32), rng.uniform(0, 1, m).astype(np.float32))


def test_corr_window_lookup_plain_matches_pallas():
    """One level (B7), the shapes of the JAX package's own test. Tolerance
    1e-5: the same four taps and the same fp32 combine order."""
    rng = np.random.default_rng(1)
    m, hp, wp = 300, 40, 50
    corr = rng.standard_normal((m, hp, wp)).astype(np.float32)
    sy, sx, fy, fx = _starts(rng, m, hp, wp)
    with pltpu.force_tpu_interpret_mode():
        ref = corr_window_lookup_pallas(*[jnp.asarray(a) for a in (corr, sy, sx, fy, fx)])
    out = b67.corr_window_lookup(*[torch.from_numpy(a) for a in (corr, sy, sx, fy, fx)])
    assert out.shape == (m, 9, 9) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_corr_window_lookup4_plain_matches_pallas():
    """Four levels (B6) of the JAX package's test shapes, (dy, dx) order."""
    rng = np.random.default_rng(2)
    m = 300
    maps, starts = [], []
    for hp, wp in [(40, 50), (28, 34), (22, 26), (20, 22)]:
        maps.append(rng.standard_normal((m, hp, wp)).astype(np.float32))
        starts.append(_starts(rng, m, hp, wp))
    sy, sx, fy, fx = (np.stack([s[i] for s in starts]) for i in range(4))
    with pltpu.force_tpu_interpret_mode():
        ref = corr_window_lookup4_pallas([jnp.asarray(a) for a in maps], *[jnp.asarray(a) for a in (sy, sx, fy, fx)])
    out = b67.corr_window_lookup4([torch.from_numpy(a) for a in maps], *[torch.from_numpy(a) for a in (sy, sx, fy, fx)])
    assert out.shape == (m, 4, 9, 9)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_corr_window_starts_are_clamped():
    """Starts beyond the map read the edge window, never outside it."""
    rng = np.random.default_rng(4)
    corr = torch.from_numpy(rng.standard_normal((3, 20, 24)).astype(np.float32))
    fy = fx = torch.full((3,), 0.25)
    out = b67.corr_window_lookup(corr, torch.tensor([-5, 99, 10]), torch.tensor([99, -7, 14]), fy, fx)
    ref = b67.corr_window_lookup(corr, torch.tensor([0, 10, 10]), torch.tensor([14, 0, 14]), fy, fx)
    torch.testing.assert_close(out, ref, atol=0, rtol=0)


def _close_rel(port, ref, rel=1e-4):
    ref = np.asarray(ref)
    port = port.detach().numpy()
    assert port.shape == ref.shape, (port.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(port - ref).max())
    assert err <= rel * scale, f"max abs err {err} > {rel} * {scale}"


def test_raft_padded_corr_kernel_matches_jax(monkeypatch):
    """RAFT with PROPAINTER_TPU_CORR_KERNEL=pallas in both packages: the
    padded [fwd ++ bwd] pyramid and the four-level window lookup (the
    Pallas kernel in interpret mode). The setup and tolerance of
    tests/test_torch_models.py::test_raft_bi_forward: 128x160, 3 frames,
    2 iterations, fp32, 1e-4 of the largest flow."""
    raw = random_params("raft", seed=1)
    pj, pt = {k: jnp.asarray(v) for k, v in raw.items()}, from_jax_params(raw)
    rng = np.random.default_rng(0)
    frames = rng.uniform(-1, 1, (1, 3, 128, 160, 3)).astype(np.float32)
    monkeypatch.setenv("PROPAINTER_TPU_CORR_KERNEL", "pallas")
    monkeypatch.setattr(jdc, "_USE_PALLAS", True)
    with pltpu.force_tpu_interpret_mode():
        ref_f, ref_b = jraft.raft_bi_forward(pj, jnp.asarray(frames), iters=2)
    calls = []
    real = traft.lookup_padded
    monkeypatch.setattr(traft, "lookup_padded", lambda *a: calls.append(1) or real(*a))
    out_f, out_b = traft.raft_bi_forward(pt, torch.from_numpy(frames), iters=2)
    assert len(calls) == 2  # one lookup per iteration, both directions at once
    _close_rel(out_f, ref_f)
    _close_rel(out_b, ref_b)


def test_padded_pyramid_layout():
    """Levels [2N*H*W, H_l + 20, W_l + 20] with exact zeros in the border,
    forward pixels first, and the backward half the transposed product."""
    rng = np.random.default_rng(6)
    f1 = torch.from_numpy(rng.standard_normal((2, 16, 24, 8)).astype(np.float32))
    f2 = torch.from_numpy(rng.standard_normal((2, 16, 24, 8)).astype(np.float32))
    pyr = traft.build_padded_pyramid_bi(f1, f2)
    fwd, bwd = traft.build_corr_pyramids(f1, f2)
    pad = traft.PAD
    assert [tuple(p.shape) for p in pyr] == [(2 * 768, 16 + 2 * pad, 24 + 2 * pad), (1536, 28, 32), (1536, 24, 26), (1536, 22, 23)]
    for lvl, p in enumerate(pyr):
        inner = p[:, pad : p.shape[1] - pad, pad : p.shape[2] - pad]
        torch.testing.assert_close(inner, torch.cat([fwd[lvl], bwd[lvl]]), atol=0, rtol=0)
        assert float(p.abs().sum()) == pytest.approx(float(inner.abs().sum()))


def _tiled_inputs():
    """The JAX package's tiled-kernel test inputs
    (tests/test_pallas_attention.py::test_tiled_kernel_matches_single)."""
    rng = np.random.default_rng(8)
    n_win_per_b, b, n_head, t, wsz, ch = 4, 2, 2, 5, 9, 32
    w = b * n_win_per_b
    qt = t * wsz
    rl, pl_len = 100, 70  # not tile multiples: the padding path
    r = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    arrays = [r(w, n_head, t, wsz, ch), r(w, n_head, t, wsz, ch), r(w, n_head, t, wsz, ch),
              r(w, n_head, rl, ch), r(w, n_head, rl, ch), r(b, n_head, pl_len, ch), r(b, n_head, pl_len, ch)]
    occ = rng.integers(0, 2, (w,)).astype(np.int32)
    biases = [np.where(rng.uniform(size=(b, n)) > 0.3, 0.0, -1e9).astype(np.float32) for n in (qt, rl, pl_len)]
    return arrays + [occ] + biases, n_win_per_b


@pytest.mark.parametrize("port_tile", [64, 256])
def test_window_attention_tiled_plain_matches_pallas(monkeypatch, port_tile):
    """B4 with SEG_TILE = 64 on the TPU side, so the segments span several
    tiles, and 64 or 256 on the port's. Tolerance as the JAX package's own
    tiled-kernel test."""
    args, nwb = _tiled_inputs()
    monkeypatch.setattr(jwa, "SEG_TILE", 64)
    monkeypatch.setattr(b34, "SEG_TILE", port_tile)
    with pltpu.force_tpu_interpret_mode():
        ref = jwa._window_attention_tiled(*[jnp.asarray(a) for a in args], n_win_per_b=nwb)
    targs = [torch.from_numpy(a) for a in args]
    out = b34.window_attention_tiled(*targs[:7], targs[7].bool(), *targs[8:], n_win_per_b=nwb)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-4)


# (W, head, T, wsz, ch, RL, PL, dtype): the node's own shapes first
_DISPATCH_SHAPES = [
    (180, 4, 13, 45, 128, 7 * 148, 7 * 91, "bfloat16"),   # 640x360, t_sel 7: ~10.3e6
    (180, 4, 13, 45, 128, 6 * 148, 6 * 91, "bfloat16"),   # 640x360, t_sel 6
    (720, 4, 13, 45, 128, 7 * 148, 7 * 405, "bfloat16"),  # 1280x720, t_sel 7: ~14.8e6
    (720, 4, 13, 45, 128, 6 * 148, 6 * 405, "bfloat16"),  # 1280x720, t_sel 6
    (180, 4, 13, 45, 128, 7 * 148, 7 * 91, "float32"),    # 640x360 at fp16=disable
    (24, 4, 8, 45, 128, 4 * 148, 4 * 40, "float32"),
    (24, 4, 8, 45, 128, 4 * 148, 4 * 40, "bfloat16"),
    (6, 2, 4, 8, 16, 10, 12, "float32"),
]


@pytest.mark.parametrize("shape", _DISPATCH_SHAPES)
def test_dispatcher_chooses_as_jax(monkeypatch, shape):
    """The port's dispatcher picks the tiled kernel exactly where
    `window_attention_pallas` does (pure shape arithmetic: the two JAX
    kernels are replaced by stubs that name themselves)."""
    nw, nh, t, wsz, ch, rl, pl_len, dt = shape
    monkeypatch.setattr(jwa, "_window_attention_single", lambda *a, **k: "single")
    monkeypatch.setattr(jwa, "_window_attention_tiled", lambda *a, **k: "tiled")
    spec = lambda *s: jax.ShapeDtypeStruct(s, getattr(jnp, dt))  # noqa: E731
    jax_pick = jwa.window_attention_pallas(
        spec(nw, nh, t, wsz, ch), None, None, spec(nw, nh, rl, ch), None, spec(nw // 5 or 1, nh, pl_len, ch), None,
        None, None, None, None, n_win_per_b=5,
    )
    meta = lambda *s: torch.empty(s, dtype=getattr(torch, dt), device="meta")  # noqa: E731
    port_tiled = b34.uses_tiled(meta(nw, nh, t, wsz, ch), meta(nw, nh, rl, ch), meta(1, nh, pl_len, ch))
    assert port_tiled == (jax_pick == "tiled")
    if shape[:7] == _DISPATCH_SHAPES[0][:7] and dt == "bfloat16":
        assert not port_tiled  # the 640x360 node stays on the single-pass kernel
    if pl_len == 7 * 405:
        assert port_tiled  # the 1280x720 node takes the tiled one


def test_new_wrappers_reject_other_devices():
    x = torch.zeros((2, 12, 12), device="meta")
    s = torch.zeros((2,), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        b67.corr_window_lookup(x, s, s, s, s)
    with pytest.raises(ValueError, match="unsupported device"):
        b67.corr_window_lookup4([x] * 4, s, s, s, s)
    q = torch.zeros((2, 1, 2, 4, 8), device="meta")
    r = torch.zeros((2, 1, 3, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        b34.window_attention_tiled(q, q, q, r, r, r, r, s, s, s, s, n_win_per_b=1)
