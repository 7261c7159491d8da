"""The schedules of the segment-tiled attention kernel (B4,
csrc/window_attention_tiled.cu), modelled in torch on the CPU.

The model walks what the kernel's two loops walk: an occupied window's
keys in the padded order [window | rolled padded to SEG_TILE | pooled
padded to SEG_TILE] (padding keys: zero rows, bias -1e9), cut into splits
and each split into key tiles; per split an online softmax whose running
max starts at -1e30, then the combine, which weights split s by
base^(m_s - m) (one split: o / l). Clean windows decode only the frames a
query tile touches.
  * bf16, the tensor-core loop (csrc/flash_mma.cuh): 64-query tiles,
    64-key tiles, one split a window, m in base 2 (log2 e folded into the
    scale and the bias), P rounded to bf16 before P·V where the kernel
    does it;
  * fp32, the CUDA-core loop of B3, B4 and B5 (csrc/flash_f32.cuh):
    64-query tiles, 32-key tiles, m in base e; B4's splits of SPLIT_KEYS
    keys, or of fewer in the tests so that splits of padding keys only,
    and a first split all -1e9, come up; one split a window (B3's and
    B5's single pass); one and three key tiles a split.
Inputs come from a seeded numpy generator.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental.pallas import tpu as pltpu

from comfyui_propainter_nodes_tpu.ops.pallas import window_attention as jwa
from comfyui_propainter_nodes_tpu_torch.ops.cuda import window_attention as b4

torch.set_num_threads(1)

LOG2E = 1.4426950408889634
# (query tile, key tile, m in base 2) of each loop
LOOPS = {"mma": (64, 64, True), "f32": (64, 32, False)}


def _tiles(q, k, v, bias, k0, k1, loop, round_p, key_frame=None, row_frame=None):
    """One flash loop over keys [k0, k1) in the loop's key tiles: (m, l,
    o) unnormalised, fp32, m in the loop's base."""
    _, bk, base2 = LOOPS[loop]
    lg, exp = (LOG2E, torch.exp2) if base2 else (1.0, torch.exp)
    m = torch.full((q.shape[0], 1), -1e30)
    l = torch.zeros((q.shape[0], 1))
    o = torch.zeros_like(q)
    for t0 in range(k0, k1, bk):
        t1 = min(t0 + bk, k1)
        s = q @ k[t0:t1].T * (q.shape[1] ** -0.5 * lg) + bias[None, t0:t1] * lg
        if row_frame is not None:
            s = torch.where(row_frame[:, None] == key_frame[None, t0:t1], s, -torch.inf)
        m_new = torch.maximum(m, s.max(1, keepdim=True).values)
        alpha = exp(m - m_new)
        p = exp(s - m_new)
        l = l * alpha + p.sum(1, keepdim=True)
        if round_p:
            p = p.bfloat16().float()
        o = o * alpha + p @ v[t0:t1]
        m = m_new
    return m, l, o


def _split_rows(q, k, v, bias, split_keys, loop, round_p):
    """One query tile over an occupied window's padded keys: a flash loop
    per split, then the combine (one split: o / l)."""
    n = k.shape[0]
    parts = [_tiles(q, k, v, bias, s0, min(n, s0 + split_keys), loop, round_p) for s0 in range(0, n, split_keys)]
    if len(parts) == 1:
        _, l, o = parts[0]
        return o / l
    exp = torch.exp2 if LOOPS[loop][2] else torch.exp
    mx = torch.stack([m for m, _, _ in parts]).max(0).values
    w = [exp(m - mx) for m, _, _ in parts]
    return sum(wi * o for wi, (_, _, o) in zip(w, parts)) / sum(wi * l for wi, (_, l, _) in zip(w, parts))


def split_model(win_q, win_k, win_v, rolled_k, rolled_v, pool_k, pool_v, occ, bias_w, bias_r, bias_p,
                n_win_per_b, loop, split_keys, round_p=False):
    """window_attention_tiled as `loop` tiles it, in splits of split_keys
    keys (None: one split a window); fp32 out."""

    def pad(k, v, bias):
        extra = b4._padded(k.shape[2]) - k.shape[2]
        return F.pad(k, (0, 0, 0, extra)), F.pad(v, (0, 0, 0, extra)), F.pad(bias, (0, extra), value=b4.NEG)

    rolled_k, rolled_v, bias_r = pad(rolled_k.float(), rolled_v.float(), bias_r.float())
    pool_k, pool_v, bias_p = pad(pool_k.float(), pool_v.float(), bias_p.float())
    nw, nh, t, wsz, ch = win_q.shape
    qt = t * wsz
    bq = LOOPS[loop][0]
    keys = split_keys or qt + rolled_k.shape[2] + pool_k.shape[2]
    frames = torch.arange(qt) // wsz
    out = torch.zeros(nw, nh, qt, ch)
    for w in range(nw):
        b = w // n_win_per_b
        for h in range(nh):
            q = win_q[w, h].float().reshape(qt, ch)
            wk, wv = win_k[w, h].float().reshape(qt, ch), win_v[w, h].float().reshape(qt, ch)
            for q0 in range(0, qt, bq):
                nq = min(bq, qt - q0)
                if occ[w]:
                    k = torch.cat([wk, rolled_k[w, h], pool_k[b, h]])
                    v = torch.cat([wv, rolled_v[w, h], pool_v[b, h]])
                    bias = torch.cat([bias_w[b].float(), bias_r[b], bias_p[b]])
                    out[w, h, q0 : q0 + nq] = _split_rows(q[q0 : q0 + nq], k, v, bias, keys, loop, round_p)
                else:  # the frames this query tile touches, no splits
                    klo = q0 // wsz * wsz
                    khi = min(qt, ((q0 + nq - 1) // wsz + 1) * wsz)
                    _, l, o = _tiles(q[q0 : q0 + nq], wk, wv, torch.zeros(qt), klo, khi, loop, round_p,
                                     frames, frames[q0 : q0 + nq])
                    out[w, h, q0 : q0 + nq] = o / l
    return out.reshape(nw, nh, t, wsz, ch)


def _inputs(rng, occ, ch, b=2, nwb=2, nh=2, t=5, wsz=45, rl_per=37, pl_per=23):
    """QT = 225, not a multiple of 64 or 32; t_ind = frames 0, 2, 4; rolled 111
    keys padded to 256 (keys 336-480 of the padded order are padding, so
    a 64-key split [384, 448) holds padding keys only), pooled 69 padded
    to 256. Batch row 1's frame 0 is padded: with frame 1 outside t_ind,
    its first 90 keys, so its whole first 64-key split, are all -1e9."""
    nw = b * nwb
    r = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    t_sel = (t + 1) // 2
    arrays = [r(nw, nh, t, wsz, ch), r(nw, nh, t, wsz, ch), r(nw, nh, t, wsz, ch),
              r(nw, nh, t_sel * rl_per, ch), r(nw, nh, t_sel * rl_per, ch),
              r(b, nh, t_sel * pl_per, ch), r(b, nh, t_sel * pl_per, ch)]
    in_tind = np.arange(t) % 2 == 0
    tv = np.ones((b, t), bool)
    tv[1, 0] = False
    tv[1:, -1] = False
    bias_w = np.where(in_tind[None] & tv, 0.0, -1e9).repeat(wsz, 1)
    sel = tv[:, in_tind]
    bias_r = np.where(sel, 0.0, -1e9).repeat(rl_per, 1)
    bias_p = np.where(sel, 0.0, -1e9).repeat(pl_per, 1)
    return arrays + [np.asarray(occ)] + [a.astype(np.float32) for a in (bias_w, bias_r, bias_p)], nwb


_OCC = {"mixed": [True, False, False, True], "clean": [False] * 4, "occupied": [True] * 4}
# (loop, keys a split) of the kernel's bf16 and fp32 schedules, and fp32
# with short splits: 64 keys (splits of padding keys only, a first split
# all -1e9) and 192. The "fp32*" cases, which held the earlier fp32 loop
# (32-query, 16-key tiles) to the same splits, now hold the fp32 loop over
# the padded keys in one split a window ("fp32", as B3 and B5 walk theirs)
# and in splits of one and three key tiles ("fp32_64", "fp32_192")
_SCHEDULES = {"bf16": ("mma", None), "f32": ("f32", b4.SPLIT_KEYS), "f32_64": ("f32", 64),
              "f32_192": ("f32", 192), "fp32": ("f32", None), "fp32_64": ("f32", 32),
              "fp32_192": ("f32", 96)}


def test_inputs_put_the_edges_in_play():
    """The padded key order has a 64-key split of padding keys only, batch
    row 1's first split is all -1e9, QT is no multiple of either query
    tile, and the fp32 schedule has several splits."""
    args, _ = _inputs(np.random.default_rng(0), _OCC["mixed"], 16)
    qt, rl, pl_len = 225, args[3].shape[2], args[5].shape[2]
    rlp, plp = b4._padded(rl), b4._padded(pl_len)
    assert qt % 64 and qt % 32 and (rl, rlp, pl_len, plp) == (111, 256, 69, 256)
    pad_keys = set(range(qt + rl, qt + rlp)) | set(range(qt + rlp + pl_len, qt + rlp + plp))
    assert any(set(range(s0, s0 + 64)) <= pad_keys for s0 in range(0, qt + rlp + plp, 64))
    assert (args[8][1, :64] == -1e9).all() and (args[8][0, :45] == 0).all()
    assert b4.split_plan(qt + rlp + plp, torch.float32)[0] > 1
    assert b4.split_plan(qt + rlp + plp, torch.bfloat16)[0] == 1


@pytest.mark.parametrize("ch", [64, 128])
@pytest.mark.parametrize("schedule", list(_SCHEDULES))
@pytest.mark.parametrize("occ", list(_OCC))
def test_split_schedule_matches_plain_fp32(occ, schedule, ch):
    """P unrounded: each schedule and its combine are the plain attention
    over the padded keys, 1e-5 (fp32)."""
    args, nwb = _inputs(np.random.default_rng(1), _OCC[occ], ch)
    ta = [torch.from_numpy(a) for a in args]
    ref = b4.window_attention_tiled_plain(*ta, nwb)
    out = split_model(*ta, nwb, *_SCHEDULES[schedule])
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("schedule", ["f32", "f32_64", "f32_192"])
@pytest.mark.parametrize("occ", list(_OCC))
def test_f32_split_schedule_head_width_40(occ, schedule):
    """The fp32 loop takes any head width up to 128 (bf16 needs a multiple
    of 16): at ch 40 its schedules and the combine are the plain attention
    over the padded keys, 1e-5."""
    args, nwb = _inputs(np.random.default_rng(1), _OCC[occ], 40)
    ta = [torch.from_numpy(a) for a in args]
    ref = b4.window_attention_tiled_plain(*ta, nwb)
    out = split_model(*ta, nwb, *_SCHEDULES[schedule])
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("ch", [64, 128])
@pytest.mark.parametrize("occ", ["mixed", "occupied"])
def test_split_schedule_bf16_matches_pallas_tiled(monkeypatch, occ, ch):
    """The bf16 schedule, P rounded to bf16 on bf16 inputs, against the
    JAX package's window_attention_pallas forced to its tiled kernel
    (interpret mode, SEG_TILE 256 as the port's), whose output is bf16:
    the card's bf16 tolerance, 3e-2."""
    args, nwb = _inputs(np.random.default_rng(3), _OCC[occ], ch)
    monkeypatch.setattr(jwa, "_window_attention_single", jwa._window_attention_tiled)
    ja = [jnp.asarray(a, jnp.bfloat16) if i < 7 else jnp.asarray(a) for i, a in enumerate(args)]
    with pltpu.force_tpu_interpret_mode():
        ref = jwa.window_attention_pallas(*ja, n_win_per_b=nwb)
    assert ref.dtype == jnp.bfloat16
    bf = [torch.from_numpy(a).bfloat16().float() if i < 7 else torch.from_numpy(a) for i, a in enumerate(args)]
    out = split_model(*bf, nwb, *_SCHEDULES["bf16"], round_p=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref, np.float32), atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("ch", [40, 128])
@pytest.mark.parametrize("occ", ["mixed", "occupied"])
def test_split_schedule_f32_matches_pallas_tiled(monkeypatch, occ, ch):
    """The fp32 schedule B4 runs (flash_f32.cuh's tiles, SPLIT_KEYS keys a
    split, base-e combine) against the JAX package's window_attention_pallas
    on fp32 inputs forced to its tiled kernel (interpret mode, SEG_TILE 256
    as the port's): both fp32 throughout, so 1e-5."""
    args, nwb = _inputs(np.random.default_rng(4), _OCC[occ], ch)
    monkeypatch.setattr(jwa, "_window_attention_single", jwa._window_attention_tiled)
    with pltpu.force_tpu_interpret_mode():
        ref = jwa.window_attention_pallas(*[jnp.asarray(a) for a in args], n_win_per_b=nwb)
    assert ref.dtype == jnp.float32
    out = split_model(*[torch.from_numpy(a) for a in args], nwb, *_SCHEDULES["f32"])
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
