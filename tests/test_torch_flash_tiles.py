"""The tile schedules of the attention loops, modelled in torch on the CPU:
the tensor-core loop (csrc/flash_mma.cuh, bf16) and the fp32 CUDA-core
loop (csrc/flash_f32.cuh) of the single-pass and halo kernels.

The model walks what the CUDA kernels walk: 64-query tiles, the decoder's
key order in key tiles (64 keys in the bf16 loop, 32 in the fp32 one; a
tile may straddle segment ends; the ragged tail is absent), an online
softmax whose running max starts at -1e30, P rounded to bf16 before P·V
where the kernel does it, fp32 accumulation.
Clean windows decode only the frames a query tile touches and mask keys of
other frames. The halo kernel's key order walks only the survivor
positions of each t_ind frame. Inputs are made from a seeded numpy
generator.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from comfyui_propainter_nodes_tpu.ops.pallas.window_attention import window_attention_pallas
from comfyui_propainter_nodes_tpu_torch.ops.cuda import window_attention as b3
from comfyui_propainter_nodes_tpu_torch.ops.cuda import window_attention_halo as b5

torch.set_num_threads(1)

BQ = BK = 64  # the bf16 loop's query and key tiles
F32_BQ, F32_BK = 64, 32  # the fp32 loop's


def _tile_rows(q, k, v, bias, key_frame, row_frame, round_p, bk=BK):
    """One query tile [nq, ch] over a key sequence [L, ch], key tile by key
    tile (bk keys), as the kernel's loop; fp32, base e."""
    scale = q.shape[1] ** -0.5
    m = torch.full((q.shape[0], 1), -1e30)
    l = torch.zeros((q.shape[0], 1))
    o = torch.zeros_like(q)
    for k0 in range(0, k.shape[0], bk):
        s = q @ k[k0 : k0 + bk].T * scale + bias[None, k0 : k0 + bk]
        if row_frame is not None:
            s = torch.where(row_frame[:, None] == key_frame[None, k0 : k0 + bk], s, -torch.inf)
        m_new = torch.maximum(m, s.max(1, keepdim=True).values)
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(1, keepdim=True)
        if round_p:
            p = p.bfloat16().float()
        o = o * alpha + p @ v[k0 : k0 + bk]
        m = m_new
    return o / l


def flash_model(win_q, win_k, win_v, rolled_k, rolled_v, pool_k, pool_v, occ, bias_w, bias_r, bias_p,
                n_win_per_b, round_p=False, bq=BQ, bk=BK):
    """window_attention as the single-pass kernel tiles it (bq-query and
    bk-key tiles); fp32 out."""
    nw, nh, t, wsz, ch = win_q.shape
    qt = t * wsz
    f = lambda a: a.float()  # noqa: E731
    out = torch.zeros(nw, nh, qt, ch)
    for w in range(nw):
        b = w // n_win_per_b
        for h in range(nh):
            q = f(win_q[w, h]).reshape(qt, ch)
            wk, wv = f(win_k[w, h]).reshape(qt, ch), f(win_v[w, h]).reshape(qt, ch)
            for q0 in range(0, qt, bq):
                nq = min(bq, qt - q0)
                if occ[w]:
                    k = torch.cat([wk, f(rolled_k[w, h]), f(pool_k[b, h])])
                    v = torch.cat([wv, f(rolled_v[w, h]), f(pool_v[b, h])])
                    bias = torch.cat([bias_w[b], bias_r[b], bias_p[b]]).float()
                    out[w, h, q0 : q0 + nq] = _tile_rows(q[q0 : q0 + nq], k, v, bias, None, None, round_p, bk)
                else:  # the frames this query tile touches
                    klo = q0 // wsz * wsz
                    khi = min(qt, ((q0 + nq - 1) // wsz + 1) * wsz)
                    frames = torch.arange(qt) // wsz
                    out[w, h, q0 : q0 + nq] = _tile_rows(
                        q[q0 : q0 + nq], wk[klo:khi], wv[klo:khi], torch.zeros(khi - klo),
                        frames[klo:khi], frames[q0 : q0 + nq], round_p, bk,
                    )
    return out.reshape(nw, nh, t, wsz, ch)


def _inputs(rng, occ, b=2, nwb=2, nh=2, t=5, wsz=45, ch=16, rl_per=37, pl_per=23):
    """QT = 225, not a multiple of 64; t_ind = frames 0, 2, 4; segments of
    225 | 111 | 69 keys, so key tiles straddle both segment ends and the
    last one is ragged. Batch row 1's frame 0 is padded: with frame 1
    outside t_ind, its first key tile is all -1e9."""
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


@pytest.mark.parametrize("bq,bk", [(BQ, BK), (F32_BQ, F32_BK)])
def test_inputs_put_the_edges_in_play(bq, bk):
    """The shapes do what _inputs says for both loops' tiles: ragged tiles,
    straddled segment ends, a clean query tile over three frames, an all
    -1e9 first tile."""
    args, _ = _inputs(np.random.default_rng(0), _OCC["mixed"])
    qt, rl, pl_len = 5 * 45, args[3].shape[2], args[5].shape[2]
    assert qt % bq and qt % bk and (qt + rl) % bk and (qt + rl + pl_len) % bk
    assert len({q // 45 for q in range(2 * bq, 3 * bq)}) == 3
    assert (args[8][1, :bk] == -1e9).all()


@pytest.mark.parametrize("occ", list(_OCC))
def test_schedule_matches_plain_fp32(occ):
    """(a) P unrounded: the tile schedule is the plain attention, 1e-5."""
    args, nwb = _inputs(np.random.default_rng(1), _OCC[occ])
    ta = [torch.from_numpy(a) for a in args]
    ref = b3.window_attention_plain(*ta, nwb)
    np.testing.assert_allclose(flash_model(*ta, nwb).numpy(), ref.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("ch", [40, 64, 128])
@pytest.mark.parametrize("occ", list(_OCC))
def test_f32_schedule_matches_plain(occ, ch):
    """The fp32 loop's schedule (64-query tiles, 32-key tiles, base e, P
    unrounded) is the plain attention, 1e-5, at head widths 40, 64 and
    128."""
    args, nwb = _inputs(np.random.default_rng(5), _OCC[occ], ch=ch)
    ta = [torch.from_numpy(a) for a in args]
    ref = b3.window_attention_plain(*ta, nwb)
    out = flash_model(*ta, nwb, bq=F32_BQ, bk=F32_BK)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("ch", [40, 128])
def test_f32_schedule_matches_pallas_single(ch):
    """The fp32 loop's schedule against the JAX package's
    window_attention_pallas on fp32 inputs (its single-pass kernel at
    these sizes) in interpret mode: both fp32 throughout, so 1e-5."""
    args, nwb = _inputs(np.random.default_rng(6), _OCC["mixed"], ch=ch)
    with pltpu.force_tpu_interpret_mode():
        ref = window_attention_pallas(*[jnp.asarray(a) for a in args], n_win_per_b=nwb)
    assert ref.dtype == jnp.float32
    out = flash_model(*[torch.from_numpy(a) for a in args], nwb, bq=F32_BQ, bk=F32_BK)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def _bf16(args):
    """bf16-rounded Q/K/V (as fp32 arrays) and the fp32 biases."""
    return [a.astype(jnp.bfloat16).astype(np.float32) if i < 7 else a for i, a in enumerate(args)]


@pytest.mark.parametrize("occ", ["mixed", "occupied"])
def test_schedule_bf16_matches_plain(occ):
    """(b) P rounded to bf16 before P·V on bf16 inputs, against the plain
    version of the same inputs in fp32: within the bf16 tolerance of the
    card tests (3e-2)."""
    args, nwb = _inputs(np.random.default_rng(2), _OCC[occ])
    ta = [torch.from_numpy(a) for a in _bf16(args)]
    ref = b3.window_attention_plain(*ta, nwb)
    out = flash_model(*ta, nwb, round_p=True)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=3e-2, rtol=3e-2)


def test_schedule_bf16_matches_pallas_single():
    """(b) The same against the JAX package's window_attention_pallas on
    bf16 inputs (its single-pass kernel at these sizes) in interpret mode.
    Its P is rounded after normalisation in clean windows and its output
    is bf16, so the tolerance is the card's bf16 one (3e-2)."""
    args, nwb = _inputs(np.random.default_rng(3), _OCC["mixed"])
    ja = [jnp.asarray(a, jnp.bfloat16) if i < 7 else jnp.asarray(a) for i, a in enumerate(args)]
    with pltpu.force_tpu_interpret_mode():
        ref = window_attention_pallas(*ja, n_win_per_b=nwb)
    assert ref.dtype == jnp.bfloat16
    out = flash_model(*[torch.from_numpy(a) for a in _bf16(args)], nwb, round_p=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref, np.float32), atol=3e-2, rtol=3e-2)


def _halo_inputs(rng, occ, pad_first, t=4, ch=16):
    """Two batch rows of a window-padded 10x18 grid (2x2 windows of 5x9),
    t frames, t_ind = every other frame from frame 0, 2 heads of width ch."""
    b, hp, wp, nh = 2, 10, 18, 2
    c = nh * ch
    ti = np.arange(0, t, 2)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    q, k, v = r(b, t, hp, wp, c), r(b, t, hp, wp, c), r(b, t, hp, wp, c)

    def cpad(a):
        a = a[:, ti]
        a = np.concatenate([a[:, :, -3:], a, a[:, :, :3]], 2)
        return np.ascontiguousarray(np.concatenate([a[:, :, :, -5:], a, a[:, :, :, :5]], 3))

    pk, pv = r(b, nh, len(ti) * 10, ch), r(b, nh, len(ti) * 10, ch)
    tv = np.ones((b, t), bool)
    tv[1, -1] = False
    if pad_first:
        tv[1, 0] = False
    in_tind = np.isin(np.arange(t), ti)
    bias_w = np.where(in_tind[None] & tv, 0.0, -1e9).repeat(45, 1).astype(np.float32)
    bias_hv = np.where(tv[:, ti], 0.0, -1e9).astype(np.float32)
    bias_p = bias_hv.repeat(10, 1)
    arrays = (q, k, v, cpad(k), cpad(v), pk, pv, np.asarray(occ).reshape(b, 2, 2), bias_w, bias_hv, bias_p)
    return tuple(torch.from_numpy(a) for a in arrays), nh


@pytest.mark.parametrize("occ,pad_first", [([True, False, False, True, False, True, True, False], False),
                                           ([True] * 8, True)])
def test_halo_survivor_order_matches_plain(occ, pad_first):
    """(c) The halo kernel's key order, [window | the survivors of each
    t_ind frame's halo | pooled], tiled as the kernel tiles it, against the
    plain version over all 209 halo positions: 1e-6 in fp32 (a skipped
    position's weight is an exact 0)."""
    args, nh = _halo_inputs(np.random.default_rng(4), occ, pad_first)
    out, ref = _halo_model(args, nh, BQ, BK)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-6, rtol=1e-6)


def _halo_model(args, nh, bq, bk):
    """The halo kernel's key order tiled in bq-query and bk-key tiles, and
    the plain version over all 209 halo positions."""
    q, k, v, khalo, vhalo, pk, pv, occ_t, bias_w, bias_hv, bias_p = args
    ws = (5, 9)
    b, t, hp, wp, c = q.shape
    surv = torch.from_numpy(b5.halo_survivors(ws)).long()
    assert surv.numel() == 148
    hhw = 11 * 19
    idx = (torch.arange(khalo.shape[1])[:, None] * hhw + surv[None]).reshape(-1)
    halo_k = b5._halo_windows(khalo, ws, nh)[:, :, idx]
    halo_v = b5._halo_windows(vhalo, ws, nh)[:, :, idx]
    bias_h = b5._halo_bias(bias_hv, ws).reshape(b, -1)[:, idx]
    out = flash_model(b5._windows(q, ws, nh), b5._windows(k, ws, nh), b5._windows(v, ws, nh), halo_k, halo_v,
                      pk, pv, occ_t.reshape(-1), bias_w, bias_h, bias_p, 4, bq=bq, bk=bk)
    out = out.reshape(b, 2, 2, nh, t, 5, 9, c // nh).permute(0, 4, 1, 5, 2, 6, 3, 7).reshape(b, t, hp, wp, c)
    return out, b5.window_attention_halo_plain(*args, window_size=ws, n_head=nh)


@pytest.mark.parametrize("ch", [40, 64])
@pytest.mark.parametrize("occ,pad_first", [([True, False, False, True, False, True, False, False], False),
                                           ([True] * 8, True)])
def test_halo_survivor_order_f32_tiles_matches_plain(occ, pad_first, ch):
    """(d) The halo kernel's fp32 inputs on the fp32 loop: the same key
    order in its 64-query and 32-key tiles, 5 frames (QT = 225, t_ind 0,
    2, 4), so a clean window's query tile [128, 192) spans frames 2-4
    and takes each key of those frames for its own frame's rows only,
    against the plain version over all 209 halo positions: 1e-6 in fp32,
    at head widths 40 and 64."""
    assert len({q // 45 for q in range(2 * F32_BQ, 3 * F32_BQ)}) == 3
    args, nh = _halo_inputs(np.random.default_rng(8), occ, pad_first, t=5, ch=ch)
    out, ref = _halo_model(args, nh, F32_BQ, F32_BK)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-6, rtol=1e-6)
