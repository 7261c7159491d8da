"""How the padded-map lookup kernels (csrc/corr_window.cu: B6,
`corr_window4_kernel`, four levels; B7, `corr_window_kernel`, one level)
map their threads onto pixels, levels and taps, modelled in torch on the
CPU.

B7: a block of 256 threads owns 32 pixels: thread tid < 32 loads the
start (clamped) and fractions of pixel tid; the block stages each pixel's
10x10 window, element e = tid + i * 256 being (pixel e // 100, row
e % 100 // 10, column e % 10); then thread tid computes outputs 4g ..
4g + 3 of the block's contiguous [32 * 81] output range for g = tid +
i * 256 (a group may span two pixels; the tail block's last group may be
short), products and sums rounded one by one.

B6:
A block of 256 threads owns 24 pixels: thread tid < 96 loads the start
(clamped) and fractions of (level tid // 24, pixel tid % 24); the block
stages each (pixel, level)'s 10x10 window, element e = tid + i * 256 of
each level being (pixel e // 100, row e % 100 // 10, column e % 10); then
thread tid computes outputs 4g .. 4g + 3 of pixel g // 81 for g = tid +
i * 256, four consecutive of the pixel's 324, with the products and sums
rounded one by one. The model runs all blocks at once and must equal
`corr_window_lookup4_plain` bit for bit. Inputs come from a seeded numpy
generator.
"""

import numpy as np
import pytest
import torch

from comfyui_propainter_nodes_tpu_torch.ops.cuda import corr_window as b6

torch.set_num_threads(1)

PIX, NT, LEVELS, WIN, TAPS = 24, 256, 4, 10, 81  # B6's block
PIX1 = 32  # B7's pixels a block
WELEM = WIN * WIN


def block_model1(maps, sy, sx, fy, fx):
    """corr_window_lookup as B7's blocks compute it; also returns how
    often each window element was loaded and each output written."""
    m, hp, wp = maps.shape
    nb = -(-m // PIX1)
    p0 = torch.arange(nb)[:, None] * PIX1  # [blocks, 1]
    np_ = (m - p0).clamp(max=PIX1)
    tid = torch.arange(NT)[None, :]

    def live(ok):  # the block of each live (block, thread)
        return torch.arange(nb)[:, None].expand(nb, NT)[ok]

    # (1) start (clamped) and fractions of each pixel
    s_y = torch.zeros(nb, PIX1, dtype=torch.long)
    s_x = torch.zeros_like(s_y)
    s_fy, s_fx = torch.zeros(nb, PIX1), torch.zeros(nb, PIX1)
    ok = tid < np_
    blk, pix = live(ok), tid.expand(nb, NT)[ok]
    p = p0[blk, 0] + pix
    s_y[blk, pix] = sy[p].long().clamp(0, hp - WIN)
    s_x[blk, pix] = sx[p].long().clamp(0, wp - WIN)
    s_fy[blk, pix], s_fx[blk, pix] = fy[p].float(), fx[p].float()

    # (2) the windows, in the map's type
    win = torch.zeros(nb, PIX1 * WELEM, dtype=maps.dtype)
    loads = torch.zeros(nb, PIX1 * WELEM, dtype=torch.long)
    flat = maps.reshape(-1)
    for i in range(-(-PIX1 * WELEM // NT)):
        e = tid + i * NT
        ok = e < np_ * WELEM
        blk, e = live(ok), e.expand(nb, NT)[ok]
        pix, r = e // WELEM, e % WELEM
        src = (p0[blk, 0] + pix) * hp * wp + (s_y[blk, pix] + r // WIN) * wp + s_x[blk, pix] + r % WIN
        win[blk, e] = flat[src]
        loads[blk, e] += 1

    # (3) four consecutive outputs of the block's range a thread
    out = torch.full((m * TAPS,), float("nan"))
    writes = torch.zeros(m * TAPS, dtype=torch.long)
    for i in range(-(-PIX1 * TAPS // 4 // NT)):
        j0 = (tid + i * NT) * 4
        for k in range(4):
            j = j0 + k
            ok = j < np_ * TAPS
            blk, j = live(ok), j.expand(nb, NT)[ok]
            pix, t = j // TAPS, j % TAPS
            base = pix * WELEM + (t // 9) * WIN + t % 9
            v00, v01, v10, v11 = (win[blk, base + d].float() for d in (0, 1, WIN, WIN + 1))
            wy, wx = s_fy[blk, pix], s_fx[blk, pix]
            vy0 = v00 * (1.0 - wy) + v10 * wy
            vy1 = v01 * (1.0 - wy) + v11 * wy
            o = p0[blk, 0] * TAPS + j
            out[o] = vy0 * (1.0 - wx) + vy1 * wx
            writes[o] += 1
    used = torch.cat([torch.arange(n * WELEM) + b * PIX1 * WELEM for b, n in enumerate(np_[:, 0].tolist())])
    return out.reshape(m, 9, 9), loads.reshape(-1)[used], writes


def block_model(pyramid, sy, sx, fy, fx):
    """corr_window_lookup4 as the kernel's blocks compute it; also returns
    how often each window element was loaded and each output written."""
    m = sy.shape[1]
    nb = -(-m // PIX)
    p0 = torch.arange(nb)[:, None] * PIX  # [blocks, 1]
    np_ = (m - p0).clamp(max=PIX)
    tid = torch.arange(NT)[None, :]  # [1, threads]

    # (1) starts and fractions of (level, pixel)
    s_y = torch.zeros(nb, LEVELS, PIX, dtype=torch.long)
    s_x = torch.zeros_like(s_y)
    s_fy = torch.zeros(nb, LEVELS, PIX)
    s_fx = torch.zeros_like(s_fy)
    lvl, pix = tid // PIX, tid % PIX
    ok = (tid < LEVELS * PIX) & (pix < np_)
    blk = torch.arange(nb)[:, None].expand(nb, NT)[ok]
    lvl, pix = lvl.expand(nb, NT)[ok], pix.expand(nb, NT)[ok]
    p = p0.expand(nb, NT)[ok] + pix
    hp = torch.tensor([t.shape[1] for t in pyramid])[lvl]
    wp = torch.tensor([t.shape[2] for t in pyramid])[lvl]
    s_y[blk, lvl, pix] = torch.minimum(sy[lvl, p].long().clamp(min=0), hp - WIN)
    s_x[blk, lvl, pix] = torch.minimum(sx[lvl, p].long().clamp(min=0), wp - WIN)
    s_fy[blk, lvl, pix] = fy[lvl, p].float()
    s_fx[blk, lvl, pix] = fx[lvl, p].float()

    # (2) the windows, in the maps' type
    win = torch.zeros(nb, PIX * LEVELS * WELEM, dtype=pyramid[0].dtype)
    loads = torch.zeros(nb, PIX * LEVELS * WELEM, dtype=torch.long)
    for lv, maps in enumerate(pyramid):
        flat = maps.reshape(-1)
        plane = maps.shape[1] * maps.shape[2]
        for i in range(-(-PIX * WELEM // NT)):
            e = tid + i * NT
            ok = e < np_ * WELEM
            blk = torch.arange(nb)[:, None].expand(nb, NT)[ok]
            e = e.expand(nb, NT)[ok]
            pix, r = e // WELEM, e % WELEM
            src = (p0[blk, 0] + pix) * plane + (s_y[blk, lv, pix] + r // WIN) * maps.shape[2] + s_x[blk, lv, pix] + r % WIN
            dst = (pix * LEVELS + lv) * WELEM + r
            win[blk, dst] = flat[src]
            loads[blk, dst] += 1

    # (3) four consecutive outputs a thread
    out = torch.full((m * LEVELS * TAPS,), float("nan"))
    writes = torch.zeros(m * LEVELS * TAPS, dtype=torch.long)
    for i in range(-(-PIX * TAPS // NT)):
        g = tid + i * NT
        ok = g < np_ * TAPS
        blk = torch.arange(nb)[:, None].expand(nb, NT)[ok]
        g = g.expand(nb, NT)[ok]
        pix = g // TAPS
        j0 = (g - pix * TAPS) * 4
        for k in range(4):
            j = j0 + k
            lv, t = j // TAPS, j % TAPS
            base = (pix * LEVELS + lv) * WELEM + (t // 9) * WIN + t % 9
            v00, v01, v10, v11 = (win[blk, base + d].float() for d in (0, 1, WIN, WIN + 1))
            wy, wx = s_fy[blk, lv, pix], s_fx[blk, lv, pix]
            vy0 = v00 * (1.0 - wy) + v10 * wy
            vy1 = v01 * (1.0 - wy) + v11 * wy
            o = (p0[blk, 0] + pix) * LEVELS * TAPS + j
            out[o] = vy0 * (1.0 - wx) + vy1 * wx
            writes[o] += 1
    used = torch.cat([torch.arange(n * LEVELS * WELEM) + b * PIX * LEVELS * WELEM for b, n in enumerate(np_[:, 0].tolist())])
    return out.reshape(m, LEVELS, 9, 9), loads.reshape(-1)[used], writes


def _inputs(rng, m, dtype):
    """Levels of unequal sizes; starts below 0 and past Hp-10 / Wp-10 on
    every level (clamped in the kernel); fractions rounded to the maps'
    type, as the RAFT caller rounds them."""
    shapes = [(40, 50), (28, 34), (22, 26), (20, 22)]
    maps = [torch.from_numpy(rng.standard_normal((m, hp, wp)).astype(np.float32)).to(dtype) for hp, wp in shapes]
    sy = np.stack([rng.integers(-6, hp - 4, m) for hp, _ in shapes]).astype(np.int32)
    sx = np.stack([rng.integers(-6, wp - 4, m) for _, wp in shapes]).astype(np.int32)
    sy[:, 0], sx[:, -1] = -9, 99
    fy, fx = (torch.from_numpy(rng.uniform(0, 1, (4, m)).astype(np.float32)).to(dtype).float() for _ in range(2))
    return maps, torch.from_numpy(sy), torch.from_numpy(sx), fy, fx


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [5, 24, 701])
def test_block_mapping_is_the_plain_lookup(m, dtype):
    """M below one block, exactly one, and 29 blocks with a ragged last
    one (701 = 29 * 24 + 5): every window element is loaded once, every
    output written once, and the result equals the plain version exactly."""
    maps, sy, sx, fy, fx = _inputs(np.random.default_rng(m), m, dtype)
    clamped = (sy < 0) | (sx < 0) | (sy > torch.tensor([30, 18, 12, 10])[:, None]) | (sx > torch.tensor([40, 24, 16, 12])[:, None])
    assert clamped.any()
    out, loads, writes = block_model(maps, sy, sx, fy, fx)
    assert (loads == 1).all() and (writes == 1).all()
    assert torch.equal(out, b6.corr_window_lookup4_plain(maps, sy, sx, fy, fx))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [5, 32, 701])
def test_one_level_block_mapping_is_the_plain_lookup(m, dtype):
    """B7: M below one block, exactly one, and 22 blocks with a ragged
    last one (701 = 21 * 32 + 29, whose 2349 outputs end in a short
    group); starts below 0, past Hp-10 / Wp-10 and far outside (clamped):
    every window element is loaded once, every output written once, and
    the result equals the plain version exactly."""
    maps, sy, sx, fy, fx = _inputs(np.random.default_rng(m + 1), m, dtype)
    maps, sy, sx, fy, fx = maps[0], sy[0].clone(), sx[0].clone(), fy[0], fx[0]
    sy[-1], sx[-1] = -100000, 100000
    assert ((sy < 0) | (sx < 0) | (sy > 30) | (sx > 40)).any()
    assert (PIX1 * TAPS * 4) % 16 == 0  # each block's output is 16-byte aligned
    out, loads, writes = block_model1(maps, sy, sx, fy, fx)
    assert (loads == 1).all() and (writes == 1).all()
    assert torch.equal(out, b6.corr_window_lookup_plain(maps, sy, sx, fy, fx))
