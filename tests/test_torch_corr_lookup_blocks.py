"""How the RAFT corr lookup kernel (B1, csrc/corr_lookup.cu,
`corr_lookup_kernel`) maps its threads onto pixels, levels and outputs,
modelled in torch on the CPU.

One launch serves both RAFT directions: pixels below n_fwd read the
forward pyramid, the rest the backward one at pixel - n_fwd. A block of
256 threads owns 24 pixels: thread tid < 96 computes the map plane,
window start floor(coords / 2^l) - 4 and fractions of (level tid // 24,
pixel tid % 24); the block stages each (pixel, level)'s 10x10 window,
element e = tid + i * 256 of each level being (pixel e // 100, row
e % 100 // 10, column e % 10), with zeros for elements outside the
(unpadded) map; then thread tid computes the V = 16 bytes / element size
consecutive outputs V*g .. V*g + V-1 of the block's contiguous output
range (g = tid + i * 256; a bf16 group may span two pixels), combining
rows first, then columns, each product and sum rounded, and rounds once
to the maps' type. The model runs all blocks at once and must equal the
two-direction plain lookup bit for bit in fp32, and its fp32 result
rounded for bf16 maps. Inputs come from a seeded numpy generator.

With blend="map" the model computes as `corr_lookup_map_kernel` does
for bf16 maps: fractions rounded to bf16, and each fp32 product and sum
rounded to bf16 (`rb`). tests/test_torch_corr_lookup_blend.py holds it
against the map-dtype plain lookup.
"""

import numpy as np
import pytest
import torch

from comfyui_propainter_nodes_tpu_torch.models.raft import build_corr_pyramids
from comfyui_propainter_nodes_tpu_torch.ops.cuda import corr_lookup as b1

torch.set_num_threads(1)

PIX, NT, LEVELS, WIN, TAPS = 24, 256, 4, 10, 81  # the kernel's block
OUT = LEVELS * TAPS
WELEM = WIN * WIN


def _live(nb, mask):
    """(block, value) pairs of the [blocks, threads] grid where mask holds."""
    return torch.arange(nb)[:, None].expand_as(mask)[mask]


def rb(x):
    """x rounded to bf16 and back, as the kernel's `rb`."""
    return x.to(torch.bfloat16).float()


def block_model(fwd, bwd, coords, blend="lanes"):
    """corr_lookup(fwd, coords, bwd, blend) as the kernel's blocks compute
    it; also returns how often each staged window element was loaded and
    each output written."""
    dtype = fwd[0].dtype
    rnd = rb if blend == "map" and dtype == torch.bfloat16 else (lambda x: x)  # fp32 maps: one kernel
    n_fwd = fwd[0].shape[0]
    flat = coords.reshape(-1, 2)
    m = flat.shape[0]
    nb = -(-m // PIX)
    p0 = torch.arange(nb)[:, None] * PIX  # [blocks, 1]
    np_ = (m - p0).clamp(max=PIX)
    tid = torch.arange(NT)[None, :]
    v = 16 // fwd[0].element_size()

    # (1) plane, start and fractions of (level, pixel)
    s_y = torch.zeros(nb, LEVELS, PIX, dtype=torch.long)
    s_x, s_q = torch.zeros_like(s_y), torch.zeros_like(s_y)
    s_bwd = torch.zeros(nb, LEVELS, PIX, dtype=torch.bool)
    s_fy, s_fx = torch.zeros(nb, LEVELS, PIX), torch.zeros(nb, LEVELS, PIX)
    ok = (tid < LEVELS * PIX) & (tid % PIX < np_)
    blk = _live(nb, ok)
    lvl, pix = (tid // PIX).expand(nb, NT)[ok], (tid % PIX).expand(nb, NT)[ok]
    p = p0[blk, 0] + pix
    c = flat[p] / (2.0**lvl)[:, None]
    x0, y0 = torch.floor(c[:, 0]), torch.floor(c[:, 1])
    s_x[blk, lvl, pix] = x0.clamp(-1e6, 1e6).long() - 4
    s_y[blk, lvl, pix] = y0.clamp(-1e6, 1e6).long() - 4
    s_fx[blk, lvl, pix] = rnd(c[:, 0] - x0)
    s_fy[blk, lvl, pix] = rnd(c[:, 1] - y0)
    s_bwd[blk, lvl, pix] = p >= n_fwd
    s_q[blk, lvl, pix] = torch.where(p >= n_fwd, p - n_fwd, p)

    # (2) the windows in the maps' type, zeros outside the map
    win = torch.zeros(nb, PIX * LEVELS * WELEM, dtype=dtype)
    loads = torch.zeros(nb, PIX * LEVELS * WELEM, dtype=torch.long)
    for lv in range(LEVELS):
        hl, wl = fwd[lv].shape[1:]
        assert hl * wl > 0
        maps_f, maps_b = fwd[lv].reshape(-1), bwd[lv].reshape(-1)
        for i in range(-(-PIX * WELEM // NT)):
            e = tid + i * NT
            ok = e < np_ * WELEM
            blk = _live(nb, ok)
            e = e.expand(nb, NT)[ok]
            pix, r = e // WELEM, e % WELEM
            y = s_y[blk, lv, pix] + r // WIN
            x = s_x[blk, lv, pix] + r % WIN
            inside = (y >= 0) & (y < hl) & (x >= 0) & (x < wl)
            src = s_q[blk, lv, pix] * hl * wl + y.clamp(0, hl - 1) * wl + x.clamp(0, wl - 1)
            val = torch.where(s_bwd[blk, lv, pix], maps_b[src], maps_f[src])
            dst = (pix * LEVELS + lv) * WELEM + r
            win[blk, dst] = torch.where(inside, val, torch.zeros((), dtype=dtype))
            loads[blk, dst] += 1

    # (3) V consecutive outputs of the block's range a thread
    out = torch.full((m * OUT,), float("nan"))
    writes = torch.zeros(m * OUT, dtype=torch.long)
    for i in range(-(-PIX * OUT // v // NT)):
        j0 = (tid + i * NT) * v
        for k in range(v):
            j = j0 + k
            ok = j < np_ * OUT
            blk = _live(nb, ok)
            j = j.expand(nb, NT)[ok]
            pix, r = j // OUT, j % OUT
            lv, t = r // TAPS, r % TAPS
            base = (pix * LEVELS + lv) * WELEM + (t % 9) * WIN + t // 9  # (dx, dy) channels
            v00, v01, v10, v11 = (win[blk, base + d].float() for d in (0, 1, WIN, WIN + 1))
            fy, fx = s_fy[blk, lv, pix], s_fx[blk, lv, pix]
            gy, gx = rnd(1 - fy), rnd(1 - fx)
            vy0 = rnd(rnd(v00 * gy) + rnd(v10 * fy))
            vy1 = rnd(rnd(v01 * gy) + rnd(v11 * fy))
            o = p0[blk, 0] * OUT + j
            out[o] = rnd(rnd(vy0 * gx) + rnd(vy1 * fx))
            writes[o] += 1
    used = torch.cat([torch.arange(n * LEVELS * WELEM) + b * PIX * LEVELS * WELEM for b, n in enumerate(np_[:, 0].tolist())])
    return out.reshape(*coords.shape[:3], OUT).to(dtype), loads.reshape(-1)[used], writes


def _inputs(rng, n, h, w, dtype):
    """Features of n image pairs, coords of both directions: some windows
    partly outside, rows of each direction wholly outside."""
    f1, f2 = (torch.from_numpy(rng.standard_normal((n, h, w, 16)).astype(np.float32)).to(dtype) for _ in range(2))
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    coords = np.stack([xx, yy], -1)[None] + rng.standard_normal((2 * n, h, w, 2)).astype(np.float32) * 8.0
    coords[0, :2] = -50.0
    coords[n, 3:5] = 90.0
    fwd, bwd = build_corr_pyramids(f1, f2)
    return fwd, bwd, torch.from_numpy(coords.astype(np.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w", [(2, 17, 24), (1, 17, 23)])
def test_block_mapping_is_the_plain_lookup(n, h, w, dtype):
    """17x24 maps (levels 17x24, 8x12, 4x6, 2x3; the direction boundary at
    a block edge) and 17x23 (391 pixels an image: the boundary inside a
    block, the last block ragged): every window element is loaded once,
    every output written once, and the result equals the plain
    two-direction lookup exactly."""
    fwd, bwd, coords = _inputs(np.random.default_rng(h * w + n), n, h, w, dtype)
    assert all(m.is_contiguous() for m in fwd + bwd)  # as the kernel's wrapper requires, n = 1 included
    assert (PIX * OUT * fwd[0].element_size()) % 16 == 0  # each block's output is 16-byte aligned
    out, loads, writes = block_model(fwd, bwd, coords)
    assert (loads == 1).all() and (writes == 1).all()
    ref = b1.corr_lookup_plain(fwd, coords, bwd)
    assert out.dtype == ref.dtype == dtype
    assert torch.equal(out, ref)
    halves = torch.cat([b1.corr_lookup_plain(fwd, coords[:n].contiguous()), b1.corr_lookup_plain(bwd, coords[n:].contiguous())])
    assert torch.equal(out, halves)
    f32 = b1.corr_lookup_plain([t.float() for t in fwd], coords, [t.float() for t in bwd])
    assert torch.equal(out, f32.to(dtype))
    assert torch.count_nonzero(out[0, :2]) == 0 and torch.count_nonzero(out[n, 3:5]) == 0
