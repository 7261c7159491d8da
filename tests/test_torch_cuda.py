"""The port's CUDA kernels vs their plain versions, on the card.

Marked `cuda`; each test skips without a card. The file imports neither
jax nor the JAX package, so it also runs where jax is absent:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: the corr lookups are bit-equal (the same products and sums,
each rounded, then one rounding to the maps' type); fp32 (TF32 off) 1e-4
for sums over hundreds of terms; bf16 3e-2 (the plain versions compute
in fp32 and round once; the kernels round the output too, and B2 its
samples, so a bf16 ulp or two of the result can separate them)."""

import numpy as np
import pytest
import torch

from comfyui_propainter_nodes_tpu_torch.models.raft import build_corr_pyramids
from comfyui_propainter_nodes_tpu_torch.ops.cuda import corr_lookup as b1
from comfyui_propainter_nodes_tpu_torch.ops.cuda import corr_window as b67
from comfyui_propainter_nodes_tpu_torch.ops.cuda import deform_conv as b2
from comfyui_propainter_nodes_tpu_torch.ops.cuda import window_attention as b3
from comfyui_propainter_nodes_tpu_torch.ops.cuda import window_attention_halo as b5

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no host build")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_corr_lookup_matches_plain(gen, dt):
    """Odd map height, coords partly and wholly outside the maps."""
    f1 = torch.randn(3, 17, 24, 32, generator=gen, device="cuda").to(dt)
    f2 = torch.randn(3, 17, 24, 32, generator=gen, device="cuda").to(dt)
    pyr, _ = build_corr_pyramids(f1, f2)
    yy, xx = torch.meshgrid(
        torch.arange(17.0, device="cuda"), torch.arange(24.0, device="cuda"), indexing="ij"
    )
    coords = torch.stack([xx, yy], -1)[None] + 8.0 * torch.randn(3, 17, 24, 2, generator=gen, device="cuda")
    coords[0, :4] = -50.0
    coords = coords.contiguous()
    before = b1.launches
    out = b1.corr_lookup(pyr, coords)
    assert b1.launches == before + 1
    assert out.dtype == dt
    assert torch.equal(out, b1.corr_lookup_plain(pyr, coords))  # fp32 bit for bit; bf16 = the fp32 result rounded
    assert torch.count_nonzero(out[0, :4]) == 0


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 3])
def test_corr_lookup_two_directions(gen, dt, n):
    """Both RAFT directions in one launch, as models/raft.py calls it: odd
    17x23 maps (levels 17x23, 8x11, 4x5, 2x2; 391 pixels an image, so the
    direction boundary falls inside a 24-pixel block and the last block
    is ragged), coords partly and wholly outside in both directions.
    Equal to the plain version bit for bit in fp32 and to its fp32 result
    rounded in bf16; one launch a call."""
    f1 = torch.randn(n, 17, 23, 32, generator=gen, device="cuda").to(dt)
    f2 = torch.randn(n, 17, 23, 32, generator=gen, device="cuda").to(dt)
    fwd, bwd = build_corr_pyramids(f1, f2)
    yy, xx = torch.meshgrid(
        torch.arange(17.0, device="cuda"), torch.arange(23.0, device="cuda"), indexing="ij"
    )
    coords = torch.stack([xx, yy], -1)[None] + 8.0 * torch.randn(2 * n, 17, 23, 2, generator=gen, device="cuda")
    coords[0, :3] = -50.0
    coords[n, 5:7] = 90.0
    coords = coords.contiguous()
    before = b1.launches
    out = b1.corr_lookup(fwd, coords, bwd)
    assert b1.launches == before + 1
    assert out.dtype == dt and out.shape == (2 * n, 17, 23, 324)
    ref = torch.cat([b1.corr_lookup_plain(fwd, coords[:n].contiguous()), b1.corr_lookup_plain(bwd, coords[n:].contiguous())])
    assert torch.equal(out, ref)
    assert torch.equal(out, b1.corr_lookup_plain(fwd, coords, bwd))
    assert torch.count_nonzero(out[0, :3]) == 0 and torch.count_nonzero(out[n, 5:7]) == 0
    if dt == torch.bfloat16:
        f32 = b1.corr_lookup_plain([m.float() for m in fwd], coords, [m.float() for m in bwd])
        assert torch.equal(out, f32.to(torch.bfloat16))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 3])
def test_corr_lookup_map_blend(gen, dt, n):
    """B1 with the map-dtype blend (`corr_lookup_map_kernel` for bf16 maps,
    the fp32 kernel for fp32 maps), both directions, the 17x23 maps and
    coords of test_corr_lookup_two_directions: bit-equal to the map-dtype
    plain lookup; one launch a call, on the variant's own counter in bf16."""
    f1 = torch.randn(n, 17, 23, 32, generator=gen, device="cuda").to(dt)
    f2 = torch.randn(n, 17, 23, 32, generator=gen, device="cuda").to(dt)
    fwd, bwd = build_corr_pyramids(f1, f2)
    yy, xx = torch.meshgrid(
        torch.arange(17.0, device="cuda"), torch.arange(23.0, device="cuda"), indexing="ij"
    )
    coords = torch.stack([xx, yy], -1)[None] + 8.0 * torch.randn(2 * n, 17, 23, 2, generator=gen, device="cuda")
    coords[0, :3] = -50.0
    coords[n, 5:7] = 90.0
    coords = coords.contiguous()
    before = (b1.launches, b1.launches_map)
    out = b1.corr_lookup(fwd, coords, bwd, blend="map")
    after = (b1.launches, b1.launches_map)
    assert after == ((before[0], before[1] + 1) if dt == torch.bfloat16 else (before[0] + 1, before[1]))
    assert out.dtype == dt and out.shape == (2 * n, 17, 23, 324)
    assert torch.equal(out, b1.corr_lookup_plain(fwd, coords, bwd, blend="map"))
    assert torch.count_nonzero(out[0, :3]) == 0 and torch.count_nonzero(out[n, 5:7]) == 0
    lanes = b1.corr_lookup(fwd, coords, bwd)
    assert torch.equal(out, lanes) == (dt == torch.float32)  # the blends differ in bf16 only


@pytest.mark.parametrize("dt,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("cin,g", [(64, 16), (48, 4), (128, 16), (256, 16)])
def test_deform_conv_matches_plain(gen, dt, tol, cin, g):
    """cg 4 and 12 (ragged: bf16 gathers channel by channel) and the call
    sites' cg 8 and 16 (bf16: 16-byte corner vectors); Cin not a multiple
    of the 32- or 64-channel chunk, Cout 40 not of the 128-channel tile,
    M = 2 * 13 * 21 = 546 not of any pixel tile, N = 2."""
    x = torch.randn(2, 13, 21, cin, generator=gen, device="cuda").to(dt)
    off = (torch.randn(2, 13, 21, g, 9, 2, generator=gen, device="cuda") * 4).to(dt)
    mask = torch.rand(2, 13, 21, g, 9, generator=gen, device="cuda").to(dt)
    w = (torch.randn(40, cin, 3, 3, generator=gen, device="cuda") * 0.05).to(dt)
    bias = torch.randn(40, generator=gen, device="cuda").to(dt)
    before = b2.launches
    out = b2.deform_conv2d(x, off, mask, w, bias)
    assert b2.launches == before + 1
    torch.testing.assert_close(out, b2.deform_conv2d_plain(x, off, mask, w, bias), atol=tol, rtol=tol)


@pytest.mark.parametrize("rows", [32, 64])
@pytest.mark.parametrize("cin,g,cout", [(128, 16, 128), (256, 16, 136), (48, 4, 40)])
@pytest.mark.parametrize("aligned", [True, False])
def test_deform_conv_bf16_tiles(gen, monkeypatch, rows, cin, g, cout, aligned):
    """The tensor-core kernel at both pixel tiles, Cout over two 128-channel
    blocks (136), x off a 16-byte boundary (corners then gathered channel
    by channel), no bias; within 3e-2 of the plain version, and the weight
    layout made once per weight tensor."""
    monkeypatch.setattr(b2, "block_rows", lambda m, c, d: rows)
    dt = torch.bfloat16
    x = torch.randn(3, 11, 17, cin, generator=gen, device="cuda").to(dt)
    if not aligned:
        x = torch.empty(x.numel() + 1, device="cuda", dtype=dt)[1:].view(x.shape).copy_(x)
    off = (torch.randn(3, 11, 17, g, 9, 2, generator=gen, device="cuda") * 6).to(dt)
    mask = torch.rand(3, 11, 17, g, 9, generator=gen, device="cuda").to(dt)
    w = (torch.randn(cout, cin, 3, 3, generator=gen, device="cuda") * 0.05).to(dt)
    out = b2.deform_conv2d(x, off, mask, w)
    layout = b2._cached_layout(w, dt)
    torch.testing.assert_close(out, b2.deform_conv2d_plain(x, off, mask, w), atol=3e-2, rtol=3e-2)
    torch.testing.assert_close(b2.deform_conv2d(x, off, mask, w), out, atol=0, rtol=0)
    assert b2._cached_layout(w, dt) is layout


@pytest.mark.parametrize("dt,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("row0,ho", [(0, 7), (5, 8), (12, 7)])
def test_deform_conv_row_origin(gen, dt, tol, row0, ho):
    """Output rows [row0, row0 + ho) of x's 19 (the spatial H split's
    slab form): within tol of the plain version at the same origin, and
    each output row bit for bit the whole image's at its row."""
    x = torch.randn(2, 19, 21, 128, generator=gen, device="cuda").to(dt)
    off = (torch.randn(2, 19, 21, 16, 9, 2, generator=gen, device="cuda") * 4).to(dt)
    mask = torch.rand(2, 19, 21, 16, 9, generator=gen, device="cuda").to(dt)
    w = (torch.randn(128, 128, 3, 3, generator=gen, device="cuda") * 0.05).to(dt)
    bias = torch.randn(128, generator=gen, device="cuda").to(dt)
    rows = slice(row0, row0 + ho)
    o, m = off[:, rows].contiguous(), mask[:, rows].contiguous()
    before = b2.launches
    out = b2.deform_conv2d(x, o, m, w, bias, row0=row0)
    assert b2.launches == before + 1 and out.shape == (2, ho, 21, 128)
    torch.testing.assert_close(out, b2.deform_conv2d_plain(x, o, m, w, bias, row0=row0), atol=tol, rtol=tol)
    assert torch.equal(out, b2.deform_conv2d(x, off, mask, w, bias)[:, rows])
    with pytest.raises(ValueError, match="within"):
        b2.deform_conv2d(x, o, m, w, bias, row0=19 - ho + 1)


def _attention_args(gen, dt, b, nwb, nh, t, wsz, ch, rl_per, pl_per, occ, pad_first=False):
    """Per-batch-row biases: t_ind = every other frame, the last frame of
    row 1 padded (with pad_first, its first frame, a t_ind frame, too)."""
    nw = b * nwb
    in_tind = torch.arange(t, device="cuda") % 2 == 0
    t_sel = int(in_tind.sum())

    def r(*s):
        return torch.randn(*s, generator=gen, device="cuda").to(dt)

    args = [r(nw, nh, t, wsz, ch), r(nw, nh, t, wsz, ch), r(nw, nh, t, wsz, ch),
            r(nw, nh, t_sel * rl_per, ch), r(nw, nh, t_sel * rl_per, ch),
            r(b, nh, t_sel * pl_per, ch), r(b, nh, t_sel * pl_per, ch)]
    tv = torch.ones(b, t, dtype=torch.bool, device="cuda")
    tv[1:, -1] = False
    if pad_first:
        tv[1:, 0] = False
    bias_w = torch.where(in_tind[None] & tv, 0.0, -1e9).repeat_interleave(wsz, 1).float()
    sel = tv[:, in_tind]
    bias_r = torch.where(sel, 0.0, -1e9).repeat_interleave(rl_per, 1).float()
    bias_p = torch.where(sel, 0.0, -1e9).repeat_interleave(pl_per, 1).float()
    return args + [torch.tensor(occ, device="cuda"), bias_w, bias_r, bias_p]


_OCC = {"mixed": [True, False, True, False, False, True], "clean": [False] * 6, "occupied": [True] * 6}


@pytest.mark.parametrize("dt,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("ch", [64, 128])
@pytest.mark.parametrize("occ", list(_OCC))
def test_window_attention_matches_plain(gen, dt, tol, ch, occ):
    """B3 on both loops (bf16: tensor cores, fp32: CUDA cores), mixed / no
    / all occupied windows, per-batch-row biases: QT = 5 * 45 = 225, not a
    multiple of the 64-query tile, so clean tiles span three frames;
    ragged segments of 148 and 91 keys a frame, so 64-key tiles straddle
    segment ends; batch row 1's first t_ind frame padded."""
    full = _attention_args(gen, dt, 2, 3, 2, 5, 45, ch, 148, 91, _OCC[occ], pad_first=True)
    before = b3.launches
    out = b3.window_attention(*full, n_win_per_b=3)
    assert b3.launches == before + 1
    torch.testing.assert_close(out, b3.window_attention_plain(*full, 3), atol=tol, rtol=tol)


def test_attention_bf16_needs_head_width_multiple_of_16(gen):
    """The tensor-core loop takes ch = 16k only; other widths raise for bf16
    (fp32 takes them, on the CUDA cores)."""
    full = _attention_args(gen, torch.bfloat16, 1, 2, 2, 2, 45, 40, 148, 91, [True, False])
    with pytest.raises(ValueError, match="multiple of 16"):
        b3.window_attention(*full, n_win_per_b=2)
    g = torch.zeros((1, 2, 5, 9, 80), device="cuda", dtype=torch.bfloat16)
    h = torch.zeros((1, 1, 11, 19, 80), device="cuda", dtype=torch.bfloat16)
    p = torch.zeros((1, 2, 3, 40), device="cuda", dtype=torch.bfloat16)
    occ = torch.ones((1, 1, 1), dtype=torch.bool, device="cuda")
    with pytest.raises(ValueError, match="multiple of 16"):
        b5.window_attention_halo(g, g, g, h, h, p, p, occ, torch.zeros(1, 90, device="cuda"),
                                 torch.zeros(1, 1, device="cuda"), torch.zeros(1, 3, device="cuda"),
                                 window_size=(5, 9), n_head=2)
    full32 = _attention_args(gen, torch.float32, 1, 2, 2, 2, 45, 40, 148, 91, [True, False])
    torch.testing.assert_close(b3.window_attention(*full32, n_win_per_b=2), b3.window_attention_plain(*full32, 2),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dt,tol,split", [(torch.float32, 1e-4, 64), (torch.float32, 1e-4, "default"),
                                          (torch.bfloat16, 3e-2, "one")])
@pytest.mark.parametrize("ch", [64, 128])
@pytest.mark.parametrize("occ", list(_OCC))
@pytest.mark.parametrize("rl_per", [37, 148])
def test_window_attention_tiled_matches_plain(gen, monkeypatch, dt, tol, split, ch, occ, rl_per):
    """B4 on both loops (bf16: tensor cores, one split a window; fp32: CUDA
    cores, splits of 64 keys or the module's own SPLIT_KEYS), mixed / no /
    all occupied windows, head widths 64 and 128, and the single-pass
    kernel on the same inputs. rl_per 37: the rolled segment (111 keys)
    pads to one SEG_TILE, so 64-key splits of padding keys only occur, and
    batch row 1's first 64-key split is all -1e9 (its frame 0 padded,
    frame 1 outside t_ind); rl_per 148: it spans two SEG_TILEs (444 keys
    padded to 512). QT = 225 is not a multiple of either query tile."""
    if split == 64:
        monkeypatch.setattr(b3, "SPLIT_KEYS", 64)
    full = _attention_args(gen, dt, 2, 3, 2, 5, 45, ch, rl_per, 405, _OCC[occ], pad_first=True)
    n_keys = 225 + b3._padded(3 * rl_per) + 3 * 405 + 65
    keys = {64: 64, "default": b3.SPLIT_KEYS, "one": n_keys}[split]
    assert b3.split_plan(n_keys, dt) == (-(-n_keys // keys), keys)
    before = b3.launches_tiled
    out = b3.window_attention_tiled(*full, n_win_per_b=3)
    assert b3.launches_tiled == before + 1
    torch.testing.assert_close(out, b3.window_attention_tiled_plain(*full, 3), atol=tol, rtol=tol)
    torch.testing.assert_close(out, b3.window_attention(*full, n_win_per_b=3), atol=tol, rtol=tol)


def test_attention_tiled_bf16_checks(gen):
    """B4's bf16 inputs go to the tensor-core loop: a head width that is
    not a multiple of 16, or a tensor off a 16-byte boundary, raises; fp32
    takes both."""
    full = _attention_args(gen, torch.bfloat16, 1, 2, 2, 2, 45, 40, 148, 405, [True, False])
    with pytest.raises(ValueError, match="multiple of 16"):
        b3.window_attention_tiled(*full, n_win_per_b=2)
    full = _attention_args(gen, torch.bfloat16, 1, 2, 2, 2, 45, 64, 148, 405, [True, False])
    q = full[0]
    shifted = torch.empty(q.numel() + 1, device="cuda", dtype=q.dtype)[1:].view(q.shape)
    shifted.copy_(q)
    with pytest.raises(ValueError, match="16-byte"):
        b3.window_attention_tiled(shifted, *full[1:], n_win_per_b=2)
    full32 = _attention_args(gen, torch.float32, 1, 2, 2, 2, 45, 40, 148, 405, [True, False])
    torch.testing.assert_close(b3.window_attention_tiled(*full32, n_win_per_b=2),
                               b3.window_attention_tiled_plain(*full32, 2), atol=1e-4, rtol=1e-4)


def test_window_attention_dispatch(gen):
    """The size estimate routes the 720p-sized pooled segment to B4 and a
    small one to B3."""
    small = _attention_args(gen, torch.bfloat16, 1, 2, 4, 13, 45, 128, 148, 91, [True, False])
    large = _attention_args(gen, torch.bfloat16, 1, 2, 4, 13, 45, 128, 148, 405, [True, False])
    single, tiled = b3.launches, b3.launches_tiled
    b3.window_attention_dispatch(*small, n_win_per_b=2)
    assert (b3.launches, b3.launches_tiled) == (single + 1, tiled)
    b3.window_attention_dispatch(*large, n_win_per_b=2)
    assert (b3.launches, b3.launches_tiled) == (single + 1, tiled + 1)


def _halo_args(gen, dt, ch, occ, pad_first):
    """A window-padded 10x27 grid of 2 batch rows, 5 frames (QT = 225),
    t_ind = frames 0, 2, 4, 2 heads of width ch; occ [2, 2, 3]."""
    b, t, hp, wp, nh = 2, 5, 10, 27, 2
    c = nh * ch
    idx = torch.tensor([0, 2, 4], device="cuda")

    def r(*s):
        return torch.randn(*s, generator=gen, device="cuda").to(dt)

    def cpad(a):
        a = a.index_select(1, idx)
        a = torch.cat([a[:, :, -3:], a, a[:, :, :3]], 2)
        return torch.cat([a[:, :, :, -5:], a, a[:, :, :, :5]], 3).contiguous()

    q, k, v = r(b, t, hp, wp, c), r(b, t, hp, wp, c), r(b, t, hp, wp, c)
    pk, pv = r(b, nh, 3 * 17, ch), r(b, nh, 3 * 17, ch)
    tv = torch.ones(b, t, dtype=torch.bool, device="cuda")
    tv[1, -1] = False
    if pad_first:
        tv[1, 0] = False
    in_tind = torch.zeros(t, dtype=torch.bool, device="cuda")
    in_tind[idx] = True
    bias_w = torch.where(in_tind[None] & tv, 0.0, -1e9).repeat_interleave(45, 1).float()
    bias_hv = torch.where(tv[:, in_tind], 0.0, -1e9).float()
    bias_p = bias_hv.repeat_interleave(17, 1)
    occ = torch.tensor(occ, device="cuda").reshape(2, 2, 3)
    return (q, k, v, cpad(k), cpad(v), pk, pv, occ, bias_w, bias_hv, bias_p), nh


@pytest.mark.parametrize("dt,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("ch", [64, 128])
@pytest.mark.parametrize("occ", list(_OCC) + ["mixed_b"])
def test_window_attention_halo_matches_plain(gen, dt, tol, ch, occ):
    """B5 on both loops on a window-padded 10x27 grid, 2 batch rows, head
    widths 64 and 128, mixed / no / all occupied windows, t_ind = every
    other frame, batch row 1's first and last t_ind frames padded; the
    kernel walks only the 148 survivor halo positions, the plain version
    all 209."""
    pattern = _OCC[occ] * 2 if occ in _OCC else [False, True, False, True, True, False] * 2
    args, nh = _halo_args(gen, dt, ch, pattern, pad_first=True)
    before = b5.launches
    out = b5.window_attention_halo(*args, window_size=(5, 9), n_head=nh)
    assert b5.launches == before + 1
    ref = b5.window_attention_halo_plain(*args, window_size=(5, 9), n_head=nh)
    torch.testing.assert_close(out, ref, atol=tol, rtol=tol)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_corr_window_lookups_match_plain(gen, dt):
    """B7 and B6 on padded maps, starts at and past both edges; fp32 is
    bit-exact (same products and sums, each rounded)."""
    m = 700
    shapes = [(40, 50), (28, 34), (22, 26), (20, 22)]
    maps = [torch.randn(m, hp, wp, generator=gen, device="cuda").to(dt) for hp, wp in shapes]
    sy = torch.stack([torch.randint(-3, hp - 7, (m,), generator=gen, device="cuda") for hp, _ in shapes]).int()
    sx = torch.stack([torch.randint(-3, wp - 7, (m,), generator=gen, device="cuda") for _, wp in shapes]).int()
    fy = torch.rand(4, m, generator=gen, device="cuda").to(dt).float()
    fx = torch.rand(4, m, generator=gen, device="cuda").to(dt).float()
    tol = 0.0 if dt == torch.float32 else 1e-6
    one = b67.corr_window_lookup(maps[0], sy[0], sx[0], fy[0], fx[0])
    torch.testing.assert_close(one, b67.corr_window_lookup_plain(maps[0], sy[0], sx[0], fy[0], fx[0]), atol=tol, rtol=tol)
    four = b67.corr_window_lookup4(maps, sy, sx, fy, fx)
    torch.testing.assert_close(four, b67.corr_window_lookup4_plain(maps, sy, sx, fy, fx), atol=tol, rtol=tol)
    torch.testing.assert_close(four[:, 0], one, atol=0, rtol=0)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 23, 700])
def test_corr_window4_is_bit_equal(gen, dt, m):
    """B6 (24 pixels a block): M below, at an odd remainder of and well
    past one block; levels of unequal sizes; starts clamped at both ends
    (some below 0, some past Hp-10 / Wp-10). Equal bit for bit in both
    map types."""
    shapes = [(40, 50), (28, 34), (22, 26), (20, 22)]
    maps = [torch.randn(m, hp, wp, generator=gen, device="cuda").to(dt) for hp, wp in shapes]
    sy = torch.stack([torch.randint(-5, hp - 5, (m,), generator=gen, device="cuda") for hp, _ in shapes]).int()
    sx = torch.stack([torch.randint(-5, wp - 5, (m,), generator=gen, device="cuda") for _, wp in shapes]).int()
    sy[:, 0], sx[:, -1] = -7, 99
    fy = torch.rand(4, m, generator=gen, device="cuda").to(dt).float()
    fx = torch.rand(4, m, generator=gen, device="cuda").to(dt).float()
    before = b67.launches4
    out = b67.corr_window_lookup4(maps, sy, sx, fy, fx)
    assert b67.launches4 == before + 1
    assert torch.equal(out, b67.corr_window_lookup4_plain(maps, sy, sx, fy, fx))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 33, 701])
def test_corr_window_is_bit_equal(gen, dt, m):
    """B7 (32 pixels a block): M below one block, one pixel into a second
    and a ragged 22nd block (701 = 21 * 32 + 29, ending in a short group of
    outputs); starts clamped at both ends and far outside the map. Equal
    bit for bit in both map types."""
    maps = torch.randn(m, 40, 50, generator=gen, device="cuda").to(dt)
    sy = torch.randint(-5, 35, (m,), generator=gen, device="cuda").int()
    sx = torch.randint(-5, 45, (m,), generator=gen, device="cuda").int()
    sy[0], sx[-1] = -7, 99
    if m > 2:
        sy[1], sx[1] = 1 << 30, -(1 << 30)
    fy = torch.rand(m, generator=gen, device="cuda").to(dt).float()
    fx = torch.rand(m, generator=gen, device="cuda").to(dt).float()
    before = b67.launches
    out = b67.corr_window_lookup(maps, sy, sx, fy, fx)
    assert b67.launches == before + 1
    assert torch.equal(out, b67.corr_window_lookup_plain(maps, sy, sx, fy, fx))


def test_wrappers_check_their_inputs(gen):
    x = torch.zeros((1, 8, 8, 32), device="cuda")
    off = torch.zeros((1, 8, 8, 4, 9, 2), device="cuda")
    mask = torch.zeros((1, 8, 8, 4, 9), device="cuda")
    w = torch.zeros((16, 32, 3, 3), device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        b2.deform_conv2d(x, off.transpose(1, 2), mask, w)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        b2.deform_conv2d(x.half(), off.half(), mask.half(), w.half())


# ----------------------------------------------------------- gradients


def _grads(fn, inputs, grad_out):
    """fn(*inputs) and the gradients of <fn, grad_out> for the inputs."""
    leaves = [t.detach().requires_grad_() for t in inputs]
    out = fn(*leaves)
    return out, torch.autograd.grad(out, leaves, grad_out)


def _assert_grads_match(got, want):
    """Each gradient within 1e-4 of the twin's largest entry (fp32, TF32 off)."""
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= 1e-4 * max(w.abs().max().item(), 1e-30)


@pytest.mark.parametrize("shape", [(2, 13, 21, 64, 16, 40), (1, 16, 24, 128, 16, 128)])
def test_deform_conv_gradients_match_the_twin(gen, shape):
    """B2 under grad mode: the kernel's output, with a grad_fn, and the
    gradients of x, offset, mask, weight and bias from the plain version's
    backward (`TwinGrad`), against the plain version's forward and backward."""
    n, h, w, cin, g, cout = shape
    x = torch.randn(n, h, w, cin, generator=gen, device="cuda")
    off = torch.randn(n, h, w, g, 9, 2, generator=gen, device="cuda") * 2 + 0.3
    mask = torch.rand(n, h, w, g, 9, generator=gen, device="cuda")
    wt = torch.randn(cout, cin, 3, 3, generator=gen, device="cuda") * 0.05
    bias = torch.randn(cout, generator=gen, device="cuda")
    gout = torch.randn(n, h, w, cout, generator=gen, device="cuda")
    before = b2.launches
    out, got = _grads(b2.deform_conv2d, (x, off, mask, wt, bias), gout)
    assert b2.launches == before + 1 and out.grad_fn is not None
    ref, want = _grads(b2.deform_conv2d_plain, (x, off, mask, wt, bias), gout)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
    _assert_grads_match(got, want)
    with pytest.raises(ValueError, match="fp32"):
        b2.deform_conv2d(x.bfloat16(), off.bfloat16(), mask.bfloat16(), wt.bfloat16().requires_grad_(), bias.bfloat16())


@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("dims", [(2, 3, 2, 5, 64, 148, 91), (1, 4, 4, 8, 128, 148, 45)])
def test_window_attention_gradients_match_the_twin(gen, tiled, dims):
    """B3 and B4 under grad mode: a grad_fn, and the seven q/k/v, rolled and
    pooled gradients against the plain version's; one kernel launch."""
    b, nwb, nh, t, ch, rl, pl = dims
    full = _attention_args(gen, torch.float32, b, nwb, nh, t, 45, ch, rl, pl, ([True, False] * nwb * b)[: b * nwb])
    fn = b3.window_attention_tiled if tiled else b3.window_attention
    plain = b3.window_attention_tiled_plain if tiled else b3.window_attention_plain
    gout = torch.randn(full[0].shape, generator=gen, device="cuda")
    before = (b3.launches, b3.launches_tiled)
    out, got = _grads(lambda *a: fn(*a, *full[7:], n_win_per_b=nwb), full[:7], gout)
    assert (b3.launches, b3.launches_tiled) == (before[0] + (not tiled), before[1] + tiled)
    assert out.grad_fn is not None
    ref, want = _grads(lambda *a: plain(*a, *full[7:], nwb), full[:7], gout)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
    _assert_grads_match(got, want)


@pytest.mark.parametrize("ch,occ", [(64, "mixed"), (128, "occupied")])
def test_window_attention_halo_gradients_match_the_twin(gen, ch, occ):
    args, nh = _halo_args(gen, torch.float32, ch, _OCC[occ] * 2, pad_first=False)
    gout = torch.randn(args[0].shape, generator=gen, device="cuda")
    before = b5.launches
    out, got = _grads(lambda *a: b5.window_attention_halo(*a, *args[7:], window_size=(5, 9), n_head=nh), args[:7], gout)
    assert b5.launches == before + 1 and out.grad_fn is not None
    ref, want = _grads(lambda *a: b5.window_attention_halo_plain(*a, *args[7:], window_size=(5, 9), n_head=nh),
                       args[:7], gout)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
    _assert_grads_match(got, want)


def test_deform_conv_weight_relaid_after_an_optimizer_step(gen):
    """B2 lays its weights out once per tensor (`_cached_layout`); an
    optimizer step writes the weight in place, so the second forward must
    use the new values."""
    x = torch.randn(1, 12, 20, 64, generator=gen, device="cuda")
    off = torch.randn(1, 12, 20, 16, 9, 2, generator=gen, device="cuda") + 0.3
    mask = torch.rand(1, 12, 20, 16, 9, generator=gen, device="cuda")
    wt = (torch.randn(32, 64, 3, 3, generator=gen, device="cuda") * 0.05).requires_grad_()
    bias = torch.zeros(32, device="cuda", requires_grad=True)
    opt = torch.optim.AdamW([wt, bias], lr=1e-2)
    for _ in range(2):
        opt.zero_grad()
        out = b2.deform_conv2d(x, off, mask, wt, bias)
        torch.testing.assert_close(out, b2.deform_conv2d_plain(x, off, mask, wt, bias), atol=1e-4, rtol=1e-4)
        out.square().sum().backward()
        opt.step()
    with torch.no_grad():
        torch.testing.assert_close(b2.deform_conv2d(x, off, mask, wt, bias),
                                   b2.deform_conv2d_plain(x, off, mask, wt, bias), atol=1e-4, rtol=1e-4)


def test_forward_only_kernels_refuse_gradients(gen):
    """B1, B6 and B7 have no backward: under grad mode with an input that
    requires grad they raise; under no_grad they launch."""
    f1 = torch.randn(1, 9, 12, 32, generator=gen, device="cuda")
    fwd, bwd = build_corr_pyramids(f1, f1)
    coords = torch.rand(2, 9, 12, 2, generator=gen, device="cuda") * 8
    leaf = [m.clone().requires_grad_() for m in fwd]
    with pytest.raises(ValueError, match="no backward"):
        b1.corr_lookup(leaf, coords, bwd)
    with torch.no_grad():
        b1.corr_lookup(leaf, coords, bwd)
    maps = [torch.randn(5, 30, 30, generator=gen, device="cuda").requires_grad_() for _ in range(4)]
    s = torch.zeros(4, 5, dtype=torch.int32, device="cuda")
    f = torch.rand(4, 5, generator=gen, device="cuda")
    with pytest.raises(ValueError, match="no backward"):
        b67.corr_window_lookup4(maps, s, s, f, f)
    with pytest.raises(ValueError, match="no backward"):
        b67.corr_window_lookup(maps[0], s[0], s[0], f[0], f[0])
    with torch.inference_mode():
        b67.corr_window_lookup(maps[0], s[0], s[0], f[0], f[0])
