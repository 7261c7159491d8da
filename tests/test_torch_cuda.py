"""The port's CUDA kernels vs their plain versions, on the card.

Marked `cuda`; each test skips without a card. The file imports neither
jax nor the JAX package, so it also runs where jax is absent:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: the corr lookups are bit-equal (the same products and sums,
each rounded, then one rounding to the maps' type); fp32 (TF32 off) 1e-4
for sums over hundreds of terms; bf16 3e-2 (the plain versions compute
in fp32 and round once; the kernels round the output too, and B2 its
samples, so a bf16 ulp or two of the result can separate them)."""

import math

import numpy as np
import pytest
import torch

from comfyui_propainter_nodes_tpu_torch.models import raft as traft
from comfyui_propainter_nodes_tpu_torch.models.raft import build_corr_pyramids
from comfyui_propainter_nodes_tpu_torch.ops import conv
from comfyui_propainter_nodes_tpu_torch.pipeline.stages import full_fp32
from comfyui_propainter_nodes_tpu_torch.ops.cuda import corr_lookup as b1
from comfyui_propainter_nodes_tpu_torch.ops.cuda import corr_pyramid as cpk
from comfyui_propainter_nodes_tpu_torch.ops.cuda import corr_window as b67
from comfyui_propainter_nodes_tpu_torch.ops.cuda import deform_conv as b2
from comfyui_propainter_nodes_tpu_torch.ops.cuda import prop_fill as pf
from comfyui_propainter_nodes_tpu_torch.ops.cuda import window_attention as b3
from comfyui_propainter_nodes_tpu_torch.ops.cuda import window_attention_halo as b5
from comfyui_propainter_nodes_tpu_torch.utils import profiling
from comfyui_propainter_nodes_tpu_torch.utils.params import from_jax_params
from comfyui_propainter_nodes_tpu_torch.utils.weights import random_params

pytestmark = pytest.mark.cuda


def launched(name: str) -> int:
    """The program's launch counter of the kernel `name` (utils/profiling.py::kernel)."""
    return profiling.counters().get(name, 0)


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
    before = launched("corr_lookup")
    out = b1.corr_lookup(pyr, coords)
    assert launched("corr_lookup") == before + 1
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
    before = launched("corr_lookup")
    out = b1.corr_lookup(fwd, coords, bwd)
    assert launched("corr_lookup") == before + 1
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
    before = (launched("corr_lookup"), launched("corr_lookup_map"))
    out = b1.corr_lookup(fwd, coords, bwd, blend="map")
    after = (launched("corr_lookup"), launched("corr_lookup_map"))
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
    before = launched("deform_conv")
    out = b2.deform_conv2d(x, off, mask, w, bias)
    assert launched("deform_conv") == before + 1
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
    layout = conv.laid_weight(b2.weight_layout, (w,), dt)
    torch.testing.assert_close(out, b2.deform_conv2d_plain(x, off, mask, w), atol=3e-2, rtol=3e-2)
    torch.testing.assert_close(b2.deform_conv2d(x, off, mask, w), out, atol=0, rtol=0)
    assert conv.laid_weight(b2.weight_layout, (w,), dt) is layout


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
    before = launched("deform_conv")
    out = b2.deform_conv2d(x, o, m, w, bias, row0=row0)
    assert launched("deform_conv") == before + 1 and out.shape == (2, ho, 21, 128)
    torch.testing.assert_close(out, b2.deform_conv2d_plain(x, o, m, w, bias, row0=row0), atol=tol, rtol=tol)
    assert torch.equal(out, b2.deform_conv2d(x, off, mask, w, bias)[:, rows])
    with pytest.raises(ValueError, match="within"):
        b2.deform_conv2d(x, o, m, w, bias, row0=19 - ho + 1)


@pytest.mark.parametrize("splits", b2.TAP_SPLITS)
@pytest.mark.parametrize("cin,g,cout", [(128, 16, 128), (256, 16, 136), (48, 4, 40), (40, 10, 20), (24, 4, 18)])
@pytest.mark.parametrize("aligned", [True, False])
def test_deform_conv_f32_tiles(gen, monkeypatch, splits, cin, g, cout, aligned):
    """The fp32 CUDA-core kernel at each tap split the wrapper can pick:
    cg 8 and 16, cg 12 and 4 (16-byte corners), cg 6 (channel by channel),
    Cout over two 128-channel blocks (136) and not a multiple of 4 (18),
    Cin not a multiple of the 16-channel chunk, x off a 16-byte boundary
    (corners then channel by channel), M = 561 no multiple of the
    64-pixel tile; within 1e-4 of the plain version, two calls bit-equal,
    the weight layout made once per weight tensor."""
    monkeypatch.setattr(b2, "tap_splits", lambda m, c, d: splits)
    x = torch.randn(3, 11, 17, cin, generator=gen, device="cuda")
    if not aligned:
        x = torch.empty(x.numel() + 1, device="cuda")[1:].view(x.shape).copy_(x)
    off = torch.randn(3, 11, 17, g, 9, 2, generator=gen, device="cuda") * 6
    mask = torch.rand(3, 11, 17, g, 9, generator=gen, device="cuda")
    w = torch.randn(cout, cin, 3, 3, generator=gen, device="cuda") * 0.05
    bias = torch.randn(cout, generator=gen, device="cuda")
    before = launched("deform_conv")
    out = b2.deform_conv2d(x, off, mask, w, bias)
    assert launched("deform_conv") == before + 1
    layout = conv.laid_weight(b2.weight_layout, (w,), torch.float32)
    torch.testing.assert_close(out, b2.deform_conv2d_plain(x, off, mask, w, bias), atol=1e-4, rtol=1e-4)
    assert torch.equal(b2.deform_conv2d(x, off, mask, w, bias), out)
    assert conv.laid_weight(b2.weight_layout, (w,), torch.float32) is layout


@pytest.mark.parametrize("splits", b2.TAP_SPLITS)
def test_deform_conv_f32_row_form(gen, monkeypatch, splits):
    """The fp32 kernel's row form (output rows 5-13 of 19) at each tap
    split: within 1e-4 of the plain version at the same origin, and bit
    for bit the whole image's rows at the same split."""
    monkeypatch.setattr(b2, "tap_splits", lambda m, c, d: splits)
    x = torch.randn(2, 19, 21, 128, generator=gen, device="cuda")
    off = torch.randn(2, 19, 21, 16, 9, 2, generator=gen, device="cuda") * 4
    mask = torch.rand(2, 19, 21, 16, 9, generator=gen, device="cuda")
    w = torch.randn(128, 128, 3, 3, generator=gen, device="cuda") * 0.05
    bias = torch.randn(128, generator=gen, device="cuda")
    o, m = off[:, 5:13].contiguous(), mask[:, 5:13].contiguous()
    out = b2.deform_conv2d(x, o, m, w, bias, row0=5)
    torch.testing.assert_close(out, b2.deform_conv2d_plain(x, o, m, w, bias, row0=5), atol=1e-4, rtol=1e-4)
    assert torch.equal(out, b2.deform_conv2d(x, off, mask, w, bias)[:, 5:13])


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
    before = launched("window_attention")
    out = b3.window_attention(*full, n_win_per_b=3)
    assert launched("window_attention") == before + 1
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
    before = launched("window_attention_tiled")
    out = b3.window_attention_tiled(*full, n_win_per_b=3)
    assert launched("window_attention_tiled") == before + 1
    torch.testing.assert_close(out, b3.window_attention_tiled_plain(*full, 3), atol=tol, rtol=tol)
    torch.testing.assert_close(out, b3.window_attention(*full, n_win_per_b=3), atol=tol, rtol=tol)


@pytest.mark.parametrize("keys", [1024, "one"])
def test_window_attention_tiled_f32_other_splits(gen, monkeypatch, keys):
    """B4's fp32 loop in splits of 1024 keys and in one split a window
    (SPLIT_KEYS raised: what the loop's bring-up timed against 512), 2017 keys a
    window, against its plain version (1e-4)."""
    monkeypatch.setattr(b3, "SPLIT_KEYS", 1024 if keys == 1024 else 1 << 30)
    full = _attention_args(gen, torch.float32, 2, 3, 2, 5, 45, 128, 148, 405, _OCC["mixed"], pad_first=True)
    n_keys = 225 + b3._padded(3 * 148) + 3 * 405 + 65
    assert b3.split_plan(n_keys, torch.float32)[0] == (2 if keys == 1024 else 1)
    out = b3.window_attention_tiled(*full, n_win_per_b=3)
    torch.testing.assert_close(out, b3.window_attention_tiled_plain(*full, 3), atol=1e-4, rtol=1e-4)


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
    single, tiled = launched("window_attention"), launched("window_attention_tiled")
    b3.window_attention_dispatch(*small, n_win_per_b=2)
    assert (launched("window_attention"), launched("window_attention_tiled")) == (single + 1, tiled)
    b3.window_attention_dispatch(*large, n_win_per_b=2)
    assert (launched("window_attention"), launched("window_attention_tiled")) == (single + 1, tiled + 1)


def _shifted(t):
    """A copy of t that starts 4 bytes past a 16-byte boundary."""
    out = torch.empty(t.numel() + 1, device=t.device, dtype=t.dtype)[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("kernel,split", [("single", None), ("tiled", 64), ("tiled", "default")])
@pytest.mark.parametrize("ch", [40, 64, 128])
@pytest.mark.parametrize("occ", list(_OCC))
def test_window_attention_f32_loop(gen, monkeypatch, kernel, split, ch, occ):
    """B3 and B4 in fp32 on the CUDA-core loop (csrc/flash_f32.cuh: 64-query
    tiles, 32-key tiles): QT = 225 is ragged for both tiles; 148 rolled and
    91 pooled keys a frame (B3) or 405 pooled (B4), so key tiles straddle
    every segment end; batch row 1's first t_ind frame padded; B4 in
    splits of 64 keys (splits of padding keys only) or SPLIT_KEYS; 1e-4."""
    if split == 64:
        monkeypatch.setattr(b3, "SPLIT_KEYS", 64)
    pl_per = 405 if kernel == "tiled" else 91
    full = _attention_args(gen, torch.float32, 2, 3, 2, 5, 45, ch, 148, pl_per, _OCC[occ], pad_first=True)
    fn, plain = ((b3.window_attention_tiled, b3.window_attention_tiled_plain) if kernel == "tiled"
                 else (b3.window_attention, b3.window_attention_plain))
    before = launched("window_attention") + launched("window_attention_tiled")
    out = fn(*full, n_win_per_b=3)
    assert launched("window_attention") + launched("window_attention_tiled") == before + 1
    torch.testing.assert_close(out, plain(*full, 3), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("kernel", ["single", "tiled"])
@pytest.mark.parametrize("ch,shift", [(40, True), (128, True), (30, False), (36, False)])
def test_window_attention_f32_unaligned(gen, kernel, ch, shift):
    """fp32 takes what the 16-byte copies cannot: a tensor off a 16-byte
    boundary (q or pooled V shifted by 4 bytes), or a head width that is
    not a multiple of 4 (30), go through the 4-byte copies; 36 is a
    multiple of 4 whose row pitch differs from 8k + 4. All within 1e-4."""
    full = _attention_args(gen, torch.float32, 2, 3, 2, 5, 45, ch, 148, 91, _OCC["mixed"], pad_first=True)
    if shift:
        full[0], full[6] = _shifted(full[0]), _shifted(full[6])
        assert full[0].data_ptr() % 16 and full[6].data_ptr() % 16
    fn, plain = ((b3.window_attention_tiled, b3.window_attention_tiled_plain) if kernel == "tiled"
                 else (b3.window_attention, b3.window_attention_plain))
    torch.testing.assert_close(fn(*full, n_win_per_b=3), plain(*full, 3), atol=1e-4, rtol=1e-4)


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
    before = launched("window_attention_halo")
    out = b5.window_attention_halo(*args, window_size=(5, 9), n_head=nh)
    assert launched("window_attention_halo") == before + 1
    ref = b5.window_attention_halo_plain(*args, window_size=(5, 9), n_head=nh)
    torch.testing.assert_close(out, ref, atol=tol, rtol=tol)


@pytest.mark.parametrize("ch", [40, 64, 128])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("occ", ["mixed", "clean"])
def test_window_attention_halo_f32_loop(gen, ch, aligned, occ):
    """B5's fp32 inputs on the fp32 loop (csrc/flash_f32.cuh) at head
    widths 40, 64 and 128, its tensors 16-byte aligned (16-byte copies)
    or q and the pooled keys 4 bytes past (4-byte copies); with clean
    windows, whose 64-query tiles span three frames (QT = 225): within
    1e-4 of the plain version."""
    args, nh = _halo_args(gen, torch.float32, ch, _OCC[occ] * 2, pad_first=True)
    if not aligned:
        args = (_shifted(args[0]),) + args[1:5] + (_shifted(args[5]),) + args[6:]
        assert args[0].data_ptr() % 16 and args[5].data_ptr() % 16
    before = launched("window_attention_halo")
    out = b5.window_attention_halo(*args, window_size=(5, 9), n_head=nh)
    assert launched("window_attention_halo") == before + 1
    ref = b5.window_attention_halo_plain(*args, window_size=(5, 9), n_head=nh)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)


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
    before = launched("corr_window4")
    out = b67.corr_window_lookup4(maps, sy, sx, fy, fx)
    assert launched("corr_window4") == before + 1
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
    before = launched("corr_window")
    out = b67.corr_window_lookup(maps, sy, sx, fy, fx)
    assert launched("corr_window") == before + 1
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
    before = launched("deform_conv")
    out, got = _grads(b2.deform_conv2d, (x, off, mask, wt, bias), gout)
    assert launched("deform_conv") == before + 1 and out.grad_fn is not None
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
    before = (launched("window_attention"), launched("window_attention_tiled"))
    out, got = _grads(lambda *a: fn(*a, *full[7:], n_win_per_b=nwb), full[:7], gout)
    after = (launched("window_attention"), launched("window_attention_tiled"))
    assert after == (before[0] + (not tiled), before[1] + tiled)
    assert out.grad_fn is not None
    ref, want = _grads(lambda *a: plain(*a, *full[7:], nwb), full[:7], gout)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
    _assert_grads_match(got, want)


@pytest.mark.parametrize("ch,occ", [(64, "mixed"), (128, "occupied")])
def test_window_attention_halo_gradients_match_the_twin(gen, ch, occ):
    args, nh = _halo_args(gen, torch.float32, ch, _OCC[occ] * 2, pad_first=False)
    gout = torch.randn(args[0].shape, generator=gen, device="cuda")
    before = launched("window_attention_halo")
    out, got = _grads(lambda *a: b5.window_attention_halo(*a, *args[7:], window_size=(5, 9), n_head=nh), args[:7], gout)
    assert launched("window_attention_halo") == before + 1 and out.grad_fn is not None
    ref, want = _grads(lambda *a: b5.window_attention_halo_plain(*a, *args[7:], window_size=(5, 9), n_head=nh),
                       args[:7], gout)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
    _assert_grads_match(got, want)


def test_deform_conv_weight_relaid_after_an_optimizer_step(gen):
    """B2 lays its weights out once per tensor (`ops/conv.py::laid_weight`); an
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


def _raft_params(dt=torch.float32):
    return {k: v.to("cuda", dt) for k, v in from_jax_params(random_params("raft", seed=3)).items()}


def _update_inputs(gen, rows=46, h8=45, w8=80):
    """net, inp, corr, flow of RAFT's update block: the main path's one call
    (23 pairs, both directions) at 640x360 by default."""
    net = torch.tanh(torch.randn(rows, h8, w8, 128, generator=gen, device="cuda"))
    inp = torch.relu(torch.randn(rows, h8, w8, 128, generator=gen, device="cuda"))
    corr = torch.randn(rows, h8, w8, 324, generator=gen, device="cuda")
    flow = torch.randn(rows, h8, w8, 2, generator=gen, device="cuda") * 4
    return net, inp, corr, flow


def test_update_block_gemm_convs_match_cudnn(gen, monkeypatch):
    """The update block and the mask head with GEMM_SITES on `conv2d_gemm`
    (cuBLAS) against every conv on cuDNN (GEMM_SITES emptied), fp32 with
    TF32 off, at the main path's shape: 46 rows of 45x80. Both compute
    each conv in fp32 in another order (cuDNN's heuristic takes FFT
    algorithms for convc2, convf2 and conv). 7 GEMM sites an iteration
    and mask.2."""
    params = _raft_params()
    args = _update_inputs(gen)
    with torch.no_grad():
        before = launched("conv_gemm")
        net, delta = traft._update_block(params, *args)
        mask = traft._upsample_mask(params, net)
        assert launched("conv_gemm") == before + 8
        monkeypatch.setattr(conv, "GEMM_SITES", frozenset())
        net_ref, delta_ref = traft._update_block(params, *args)
        mask_ref = traft._upsample_mask(params, net_ref)
        assert launched("conv_gemm") == before + 8
    for got, want in ((net, net_ref), (delta, delta_ref), (mask, mask_ref)):
        print(f"max abs err {float((got - want).abs().max()):.3e} of {float(want.abs().max()):.3e}")
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_conv_gemm_counts_per_raft_call(gen, dt):
    """`conv_gemm` counts, in every fp32 RAFT call (both forms), the 14
    GEMM sites of fnet and cnet (7 each), 7 convs an iteration and the
    mask head's mask.2; none in bf16."""
    params = _raft_params(dt)
    frames = torch.rand(1, 3, 64, 96, 3, generator=gen, device="cuda") * 2 - 1
    iters = 2
    per_call = (14 + 7 * iters + 1) if dt == torch.float32 else 0
    with torch.no_grad(), full_fp32():
        before = launched("conv_gemm")
        traft.raft_bi_forward(params, frames, iters)
        assert launched("conv_gemm") == before + per_call
        traft.raft_bi_forward_seqdir(params, frames, iters)
        assert launched("conv_gemm") == before + 3 * per_call


def test_gemm_convs_are_tf32_free_under_full_fp32(gen):
    """With TF32 allowed for the process, the update block on GEMMs inside
    `full_fp32()` equals the same block with TF32 off everywhere, bit for
    bit, and the flags are restored after it; outside the scope cuBLAS
    takes TF32 and the result moves."""
    params = _raft_params()
    args = _update_inputs(gen, rows=4, h8=24, w8=40)
    with torch.no_grad():
        want = traft._update_block(params, *args)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        try:
            with full_fp32():
                got = traft._update_block(params, *args)
            assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
            loose = traft._update_block(params, *args)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert not torch.equal(loose[0], want[0])


# each GEMM site (ops/conv.py::GEMM_SITES) at the float32 inpaint clip's
# shapes (640x360, 24 frames; `chip_smoke.py --conv-gemm`): x [N, H, W, Cin],
# the weight's shape [Cout, Cin/groups, kh, kw], padding
CELL_SITES = {
    **{f"{net}.{c}": ((24, 90, 160, 96), (96, 96, 3, 3), (1, 1))
       for net in ("fnet", "cnet") for c in ("layer2.0.conv2", "layer2.1.conv1", "layer2.1.conv2")},
    **{f"{net}.{c}": ((24, 45, 80, 128), (128, 128, 3, 3), (1, 1))
       for net in ("fnet", "cnet") for c in ("layer3.0.conv2", "layer3.1.conv1", "layer3.1.conv2")},
    **{f"{net}.conv2": ((24, 45, 80, 128), (256, 128, 1, 1), (0, 0)) for net in ("fnet", "cnet")},
    "update_block.encoder.convc1": ((46, 45, 80, 324), (256, 324, 1, 1), (0, 0)),
    "update_block.encoder.convc2": ((46, 45, 80, 256), (192, 256, 3, 3), (1, 1)),
    "update_block.encoder.convf2": ((46, 45, 80, 128), (64, 128, 3, 3), (1, 1)),
    "update_block.encoder.conv": ((46, 45, 80, 256), (126, 256, 3, 3), (1, 1)),
    "update_block.gru.convz2": ((46, 45, 80, 384), (128, 384, 5, 1), (2, 0)),
    "update_block.gru.convr2": ((46, 45, 80, 384), (128, 384, 5, 1), (2, 0)),
    "update_block.gru.convq2": ((46, 45, 80, 384), (128, 384, 5, 1), (2, 0)),
    "update_block.flow_head.conv2": ((46, 45, 80, 256), (2, 256, 3, 3), (1, 1)),
    "update_block.mask.2": ((46, 45, 80, 256), (576, 256, 1, 1), (0, 0)),
    "encoder.layers.12": ((24, 90, 160, 768), (384, 192, 3, 3), (1, 1)),
    "encoder.layers.16": ((24, 90, 160, 512), (128, 512, 3, 3), (1, 1)),
    "mid_dilation.4": ((46, 45, 80, 128), (128, 128, 3, 3), (1, 1)),
    "feat_prop_module.fusion": ((46, 45, 80, 256), (128, 256, 1, 1), (0, 0)),
    "decoder2.0": ((46, 45, 80, 128), (128, 128, 3, 3), (1, 1)),
    "feat_prop_module.fuse.0": ((55, 90, 160, 258), (128, 258, 3, 3), (1, 1)),
    "feat_prop_module.fuse.2": ((55, 90, 160, 128), (128, 128, 3, 3), (1, 1)),
    "sc.bias_conv": ((65, 90, 160, 128), (128, 128, 3, 3), (1, 1)),
    "decoder.0.conv": ((55, 78, 112, 128), (128, 128, 3, 3), (1, 1)),
    "decoder.2": ((55, 78, 112, 128), (64, 128, 3, 3), (1, 1)),
    "decoder.6": ((55, 156, 224, 64), (3, 64, 3, 3), (1, 1)),
}


def test_cell_sites_are_the_gemm_sites():
    """CELL_SITES lists every site of GEMM_SITES, and no other."""
    assert set(CELL_SITES) == conv.GEMM_SITES


@pytest.mark.parametrize("site", sorted(CELL_SITES))
def test_gemm_sites_match_cudnn_at_cell_shapes(gen, site):
    """Each GEMM site at the float32 inpaint clip's shapes, through
    `conv2d` (the rule takes `conv2d_gemm`, one `conv_gemm` launch) against
    cuDNN (`conv2d` without a site), fp32 with TF32 off, on unit-scale
    inputs and weights (outputs up to about 9). Largest abs error measured
    on the card by this test: 1.38e-5, the 5x1 GRU convs (1,920 terms a
    sum; in `chip_smoke.py --conv-gemm` cuDNN itself is 9.9e-6 from
    float64 there); 4.1e-6 at fuse.0 (2,322 terms), 2.9e-6-3.8e-6 at the
    other 3x3 sites, 0 at the 1x1 sites. The tolerance, 5e-5 + 1e-5 of
    the value, is over three times the largest: two fp32 summation orders
    of the same terms."""
    xs, ws, pad = CELL_SITES[site]
    groups = xs[3] // ws[1]
    x = torch.randn(xs, generator=gen, device="cuda")
    w = torch.randn(ws, generator=gen, device="cuda") / (ws[1] * ws[2] * ws[3]) ** 0.5
    b = torch.randn(ws[0], generator=gen, device="cuda")
    with torch.no_grad():
        before = launched("conv_gemm")
        got = conv.conv2d(x, w, b, padding=pad, groups=groups, site=site)
        assert launched("conv_gemm") == before + 1
        want = conv.conv2d(x, w, b, padding=pad, groups=groups)
        assert launched("conv_gemm") == before + 1
    print(f"{site}: max abs err {float((got - want).abs().max()):.3e} of {float(want.abs().max()):.3e}")
    torch.testing.assert_close(got, want, atol=5e-5, rtol=1e-5)


@pytest.mark.parametrize("groups,cin,cout", [(2, 640, 512), (4, 768, 384), (8, 640, 256)])
def test_grouped_conv2d_gemm_matches_cudnn(gen, groups, cin, cout):
    """`conv2d_gemm` with groups (one product a tap, batched over the
    groups) at ProPainter's grouped encoder layers' full shapes (24 frames
    of 90x160) against cuDNN, fp32 (the groups-4 layer is a GEMM site; the
    groups-2 and groups-8 ones keep cuDNN, as fast or faster there).
    Largest abs error on the card: 1.48e-5 (groups 2, 2,880 terms); the
    same tolerance as the sites'."""
    x = torch.randn(24, 90, 160, cin, generator=gen, device="cuda")
    w = torch.randn(cout, cin // groups, 3, 3, generator=gen, device="cuda") / (cin // groups * 9) ** 0.5
    b = torch.randn(cout, generator=gen, device="cuda")
    with torch.no_grad():
        got = conv.conv2d_gemm(x, conv.gemm_weight(w), b, (3, 3), (1, 1), groups)
        want = conv.conv2d(x, w, b, padding=(1, 1), groups=groups)
    print(f"groups {groups}: max abs err {float((got - want).abs().max()):.3e} of {float(want.abs().max()):.3e}")
    torch.testing.assert_close(got, want, atol=5e-5, rtol=1e-5)


@pytest.mark.parametrize("fp16", ["disable", "enable"])
def test_node_clip_conv_gemm_and_no_fft(gen, fp16):
    """The inpaint node on one clip of the benchmark's
    `inpaint-360p-fp32.object` (24 frames at 640x360, the shapes GEMM_SITES
    was measured at), after a warm-up: in float32 (fp16 "disable") the GEMM
    sites launch `conv_gemm` and the profiled clip runs no cuDNN FFT
    kernel; in bf16 no `conv_gemm` at all."""
    from torch.profiler import ProfilerActivity, profile

    from benchmark.core import session, traffic
    from comfyui_propainter_nodes_tpu_torch.nodes import ProPainterInpaint

    spec = session.cell_spec(session.manifest(), "inpaint-360p-fp32.object")
    widgets = dict(session.widgets(spec), fp16=fp16)
    image, mask = traffic.inputs(spec.mix, widgets, 7, 0)
    node = ProPainterInpaint()
    session.call_node(node, "inpaint", image, mask, widgets)
    before = launched("conv_gemm")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        session.call_node(node, "inpaint", image, mask, widgets)
        torch.cuda.synchronize()
    counted = launched("conv_gemm") - before
    names = [e.key for e in prof.key_averages() if e.device_time_total > 0]
    fft = [n for n in names if any(p in n for p in ("fft", "cf32", "DSE::", "pointwise_mult_and_sum_complex"))]
    assert not fft, fft
    assert counted > 0 if fp16 == "disable" else counted == 0


def test_node_byte_helpers_match_the_host(gen):
    """The nodes' quantizer, division and composition on the card equal the
    host's bit for bit: `_to_u8` over the float32 grid of
    `test_torch_node_card_io.py`, every byte's k / 255 (CUDA's division by a
    host scalar multiplies by the reciprocal), and a composition of pieces;
    the fetch lands in new page-locked host memory each call."""
    from comfyui_propainter_nodes_tpu_torch import nodes
    from test_torch_node_card_io import _grid

    x = _grid()
    got = nodes._quantize(torch.from_numpy(x).cuda())
    assert np.array_equal(got.cpu().numpy(), nodes._to_u8(x).astype(np.float32))
    k = torch.arange(256, dtype=torch.float32)
    want = (k.numpy() / np.float32(255)).astype(np.float32)
    assert np.array_equal(nodes._unit(k.cuda()).cpu().numpy(), want)
    moved = int((k.cuda().div_(255.0).cpu() != torch.from_numpy(want)).sum())
    print(f"CUDA's division by a host scalar moves {moved} of the 256 quotients")
    byte = torch.randint(0, 256, (6, 40, 48, 3), generator=gen, device="cuda", dtype=torch.uint8)
    band = torch.randint(0, 256, (6, 40, 8, 3), generator=gen, device="cuda", dtype=torch.uint8)
    crop = torch.rand(6, 16, 24, 3, generator=gen, device="cuda") * 255
    pieces = [(slice(None), slice(8, 56), byte), (slice(None), slice(None, 8), band),
              (slice(4, 20), slice(16, 40), crop.to(torch.uint8))]
    on_card = nodes._unit(nodes._compose((6, 40, 64, 3), pieces, "cuda"))
    on_host = nodes._unit(nodes._compose((6, 40, 64, 3), [(r, c, p.cpu()) for r, c, p in pieces], "cpu"))
    first, second = nodes._fetch(on_card), nodes._fetch(on_card)
    assert first.device.type == "cpu" and first.is_pinned() and first.data_ptr() != second.data_ptr()
    assert torch.equal(first, on_host) and torch.equal(second, on_host)


@pytest.mark.parametrize("kind", ["inpaint", "outpaint"])
def test_node_card_io_on_the_card_matches_the_host_paste(gen, monkeypatch, kind):
    """Both nodes on the card, at the benchmark cells' 24 x 360 x 640 (the
    outpaint node with four bands), on the stand-in pipeline of
    `test_torch_node_card_io.py`: outputs bit for bit those of the host prep
    and paste, the pipeline's inputs too (the outpaint canvas's bytes
    exactly, its normalised frames within an ulp); `node_card_io` counts 1
    a call at the process size and 0 for a clip the node resizes."""
    from comfyui_propainter_nodes_tpu_torch import nodes
    from test_torch_node_card_io import INPAINT, StandIn, host_inpaint, host_outpaint

    rng = np.random.default_rng(3)
    frames = rng.random((24, 360, 640, 3), dtype=np.float32) * 1.2 - 0.1
    masks = np.zeros((24, 360, 640), np.float32)
    for i in range(24):
        masks[i, 100 + i : 160 + i, 200 + 3 * i : 280 + 3 * i] = 1.0
    w = dict(INPAINT, width=640, height=360, mask_dilates=5, flow_mask_dilates=8)
    stand_in = StandIn()
    monkeypatch.setattr(nodes, "get_pipeline", lambda *a: stand_in)
    before = launched("node_card_io")
    if kind == "inpaint":
        node = nodes.ProPainterInpaint()
        got = node.propainter_inpainting(frames, masks, **w)
        want, crop, inputs = host_inpaint(StandIn(), frames, masks, w, dev="cuda")
        assert node.last_crop == crop
        for a, b in zip(stand_in.calls[0][:4], inputs):
            assert torch.equal(a, b)
        small = (frames[:, ::4, ::4], masks[:, ::4, ::4])
        resize = lambda: node.propainter_inpainting(*small, **dict(w, width=96, height=64))  # noqa: E731
    else:
        w = dict(w, width_scale=1.2, height_scale=1.5)
        node = nodes.ProPainterOutpaint()
        got = node.propainter_outpainting(frames, **w)
        want, inputs = host_outpaint(StandIn(), frames, w, dev="cuda")
        frames_norm, flow_masks, masks_dilated, canvas = stand_in.calls[0][:4]
        assert torch.equal(flow_masks, inputs[1]) and torch.equal(masks_dilated, inputs[2])
        # the canvas is the bytes; the host's round trip through / 255 and * 255
        # left 126 of the 256 bytes a float32 ulp above themselves on the card
        # (CUDA divides by a host scalar as a product with its reciprocal)
        assert torch.equal(canvas, torch.floor(inputs[3]))
        torch.testing.assert_close(frames_norm, inputs[0], atol=1.2e-7, rtol=0)
        resize = lambda: node.propainter_outpainting(frames[:, ::4, ::4], **dict(w, width=96, height=64))  # noqa: E731
    assert launched("node_card_io") == before + 1
    for a, b in zip(got, want):
        assert (torch.equal(a, b) and a.device.type == "cpu") if isinstance(a, torch.Tensor) else a == b
    resize()
    assert launched("node_card_io") == before + 1


def test_trace_us_matches_the_cuda_profiler_ranges(gen, tmp_path):
    """20 spans around device work under a CPU and CUDA profiler: one
    range each in its Chrome trace; each span mapped by `trace_us` beside
    its range (the offsets printed)."""
    import json

    from torch.profiler import ProfilerActivity, profile

    profiling.reset()
    x = torch.randn(1 << 20, generator=gen, device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            with profiling.span("node.upload"):
                (x * 2).sum().item()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    base_us = trace.get("baseTimeNanoseconds", 0) / 1e3
    theirs = sorted((e["ts"] + base_us, e["ts"] + e["dur"] + base_us) for e in trace["traceEvents"]
                    if e.get("cat") == "user_annotation" and e.get("name") == "node.upload")
    mine = sorted((profiling.trace_us(r.start_ns), profiling.trace_us(r.end_ns)) for r in profiling.spans())
    profiling.reset()
    assert len(mine) == len(theirs) == 20
    offsets = [m - t for pair in zip(mine, theirs) for m, t in zip(*pair)]
    print(f"trace_us less the profiler's range: {min(offsets):.1f} to {max(offsets):.1f} us")


# image propagation's step (prop_fill): (batch rows, frames, height, width,
# dtype, interpolation, first index): the two cells' clips, bilinear, path
# C's batch of two 100-frame chunks with per-row restarts, an odd size
PROP_FILL_CASES = {
    "outpaint_bf16": (1, 24, 360, 768, torch.bfloat16, "nearest", 0),
    "inpaint_fp32": (1, 24, 360, 640, torch.float32, "nearest", 0),
    "bilinear_bf16": (2, 6, 90, 160, torch.bfloat16, "bilinear", 0),
    "bilinear_fp32": (2, 6, 90, 160, torch.float32, "bilinear", 0),
    "path_c_bf16": (2, 100, 360, 640, torch.bfloat16, "nearest", "per_row"),
    "path_c_fp32": (2, 100, 360, 640, torch.float32, "nearest", "per_row"),
    "odd_bf16": (3, 5, 17, 23, torch.bfloat16, "bilinear", 2),
    "odd_fp32": (3, 5, 17, 23, torch.float32, "nearest", "per_row"),
}


def _prop_inputs(gen, n, t, h, w, dt):
    """Frames zero (signs kept) inside a moving box, binary masks, flows of
    a few pixels with a quarter on half pixels and a band far outside."""
    yy = torch.arange(h, device="cuda")[:, None]
    xx = torch.arange(w, device="cuda")[None, :]
    mask = torch.zeros(n, t, h, w, 1, device="cuda")
    for i in range(n):
        for j in range(t):
            y0, x0 = (h // 6 + 2 * j + i) % (h // 2), (w // 8 + 3 * j + 5 * i) % (w // 2)
            mask[i, j, ((yy >= y0) & (yy < y0 + h // 3) & (xx >= x0) & (xx < x0 + w // 3))] = 1.0
    x = (torch.rand(n, t, h, w, 3, generator=gen, device="cuda") * 2 - 1) * (1 - mask)

    def flows():
        f = torch.randn(n, t - 1, h, w, 2, generator=gen, device="cuda") * 3
        f[:, :, : h // 4] = torch.round(f[:, :, : h // 4] * 2) / 2
        f[:, :, -2:, :, 0] += 40.0
        return f

    return [a.to(dt).contiguous() for a in (x, mask, flows(), flows())]


@pytest.mark.parametrize("case", list(PROP_FILL_CASES))
@pytest.mark.parametrize("reverse", [False, True], ids=["forward", "backward"])
def test_prop_fill_is_bit_equal(gen, case, reverse):
    """The kernel against its plain step on the card, bit for bit (signed
    zeros included), both directions; one launch a step after the first."""
    n, t, h, w, dt, interp, first = PROP_FILL_CASES[case]
    args = _prop_inputs(gen, n, t, h, w, dt)
    fi = torch.tensor([0, t // 2 + 1][:n] + [1] * (n - 2), device="cuda") if first == "per_row" else first
    before = launched("prop_fill")
    got = pf.prop_fill(*args, interp, fi, reverse=reverse)
    assert launched("prop_fill") == before + t - 1 - (0 if first == "per_row" else first)
    want = pf.prop_fill_plain(*args, interp, fi, reverse=reverse)
    for g, r in zip(got, want):
        assert g.dtype == dt
        bad = int((g != r).sum())
        assert torch.equal(g, r), f"{bad} values differ, max {float((g.float() - r.float()).abs().max())}"
        assert torch.equal(torch.signbit(g), torch.signbit(r))


def test_prop_fill_rounding_points_are_eager_pytorchs(gen):
    """The rounding the kernel copies from eager PyTorch on the card, in
    bf16: binarize's threshold is 0.1 rounded to bf16 (0.10009765625 is not
    above it); a product with the float scalar 0.01 is taken in float32
    and rounded once; a two-term sum is added in float32 and rounded once;
    a square is the product rounded."""
    from comfyui_propainter_nodes_tpu_torch.ops.dilation import binarize

    edge = torch.tensor([0.0996094, 0.10009765625, 0.1005859375], device="cuda", dtype=torch.bfloat16)
    assert binarize(edge).tolist() == [0.0, 0.0, 1.0]
    v = (torch.rand(4096, 2, generator=gen, device="cuda") * 300).to(torch.bfloat16)
    f = v.float()
    assert torch.equal(0.01 * v[:, 0], (f[:, 0] * 0.01).to(torch.bfloat16))
    assert torch.equal(v**2, (f * f).to(torch.bfloat16))
    assert torch.equal(torch.sum(v, -1), (f[:, 0] + f[:, 1]).to(torch.bfloat16))


def test_prop_fill_checks_on_the_card(gen):
    """On CUDA the kernel takes fp32 and bf16 only, flows whose pairs are
    aligned loads, and no input that requires grad."""
    x, mask, fp, fc = _prop_inputs(gen, 1, 3, 8, 12, torch.float32)
    with pytest.raises(ValueError, match="prop_fill: inputs must share"):
        pf.prop_fill(*(a.double() for a in (x, mask, fp, fc)))
    odd = torch.empty(fp.numel() + 1, device="cuda")[1:].view(fp.shape)
    odd.copy_(fp)
    with pytest.raises(ValueError, match="aligned"):
        pf.prop_fill(x, mask, odd, fc)
    with pytest.raises(ValueError, match="no backward"):
        pf.prop_fill(x.clone().requires_grad_(), mask, fp, fc)


@pytest.mark.parametrize("cell", ["outpaint-360p.sides", "inpaint-360p-fp32.object"])
def test_prop_fill_counts_46_a_node_clip(gen, cell):
    """One node clip of each cell's traffic launches `prop_fill` 46 times
    (23 steps a direction of 24 frames); the same image propagation on CPU
    tensors launches none."""
    from benchmark.core import session, traffic
    from comfyui_propainter_nodes_tpu_torch import nodes
    from comfyui_propainter_nodes_tpu_torch.models import propainter as tpp

    spec = session.cell_spec(session.manifest(), cell)
    widgets = session.widgets(spec)
    kind = spec.mix["node"]
    image, mask = traffic.inputs(spec.mix, widgets, 7, 0)
    node = (nodes.ProPainterInpaint if kind == "inpaint" else nodes.ProPainterOutpaint)()
    before = launched("prop_fill")
    session.call_node(node, kind, image, mask, widgets)
    assert launched("prop_fill") - before == 46
    x, m, ff, fb = (a.cpu() for a in _prop_inputs(gen, 1, 24, 16, 24, torch.float32))
    before = launched("prop_fill")
    tpp.bidirectional_propagation_image(x, ff, fb, m)
    assert launched("prop_fill") == before


NODE_CLIP_LAUNCHES = {
    # 6 RAFT calls (chunks of 4 frames), each one pyramid build and 20 lookups in the map-dtype blend;
    # B4 at the 60x108 token grid
    "inpaint-720p.object": {"raft_form/chunks": 1, "corr_pyramid": 6, "corr_lookup_map": 120, "corr_lookup": 0,
                            "window_attention_tiled": 8, "window_attention": 0, "prop_fill": 46},
    # one RAFT call: one pyramid build and 20 lookups in the lanes blend; B3 at the 30x54 token grid
    "inpaint-360p.object": {"raft_form/one call": 1, "corr_pyramid": 1, "corr_lookup": 20, "corr_lookup_map": 0,
                            "window_attention": 8, "window_attention_tiled": 0, "prop_fill": 46},
}


@pytest.mark.parametrize("cell", sorted(NODE_CLIP_LAUNCHES))
def test_node_clip_launches_by_resolution(gen, cell):
    """One 24-frame bf16 clip of each bf16 inpaint cell through the node:
    RAFT's form (one `raft_form/<form>` a clip, no other form), the
    lookup's blend and the attention kernel that the resolution picks."""
    from benchmark.core import session, traffic
    from comfyui_propainter_nodes_tpu_torch import nodes

    spec = session.cell_spec(session.manifest(), cell)
    widgets = session.widgets(spec)
    image, mask = traffic.inputs(spec.mix, widgets, 7, 0)
    node = nodes.ProPainterInpaint()
    before = profiling.counters()
    session.call_node(node, "inpaint", image, mask, widgets)
    since = {k: v - before.get(k, 0) for k, v in profiling.counters().items()}
    expected = NODE_CLIP_LAUNCHES[cell]
    assert {k: since.get(k, 0) for k in expected} == expected
    assert sum(v for k, v in since.items() if k.startswith("raft_form/")) == 1


# RAFT's correlation pyramids (corr_pyramid): (pairs, H8, W8, channels): the
# cells' calls (one of 23 pairs at 640x360 and on the 768x360 canvas, 4 and 3
# pairs at 1280x720) and odd or tiny grids (levels 2-3 empty at 3x5)
CORR_PYRAMID_CASES = {
    "inpaint_360p": (23, 45, 80, 256),
    "outpaint_360p": (23, 45, 96, 256),
    "720p_4": (4, 90, 160, 256),
    "720p_3": (3, 90, 160, 256),
    "odd": (2, 45, 81, 256),
    "odd_small": (3, 9, 13, 64),
    "tiny": (2, 3, 5, 16),
}


def _pyramid_maps(gen, case, integer=False):
    n, h, w, c = CORR_PYRAMID_CASES[case]
    if integer:  # every float32 sum exact, in any order
        return [torch.randint(-3, 4, (n, h, w, c), generator=gen, device="cuda").to(torch.bfloat16) for _ in range(2)]
    return [torch.randn(n, h, w, c, generator=gen, device="cuda").to(torch.bfloat16) for _ in range(2)]


def _bf16_ulp(v):
    """The spacing of bf16 values at |v| (8 significant bits)."""
    _, e = torch.frexp(v.float())
    return torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 8)


@pytest.mark.parametrize("case", list(CORR_PYRAMID_CASES))
def test_corr_pyramid_matches_plain(gen, case):
    """The kernel against the eager build on the card, one launch a call:
    level 0 within one bf16 ulp of the plain value plus 2^-16 of the sum
    of |f1 f2| / sqrt(C) (two float32 sums of C products in another order
    differ by at most that before each rounds to bf16, and where the sum
    cancels that term is the larger); the backward level 0 bit for bit the
    transpose of the kernel's forward one; levels 1-3 of both directions
    bit for bit `pool_pyramid` of the kernel's own level 0."""
    n, h, w, c = CORR_PYRAMID_CASES[case]
    f1, f2 = _pyramid_maps(gen, case)
    before = launched("corr_pyramid")
    fwd, bwd = cpk.corr_pyramids(f1, f2, backward=True)
    assert launched("corr_pyramid") == before + 1
    want_f, _ = cpk.corr_pyramids_plain(f1, f2, backward=False)
    a1, a2 = (f.reshape(n, h * w, c).float().abs() for f in (f1, f2))
    slack = torch.matmul(a1, a2.transpose(1, 2)).reshape(n * h * w, h, w) / math.sqrt(c) * 2.0**-16
    err = (fwd[0].float() - want_f[0].float()).abs()
    tol = _bf16_ulp(want_f[0]) + slack
    assert bool((err <= tol).all()), f"{int((err > tol).sum())} values beyond, max err {float(err.max())}"
    del want_f, a1, a2, slack, err, tol
    f0 = fwd[0].reshape(n, h * w, h * w)
    assert torch.equal(bwd[0].reshape(n, h * w, h * w), f0.transpose(1, 2))
    for got in (fwd, bwd):
        want = cpk.pool_pyramid(got[0])
        for lvl in range(1, 4):
            assert got[lvl].shape == want[lvl].shape and got[lvl].dtype == torch.bfloat16
            assert torch.equal(got[lvl], want[lvl]), f"level {lvl}: {int((got[lvl] != want[lvl]).sum())} differ"


@pytest.mark.parametrize("case", ["inpaint_360p", "720p_3", "odd", "odd_small", "tiny"])
def test_corr_pyramid_integer_maps_bit_equal(gen, case):
    """Integer-valued maps: every sum is exact, so both directions' four
    levels equal the plain build bit for bit, and the forward-only call
    the forward half of the two-direction one."""
    f1, f2 = _pyramid_maps(gen, case, integer=True)
    fwd, bwd = cpk.corr_pyramids(f1, f2, backward=True)
    want_f, want_b = cpk.corr_pyramids_plain(f1, f2, backward=True)
    for got, want in ((fwd, want_f), (bwd, want_b)):
        for lvl in range(4):
            assert torch.equal(got[lvl], want[lvl]), f"level {lvl}: {int((got[lvl] != want[lvl]).sum())} differ"
    del want_f, want_b, bwd
    only, none = cpk.corr_pyramids(f1, f2, backward=False)
    assert none is None
    for lvl in range(4):
        assert torch.equal(only[lvl], fwd[lvl])


def test_corr_pyramid_dtype_rule_on_the_card(gen):
    """bf16 maps launch the kernel once a RAFT build; float32 maps on the
    card take the eager build through models/raft.py and raise at the
    wrapper; a call under grad with maps that require grad raises."""
    f1, f2 = _pyramid_maps(gen, "odd_small")
    before = launched("corr_pyramid")
    traft.build_corr_pyramids(f1, f2)
    traft.build_corr_pyramids(f1, f2, backward=False)
    assert launched("corr_pyramid") == before + 2
    traft.build_corr_pyramids(f1.float(), f2.float())
    traft.build_corr_pyramids(f1.float(), f2.float(), backward=False)
    assert launched("corr_pyramid") == before + 2
    with pytest.raises(ValueError, match="must be bf16"):
        cpk.corr_pyramids(f1.float(), f2.float())
    with pytest.raises(ValueError, match="no backward"):
        cpk.corr_pyramids(f1.float().requires_grad_().to(torch.bfloat16), f2)
    with torch.no_grad():
        cpk.corr_pyramids(f1.clone().requires_grad_(), f2)
    assert launched("corr_pyramid") == before + 3


@pytest.mark.parametrize("cell,launches", [("outpaint-360p.sides", 1), ("inpaint-360p-fp32.object", 0)])
def test_corr_pyramid_counts_a_node_clip(gen, cell, launches):
    """One node clip of each 360p cell's traffic: one pyramid build in bf16
    (RAFT's one call), none in float32 (the eager build)."""
    from benchmark.core import session, traffic
    from comfyui_propainter_nodes_tpu_torch import nodes

    spec = session.cell_spec(session.manifest(), cell)
    widgets = session.widgets(spec)
    kind = spec.mix["node"]
    image, mask = traffic.inputs(spec.mix, widgets, 7, 0)
    node = (nodes.ProPainterInpaint if kind == "inpaint" else nodes.ProPainterOutpaint)()
    before = launched("corr_pyramid")
    session.call_node(node, kind, image, mask, widgets)
    assert launched("corr_pyramid") - before == launches
