"""The port's CUDA kernels vs their plain versions, on the card.

Marked `cuda`; each test skips without a card. The file imports neither
jax nor the JAX package, so it also runs where jax is absent:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: fp32 (TF32 off) 1e-5 for the corr lookup (the same taps in
the same order), 1e-4 for sums over hundreds of terms; bf16 3e-2 (the
plain versions compute in fp32 and round once; the kernels round the
output too, so one bf16 ulp of the result can separate them)."""

import numpy as np
import pytest
import torch

from comfyui_propainter_nodes_tpu_torch.models.raft import build_corr_pyramids
from comfyui_propainter_nodes_tpu_torch.ops.cuda import corr_lookup as b1
from comfyui_propainter_nodes_tpu_torch.ops.cuda import deform_conv as b2
from comfyui_propainter_nodes_tpu_torch.ops.cuda import window_attention as b3

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
    torch.testing.assert_close(out, b1.corr_lookup_plain(pyr, coords), atol=1e-5, rtol=1e-5)
    assert torch.count_nonzero(out[0, :4]) == 0


@pytest.mark.parametrize("dt,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("cin,g", [(64, 16), (48, 4)])
def test_deform_conv_matches_plain(gen, dt, tol, cin, g):
    """Cin not a multiple of the 32-channel chunk, Cout not of the
    128-channel tile, H*W not of the 64-pixel tile."""
    x = torch.randn(2, 13, 21, cin, generator=gen, device="cuda").to(dt)
    off = (torch.randn(2, 13, 21, g, 9, 2, generator=gen, device="cuda") * 4).to(dt)
    mask = torch.rand(2, 13, 21, g, 9, generator=gen, device="cuda").to(dt)
    w = (torch.randn(40, cin, 3, 3, generator=gen, device="cuda") * 0.05).to(dt)
    bias = torch.randn(40, generator=gen, device="cuda").to(dt)
    torch.testing.assert_close(
        b2.deform_conv2d(x, off, mask, w, bias), b2.deform_conv2d_plain(x, off, mask, w, bias), atol=tol, rtol=tol
    )


@pytest.mark.parametrize("dt,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
def test_window_attention_matches_plain(gen, dt, tol):
    """Mixed occupancy, per-batch-row biases, ragged segment lengths."""
    b, nwb, nh, t, wsz, ch = 2, 3, 2, 4, 45, 64
    nw = b * nwb
    rl, pl_len = 2 * 148, 2 * 91

    def r(*s):
        return torch.randn(*s, generator=gen, device="cuda").to(dt)

    args = [r(nw, nh, t, wsz, ch), r(nw, nh, t, wsz, ch), r(nw, nh, t, wsz, ch),
            r(nw, nh, rl, ch), r(nw, nh, rl, ch), r(b, nh, pl_len, ch), r(b, nh, pl_len, ch)]
    occ = torch.tensor([True, False, True, False, False, True], device="cuda")
    tv = torch.tensor([[True, True, True, True], [True, True, True, False]], device="cuda")
    in_tind = torch.tensor([True, False, True, False], device="cuda")
    bias_w = torch.where(in_tind[None] & tv, 0.0, -1e9).repeat_interleave(wsz, 1).float()
    sel = tv[:, in_tind]
    bias_r = torch.where(sel, 0.0, -1e9).repeat_interleave(148, 1).float()
    bias_p = torch.where(sel, 0.0, -1e9).repeat_interleave(91, 1).float()
    full = args + [occ, bias_w, bias_r, bias_p]
    torch.testing.assert_close(
        b3.window_attention(*full, n_win_per_b=nwb), b3.window_attention_plain(*full, nwb), atol=tol, rtol=tol
    )


def test_wrappers_check_their_inputs(gen):
    x = torch.zeros((1, 8, 8, 32), device="cuda")
    off = torch.zeros((1, 8, 8, 4, 9, 2), device="cuda")
    mask = torch.zeros((1, 8, 8, 4, 9), device="cuda")
    w = torch.zeros((16, 32, 3, 3), device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        b2.deform_conv2d(x, off.transpose(1, 2), mask, w)
    with pytest.raises(ValueError, match="fp32 or bf16"):
        b2.deform_conv2d(x.half(), off.half(), mask.half(), w.half())
