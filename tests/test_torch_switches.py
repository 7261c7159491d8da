"""The JAX package's attention switch in the port: PROPAINTER_TPU_ATTN=halo
(the halo window attention, B5).

Each test runs the port's layer (the kernel's plain version on the CPU)
against the JAX layer with the same switch, `_USE_PALLAS` forced and the
Pallas kernel in interpret mode; inputs from a seeded numpy generator,
fp32. Both packages read the switch at call time. The RAFT switch
(PROPAINTER_TPU_CORR_KERNEL=pallas) is tested beside its kernels, in
tests/test_torch_kernels_alt.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from comfyui_propainter_nodes_tpu.ops import attention as jatt
from comfyui_propainter_nodes_tpu.ops import deform_conv as jdc
from comfyui_propainter_nodes_tpu.utils.weights import random_params
from comfyui_propainter_nodes_tpu_torch.ops import attention as tatt
from comfyui_propainter_nodes_tpu_torch.utils.params import from_jax_params

torch.set_num_threads(1)

PRE = "transformers.transformer.0.attention"


@pytest.fixture(scope="module")
def attention_params():
    full = random_params("inpaint_generator")
    raw = {k: v for k, v in full.items() if k.startswith(PRE)}
    return {k: jnp.asarray(v) for k, v in raw.items()}, from_jax_params(raw)


def _box_mask(b, l_t, fh, fw, rows, cols):
    m = np.zeros((b, l_t, fh, fw, 1), np.float32)
    m[:, :, rows[0] : rows[1], cols[0] : cols[1]] = 1.0
    return m


# (b, t, fh, fw, l_t, mask box or None, t_ind, t_valid, seed): the JAX
# package's three halo tests (tests/test_pallas_attention.py:173-259,
# tests/test_pallas_kernels.py:207-245)
_HALO_CASES = {
    "mixed": (2, 6, 12, 20, 4, ((3, 7), (4, 12)), np.arange(0, 6, 2), [True] * 5 + [False], 11),
    "multi_chunk_pooled": (1, 8, 40, 56, 5, ((10, 20), (15, 35)), None, None, 17),
    "all_clean": (1, 4, 10, 18, 3, None, None, None, 13),
}


@pytest.mark.parametrize("case", list(_HALO_CASES))
def test_halo_attention_matches_jax(monkeypatch, attention_params, case):
    """Padded token grids, t_ind subsets, a padded frame, mixed / all-clean
    occupancy, a pooled segment longer than the TPU kernel's 1024-key chunk.
    Tolerance as the JAX package's halo tests (atol 2e-4, rtol 1e-3)."""
    b, t, fh, fw, l_t, box, t_ind, t_valid, seed = _HALO_CASES[case]
    pj, pt = attention_params
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, t, fh, fw, 512)) * 0.1).astype(np.float32)
    mask = _box_mask(b, l_t, fh, fw, *box) if box else np.zeros((b, l_t, fh, fw, 1), np.float32)
    tv_j = None if t_valid is None else jnp.asarray(t_valid)
    tv_t = None if t_valid is None else torch.tensor(t_valid)

    monkeypatch.setenv("PROPAINTER_TPU_ATTN", "halo")
    monkeypatch.setattr(jdc, "_USE_PALLAS", True)
    with pltpu.force_tpu_interpret_mode():
        ref = jatt.sparse_window_attention(pj, PRE, jnp.asarray(x), jnp.asarray(mask), t_ind, t_valid_mask=tv_j)
    out = tatt.sparse_window_attention(pt, PRE, torch.from_numpy(x), torch.from_numpy(mask), t_ind, t_valid_mask=tv_t)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4, rtol=1e-3)


def test_attention_switch_is_read_at_call_time(monkeypatch, attention_params):
    """The same process takes the halo kernel while the switch is set and
    the segmented kernels once it is unset."""
    _, pt = attention_params
    calls = []
    real = tatt.window_attention_halo
    monkeypatch.setattr(tatt, "window_attention_halo", lambda *a, **k: calls.append(1) or real(*a, **k))
    rng = np.random.default_rng(5)
    x = torch.from_numpy((rng.standard_normal((1, 4, 10, 18, 512)) * 0.1).astype(np.float32))
    mask = torch.from_numpy(_box_mask(1, 2, 10, 18, (2, 6), (3, 9)))
    monkeypatch.setenv("PROPAINTER_TPU_ATTN", "halo")
    halo = tatt.sparse_window_attention(pt, PRE, x, mask, np.arange(0, 4, 2))
    assert len(calls) == 1
    monkeypatch.delenv("PROPAINTER_TPU_ATTN")
    seg = tatt.sparse_window_attention(pt, PRE, x, mask, np.arange(0, 4, 2))
    assert len(calls) == 1
    # the two forms compute one function
    torch.testing.assert_close(halo, seg, atol=2e-5, rtol=1e-4)


def test_halo_wrapper_rejects_other_devices():
    from comfyui_propainter_nodes_tpu_torch.ops.cuda import window_attention_halo as b5

    g = torch.zeros((1, 2, 5, 9, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        b5.window_attention_halo(g, g, g, g, g, g, g, g, g, g, g, window_size=(5, 9), n_head=1)


def test_halo_bias_static_keeps_the_rolled_survivors():
    """148 of the 11x19 halo positions of a (5, 9) window are rolled
    survivors, as many as the segmented path's rolled keys per frame."""
    from comfyui_propainter_nodes_tpu.ops.pallas.window_attention_halo import halo_bias_static as jax_bias
    from comfyui_propainter_nodes_tpu_torch.ops.attention import _valid_rolled_indices
    from comfyui_propainter_nodes_tpu_torch.ops.cuda.window_attention_halo import halo_bias_static

    for ws in ((5, 9), (3, 5)):
        bias = halo_bias_static(ws)
        np.testing.assert_array_equal(bias, jax_bias(ws))
        assert int((bias == 0).sum()) == _valid_rolled_indices(ws).size
