"""RAFT's correlation pyramids (`ops/cuda/corr_pyramid.py`) on the CPU.

The plain version is held bit for bit against the eager build the port
ran before the kernel (`_eager_pyramids`, written out below as
`models/raft.py::build_corr_pyramids` and `build_corr_pyramid` had it),
in bf16 and float32, on even grids, odd grids and grids whose coarse
levels are empty; `models/raft.py` is held to route bf16 maps to the
wrapper and float32 maps to the eager build. `tile_model` is the
kernel's schedule in PyTorch (csrc/corr_pyramid.cu): its tile order,
the zero rows off the grid, level 0 staged in bf16, the pieces each tile
writes and levels 1-3 pooled inside the tile. With integer-valued maps
every float32 sum is exact in any order, so the model, the plain version
and the kernel agree bit for bit there. The kernel itself runs only on a
card (`tests/test_torch_cuda.py`)."""

import math

import pytest
import torch

from comfyui_propainter_nodes_tpu_torch.models import raft as traft
from comfyui_propainter_nodes_tpu_torch.ops.cuda import corr_pyramid as cp
from comfyui_propainter_nodes_tpu_torch.utils import profiling

torch.set_num_threads(1)

# (pairs, H8, W8, channels): even grids, odd grids, a grid whose levels 2
# and 3 are empty and one whose level 3 is; channels whose square root is
# a power of two, so the kernel's scaling (times 1 / sqrt(C)) is the plain
# version's division exactly
GRIDS = {
    "even": (2, 16, 32, 64),
    "odd": (1, 45, 81, 16),
    "odd_small": (3, 9, 13, 16),
    "tiny": (2, 3, 5, 16),
    "level3_empty": (1, 7, 6, 64),
}


def _eager_pyramids(fmap1, fmap2, backward=True):
    """The eager build as `models/raft.py` had it before the kernel."""
    n, h, w, c = fmap1.shape
    f1 = fmap1.reshape(n, h * w, c).float()
    f2 = fmap2.reshape(n, h * w, c).float()
    corr = torch.matmul(f1, f2.transpose(1, 2))
    corr.div_(math.sqrt(c))
    corr = corr.to(fmap1.dtype)

    def pool(level0):
        pyramid = [level0]
        m = level0
        for _ in range(3):
            h2, w2 = m.shape[1] // 2, m.shape[2] // 2
            msum = m[:, 0 : 2 * h2 : 2] + m[:, 1 : 2 * h2 : 2]
            m = msum[:, :, 0 : 2 * w2 : 2] * 0.25 + msum[:, :, 1 : 2 * w2 : 2] * 0.25
            pyramid.append(m.contiguous())
        return pyramid

    fwd = pool(corr.reshape(n * h * w, h, w))
    if not backward:
        return fwd, None
    return fwd, pool(corr.transpose(1, 2).reshape(n * h * w, h, w).contiguous())


def _maps(shape, dt, seed=0, integer=False):
    g = torch.Generator().manual_seed(seed)
    if integer:
        return [torch.randint(-3, 4, shape, generator=g).to(dt) for _ in range(2)]
    return [torch.randn(shape, generator=g).to(dt) for _ in range(2)]


def _equal(got, want):
    assert len(got) == len(want) == 4
    for lvl, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and a.dtype == b.dtype, (lvl, a.shape, b.shape)
        assert torch.equal(a, b), f"level {lvl}: {int((a != b).sum())} values differ"


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("grid", list(GRIDS))
def test_plain_is_the_eager_build(dt, grid):
    """`corr_pyramids_plain`, the wrapper on CPU tensors and both builds of
    `models/raft.py` equal the eager build bit for bit, both directions."""
    f1, f2 = _maps(GRIDS[grid], dt)
    want_f, want_b = _eager_pyramids(f1, f2)
    for got_f, got_b in (cp.corr_pyramids_plain(f1, f2), cp.corr_pyramids(f1, f2), traft.build_corr_pyramids(f1, f2)):
        _equal(got_f, want_f)
        _equal(got_b, want_b)
    for fwd, none in (cp.corr_pyramids(f1, f2, backward=False), traft.build_corr_pyramids(f1, f2, backward=False)):
        assert none is None
        _equal(fwd, want_f)


@pytest.mark.parametrize("grid", list(GRIDS))
def test_backward_level0_is_the_transpose(grid):
    """Backward level 0, row q over image 1's grid, is forward level 0,
    row p over image 2's grid, transposed pair by pair."""
    n, h, w, _ = GRIDS[grid]
    fwd, bwd = cp.corr_pyramids(*_maps(GRIDS[grid], torch.bfloat16, seed=1))
    f0 = fwd[0].reshape(n, h * w, h * w)
    b0 = bwd[0].reshape(n, h * w, h * w)
    assert torch.equal(b0, f0.transpose(1, 2))


def test_level_shapes_and_empty_levels():
    """Level l is [N*H*W, H >> l, W >> l]; at 3x5 levels 2 and 3 are
    empty, as `pool_pyramid` leaves them."""
    fwd, bwd = cp.corr_pyramids(*_maps((2, 3, 5, 16), torch.bfloat16))
    for pyr in (fwd, bwd):
        assert [tuple(m.shape) for m in pyr] == [(30, 3, 5), (30, 1, 2), (30, 0, 1), (30, 0, 0)]


def test_raft_routes_bf16_to_the_wrapper(monkeypatch):
    """`build_corr_pyramids` hands bf16 maps to `corr_pyramids` (backward
    set for both directions) and builds float32 maps eagerly; the padded
    build of the "pallas" lookup never calls it."""
    calls = []

    def spy(fmap1, fmap2, backward=True):
        calls.append((fmap1.dtype, backward))
        return cp.corr_pyramids_plain(fmap1, fmap2, backward)

    monkeypatch.setattr(traft, "corr_pyramids", spy)
    b1, b2 = _maps((1, 6, 8, 16), torch.bfloat16)
    traft.build_corr_pyramids(b1, b2)
    traft.build_corr_pyramids(b1, b2, backward=False)
    assert calls == [(torch.bfloat16, True), (torch.bfloat16, False)]
    calls.clear()
    traft.build_corr_pyramids(b1.float(), b2.float())
    traft.build_corr_pyramids(b1.float(), b2.float(), backward=False)
    traft.build_padded_pyramid_bi(b1, b2)
    traft.build_padded_pyramid(b1, b2)
    assert calls == []
    # and RAFT's lookup of a bf16 call builds through it: one call, both directions
    traft._lookup_fn("map", b1, b2, bidirectional=True)
    traft._lookup_fn("lanes", b1, b2, bidirectional=False)
    assert calls == [(torch.bfloat16, True), (torch.bfloat16, False)]


def test_wrapper_checks_and_counts_nothing_on_the_cpu():
    """The wrapper refuses maps of two shapes, dtypes or ranks; a CPU call
    takes the plain version and launches no kernel."""
    f1, f2 = _maps((1, 4, 4, 16), torch.bfloat16)
    with pytest.raises(ValueError, match="one shape"):
        cp.corr_pyramids(f1, f2[:, :3])
    with pytest.raises(ValueError, match="one dtype"):
        cp.corr_pyramids(f1, f2.float())
    with pytest.raises(ValueError, match="one shape"):
        cp.corr_pyramids(f1[0], f2[0])
    before = profiling.counters().get("corr_pyramid", 0)
    cp.corr_pyramids(f1, f2)
    assert profiling.counters().get("corr_pyramid", 0) == before


# ------------------------------------------------------------ the kernel's schedule

BY, BX = 8, 16  # a position block: 8 grid rows x 16 grid columns
BP = BY * BX


def _pool(m):
    """One pooled level of [R, Hb, Wb] bf16 values, as the kernel's pool4."""
    s = m[:, 0::2] + m[:, 1::2]
    return s[:, :, 0::2] * 0.25 + s[:, :, 1::2] * 0.25


def tile_model(fmap1, fmap2, backward=True):
    """csrc/corr_pyramid.cu in PyTorch: a block a tile, in its order; the
    outputs start as NaN so that a value no tile writes shows."""
    n, h, w, c = fmap1.shape
    hw = h * w
    nbx, nby = -(-w // BX), -(-h // BY)
    dt = fmap1.dtype
    inv = cp.inv_sqrt(c)

    def levels():
        return [torch.full((n * hw, h >> lvl, w >> lvl), float("nan"), dtype=dt) for lvl in range(4)]

    fwd, bwd = levels(), (levels() if backward else None)
    dy, dx = torch.arange(BP) // BX, torch.arange(BP) % BX
    per_pair = nby * nby * nbx * nbx
    for blk in range(n * per_pair):
        pair, r = divmod(blk, per_pair)
        band, within = divmod(r, nbx * nbx)
        pband, qband = divmod(band, nby)
        pbx, qbx = divmod(within, nbx)
        py0, px0, qy0, qx0 = pband * BY, pbx * BX, qband * BY, qbx * BX

        def rows(fm, y0, x0):
            """The block's 128 rows, zero off the grid, which lie on it, their map rows."""
            ok = (y0 + dy < h) & (x0 + dx < w)
            a = torch.zeros(BP, c)
            a[ok] = fm[pair, (y0 + dy)[ok], (x0 + dx)[ok]].float()
            return a, ok, pair * hw + (y0 + dy) * w + x0 + dx

        a, pok, prow = rows(fmap1, py0, px0)
        b, qok, qrow = rows(fmap2, qy0, qx0)
        tile = ((a @ b.T) * inv).to(dt)  # [p, q]; integer-valued maps: exact in any order
        sides = [(fwd, tile, pok, prow, qy0, qx0)]
        if backward:
            sides.append((bwd, tile.T, qok, qrow, py0, px0))
        for out, t, ok, row, y0, x0 in sides:
            blocks = t[ok].reshape(-1, BY, BX)  # the rows on the grid, over the other block
            idx = row[ok]
            for lvl in range(4):
                hl, wl, s = h >> lvl, w >> lvl, 1 << lvl
                ny = max(0, min(BY // s, hl - y0 // s))  # cells whose whole 2^l block is on the grid
                nx = max(0, min(BX // s, wl - x0 // s))
                if ny and nx:
                    out[lvl][idx, y0 // s : y0 // s + ny, x0 // s : x0 // s + nx] = blocks[:, :ny, :nx]
                blocks = _pool(blocks)
    return fwd, bwd


@pytest.mark.parametrize("grid", list(GRIDS))
@pytest.mark.parametrize("backward", [True, False], ids=["both", "forward"])
def test_tile_model_is_the_plain_build(grid, backward):
    """The kernel's schedule writes every value of every level once, and
    with integer-valued maps the plain build's value bit for bit."""
    f1, f2 = _maps(GRIDS[grid], torch.bfloat16, seed=2, integer=True)
    got_f, got_b = tile_model(f1, f2, backward)
    want_f, want_b = cp.corr_pyramids_plain(f1, f2, backward)
    _equal(got_f, want_f)
    if backward:
        _equal(got_b, want_b)
    else:
        assert got_b is None and want_b is None


@pytest.mark.parametrize("hw", [(45, 80), (45, 96), (90, 160)], ids=["360p", "outpaint", "720p"])
def test_block_order_completes_bands(hw):
    """The cells' grids: tiles ordered by (band of P, band of Q) hold each
    (P block, Q block) pair once, and the first band pair every block of
    both bands, so the blocks in flight finish whole 8-row strips."""
    h, w = hw
    nbx, nby = -(-w // BX), -(-h // BY)
    seen = []
    for r in range(nby * nby * nbx * nbx):
        band, within = divmod(r, nbx * nbx)
        pband, qband = divmod(band, nby)
        pbx, qbx = divmod(within, nbx)
        seen.append((pband * nbx + pbx, qband * nbx + qbx))
    assert len(set(seen)) == len(seen) == (nby * nbx) ** 2
    first = seen[: nbx * nbx]
    assert {p for p, _ in first} == set(range(nbx)) and {q for _, q in first} == set(range(nbx))


def test_inv_sqrt_is_the_card_scale():
    """The kernel scales by 1 / sqrt(C) as a float32 quotient of float32
    values (what eager PyTorch on the card multiplies by for a division by
    a host scalar); exact where sqrt(C) is a power of two."""
    assert cp.inv_sqrt(256) == 0.0625 and cp.inv_sqrt(64) == 0.125
    c = 32
    want = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(math.sqrt(c), dtype=torch.float32)
    assert cp.inv_sqrt(c) == float(want)
