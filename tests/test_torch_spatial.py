"""The spatial H split (`parallel/spatial.py`) on the CPU: ranks are
processes of their own over gloo (tests/torch_parallel_ranks.py), each
holding the whole output.

- the row partition, for 2-4 ranks over token grids of 7-90 rows;
- `halo_rows` (plain and circular) and `gather_rows` on 3 ranks, and on
  one rank's whole grid (no mesh);
- the split generator forward on 4 and 2 model ranks against the
  single-process port in float64 at atol = rtol = 1e-9, as the JAX
  package pins its own split (tests/test_spatial.py, whose case is the
  first here); measured: at most 1.4e-15;
- (the single-process port against the JAX `inpaint_generator_forward`
  in float64 at that case is in tests/test_torch_generator.py);
- `Pipeline` on mesh (1, 2) at 512 rows (fp32, one RAFT iteration, 48
  columns, the mask box across the ranks' edge at row 300), with and
  without a crop decoded alone, and on (2, 2): each rank within one
  uint8 level of the single-process port and of the JAX `Pipeline` on
  its virtual mesh (measured: the port's bytes exactly);
- B2's row origin: the plain version at rows [row0, row0 + Ho) against
  the same rows of the whole image's (the card test is in
  tests/test_torch_cuda.py)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_propainter_nodes_tpu.config import PipelineConfig as JaxConfig
from comfyui_propainter_nodes_tpu.parallel import mesh as jmesh
from comfyui_propainter_nodes_tpu.pipeline.stages import Pipeline as JaxPipeline
from comfyui_propainter_nodes_tpu.utils import weights as jax_weights
from comfyui_propainter_nodes_tpu_torch.config import PipelineConfig
from comfyui_propainter_nodes_tpu_torch.models.propainter import inpaint_generator_forward
from comfyui_propainter_nodes_tpu_torch.ops.cuda.deform_conv import deform_conv2d_plain
from comfyui_propainter_nodes_tpu_torch.parallel import spatial
from comfyui_propainter_nodes_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh
from comfyui_propainter_nodes_tpu_torch.pipeline.stages import Pipeline
from comfyui_propainter_nodes_tpu_torch.utils import weights
from torch_parallel_ranks import Ranks, halo_program, make_inputs, pipeline_program, spatial_program

torch.set_num_threads(1)

MODELS = ("raft", "flow_completion", "inpaint_generator")


# ------------------------------------------------------------ the partition


@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("fh", [7, 15, 20, 30, 60, 90])
def test_row_partition_covers_every_row_once_in_whole_windows(n, fh):
    h4 = 3 * fh - 1  # a feature grid with fh token rows
    parts = [spatial.Partition(Mesh((1, n), r, "cpu"), MODEL_AXIS, fh) for r in range(n)]
    assert spatial.token_rows(h4) == fh
    n_wh = -(-fh // 5)
    for grid, total in (
        (lambda q: q.tokens(), fh), (lambda q: q.padded_tokens(), 5 * n_wh), (lambda q: q.features(h4), h4),
        (lambda q: q.pixels(4 * h4), 4 * h4), (lambda q: q.pool_rows(5 * n_wh // 4), 5 * n_wh // 4),
    ):
        splits = [grid(q) for q in parts]
        assert all(s.bounds == splits[0].bounds and s.total == total for s in splits)
        assert [(s.lo, s.hi) for s in splits] == splits[0].bounds  # each rank's own
        # contiguous, in rank order, each row once
        edges = [b for lo_hi in splits[0].bounds for b in lo_hi]
        assert edges[0] == 0 and edges[-1] == total and edges == sorted(edges)
        assert all(splits[0].bounds[r][1] == splits[0].bounds[r + 1][0] for r in range(n - 1))
    cuts = parts[0].cuts
    counts = [b - a for a, b in zip(cuts, cuts[1:])]
    assert sum(counts) == n_wh and max(counts) - min(counts) <= 1 and counts == sorted(counts, reverse=True)
    for r, q in enumerate(parts):
        tok, pad = q.tokens(), q.padded_tokens()
        # whole windows: a rank's padded rows are 5 a window row, its token
        # rows start on a window edge, pixel edges on multiples of 4
        assert pad.lo % 5 == 0 and pad.rows % 5 == 0 and tok.lo == min(pad.lo, fh)
        assert q.features(h4).lo == min(3 * pad.lo, h4) and q.pixels(4 * h4).lo % 4 == 0
        assert (pad.rows == 0) == (r >= n_wh)  # the empty ranks are the last ones


# ------------------------------------------------------------ halo exchange


@pytest.mark.parametrize("bounds", [[(0, 7), (7, 9), (9, 17)], [(0, 10), (10, 17), (17, 17)]])
def test_halo_rows_and_gather_on_3_ranks(tmp_path, bounds):
    """A middle rank with fewer rows than the halo (read past to its
    neighbour), or an empty last rank; plain halos stop at the edges,
    circular ones wrap."""
    x = torch.arange(2 * 17 * 3, dtype=torch.float32).reshape(2, 17, 3)
    cases = [(3, 1, False), (2, 2, False), (0, 3, False), (3, 3, True), (1, 4, True)]
    results = Ranks(halo_program, 3, tmp_path, x, bounds, cases).join()
    for (lo, hi), got in zip(bounds, results):
        for (above, below, circular), (ext, start) in zip(cases, got):
            if circular:
                rows, first = [g % 17 for g in range(lo - above, hi + below)], lo - above
            else:
                first = max(0, lo - above)
                rows = list(range(first, min(17, hi + below)))
            assert start == first
            torch.testing.assert_close(ext, x[:, rows], rtol=0, atol=0)
        torch.testing.assert_close(got[-1], x, rtol=0, atol=0)


@pytest.mark.parametrize("above,below,circular", [(3, 1, False), (3, 3, True), (1, 4, True)])
def test_halo_rows_of_one_rank_whole_grid(above, below, circular):
    """Without a mesh (the single process's form of the ops): plain halos
    are empty, circular ones wrap onto the rank's own rows, the gather is
    x itself."""
    x = torch.arange(2 * 17 * 3, dtype=torch.float32).reshape(2, 17, 3)
    rows = spatial.RowSplit.whole(17)
    ext, start = rows.halo(x, above, below, 1, circular)
    if circular:
        assert start == -above
        torch.testing.assert_close(ext, x[:, [g % 17 for g in range(-above, 17 + below)]], rtol=0, atol=0)
    else:
        assert start == 0 and ext is x
    assert rows.gather(x, 1) is x


# ------------------------------------------------------- the split forward


def forward_inputs(h: int, w: int, dtype):
    """tests/test_spatial.py's case: b 1, l_t 4, 2 reference frames, seed 0."""
    b, l_t, n_ref = 1, 4, 2
    rng = np.random.default_rng(0)
    frames = rng.uniform(-1, 1, (b, l_t + n_ref, h, w, 3))
    masks = (rng.uniform(size=(b, l_t + n_ref, h, w, 1)) > 0.85).astype(np.float64)
    flows = rng.standard_normal((b, l_t - 1, h, w, 2)) * 2
    return tuple(a.astype(dtype) for a in (frames * (1 - masks), flows, flows, masks, masks)), l_t


@pytest.mark.parametrize(
    "h,w,n,attn", [(80, 96, 4, "segmented"), (240, 48, 4, "segmented"), (160, 48, 2, "segmented"), (160, 48, 2, "halo")]
)
def test_split_forward_equals_single_process(tmp_path, monkeypatch, h, w, n, attn):
    """JAX's case (7 token rows: 2 window rows on 4 ranks, two ranks
    empty), every rank one window row (240 rows), and 3 window rows on 2
    ranks (160), also with the attention's halo form
    (PROPAINTER_TPU_ATTN=halo, its circular K/V rows from the
    neighbours): every rank's gathered output is the single-process
    port's within 1e-9 in float64."""
    params = {k: v.double() for k, v in weights.get_params("inpaint_generator", allow_random=True).items()}
    arrays, l_t = forward_inputs(h, w, np.float64)
    args = tuple(torch.from_numpy(a) for a in arrays)
    ranks = Ranks(spatial_program, n, tmp_path, params, args, l_t, {"PROPAINTER_TPU_ATTN": attn})
    monkeypatch.setenv("PROPAINTER_TPU_ATTN", attn)
    base = inpaint_generator_forward(params, *args, l_t)
    for out in ranks.join():
        assert out.shape == base.shape == (1, l_t, h, w, 3)
        torch.testing.assert_close(out, base, atol=1e-9, rtol=1e-9)


# ------------------------------------------------------------ the pipeline

T, H, W = 8, 512, 48
BOX = (276, 324, 8, 40)  # across the ranks' edge at pixel row 300
CROP = (256, 16, 96, 16)  # ch + 32 <= H and cw + 32 <= W: decoded alone
WIDGETS = dict(ref_stride=4, neighbor_length=4, subvideo_length=80, raft_iter=1, fp16="disable")
ENV = {"PROPAINTER_TPU_WINDOW_BATCH": "4"}


@pytest.fixture(scope="module")
def jax_512():
    """The JAX `Pipeline` at 512 rows on its virtual mesh of n devices, 2
    on the model axis: its spatial H split; by n, computed once."""
    done = {}

    def run(n: int):
        if n in done:
            return done[n]
        old = os.environ.get("PROPAINTER_TPU_WINDOW_BATCH")
        os.environ.update(ENV)
        os.environ.pop("PROPAINTER_TPU_SEQ", None)
        try:
            params = [jax_weights.get_params(m, allow_random=True) for m in MODELS]
            frames, masks, orig = (jnp.asarray(a) for a in make_inputs(3, T, H, W, BOX))
            mesh = jmesh.make_mesh(n, model_parallel=2)
            pipe = JaxPipeline(*params, JaxConfig(**WIDGETS, process_size=(W, H)), mesh=mesh)
            assert not pipe._seq_selected(H)
            done[n] = np.asarray(pipe.process(frames, masks, masks, orig))
            return done[n]
        finally:
            os.environ.pop("PROPAINTER_TPU_WINDOW_BATCH")
            if old is not None:
                os.environ["PROPAINTER_TPU_WINDOW_BATCH"] = old

    return run


# mesh (1, 2), with and without a crop; (2, 2): the data ranks' windows
# gathered while the two model ranks hold 300 and 212 rows
@pytest.mark.parametrize("shape,crop", [((1, 2), None), ((1, 2), CROP), ((2, 2), None)])
def test_pipeline_h_split_at_512_rows(tmp_path, monkeypatch, jax_512, shape, crop):
    monkeypatch.delenv("PROPAINTER_TPU_SEQ", raising=False)
    monkeypatch.delenv("PROPAINTER_TPU_CLIP_PARALLEL", raising=False)
    n = shape[0] * shape[1]
    ranks = Ranks(pipeline_program, n, tmp_path, shape[1], ENV, WIDGETS, 3, T, H, W, BOX, crop)
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)
    params = [weights.get_params(m, allow_random=True) for m in MODELS]
    frames, masks, orig = (torch.from_numpy(a) for a in make_inputs(3, T, H, W, BOX))
    single = Pipeline(*params, PipelineConfig(**WIDGETS, process_size=(W, H)), device="cpu")
    single = single.process(frames, masks, masks, orig, crop).numpy()
    jax_ref = jax_512(n)
    if crop is not None:
        jax_ref = jax_ref[:, crop[0] : crop[0] + crop[2], crop[1] : crop[1] + crop[3]]
    results = ranks.join()
    for res in results:
        assert res["shape"] == {"data": shape[0], "model": shape[1]} and not res["seq"]
        assert res["clip_parallel"] == (shape[0] > 1)  # data ranks split stages 1-3's chunks
        out = res["out"].numpy()
        assert out.shape == single.shape
        for ref in (single, jax_ref):
            assert np.abs(out - ref).max() <= 1.0
    for res in results[1:]:
        np.testing.assert_array_equal(res["out"].numpy(), results[0]["out"].numpy())


# ---------------------------------------------------------- B2's row origin


@pytest.mark.parametrize("dt", [torch.float32, torch.float64])
@pytest.mark.parametrize("row0,ho", [(0, 5), (4, 7), (9, 6)])
def test_deform_conv_plain_row_origin(dt, row0, ho):
    """Output rows [row0, row0 + ho) of a 15-row image from their own
    offsets and mask equal those rows of the whole image's output."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 15, 11, 32, generator=g).to(dt)
    off = (torch.randn(2, 15, 11, 4, 9, 2, generator=g) * 4).to(dt)
    mask = torch.rand(2, 15, 11, 4, 9, generator=g).to(dt)
    w = (torch.randn(24, 32, 3, 3, generator=g) * 0.1).to(dt)
    bias = torch.randn(24, generator=g).to(dt)
    rows = slice(row0, row0 + ho)
    whole = deform_conv2d_plain(x, off, mask, w, bias)
    part = deform_conv2d_plain(x, off[:, rows], mask[:, rows], w, bias, row0=row0)
    assert part.shape == (2, ho, 11, 24) and part.dtype == dt
    torch.testing.assert_close(part, whole[:, rows], atol=1e-6 if dt == torch.float32 else 1e-12, rtol=1e-6)
