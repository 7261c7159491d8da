"""Spatial (H) parallelism of the feature stage's window forward.

Counterpart of the JAX package's `parallel/spatial.py`. There the frames'
height is sharded over the mesh's model axis and GSPMD adds every halo
exchange; torch has no partitioner, so each cross-row dependency of the
InpaintGenerator forward is written out (models/propainter.py and
ops/attention.py take a `Partition`):

  * encoder: every rank holds the whole input frames and encodes its rows
    with ENC_HALO4 feature rows (32 pixels) of input halo, trimmed after;
  * downsampled flows and masks, the attention pool mask: small, whole on
    every rank, sliced where a step needs rows;
  * feature propagation: each recurrent step all-gathers feat_prop over H
    (flows are unbounded: `flow_warp` and the deformable conv B2, with its
    output row origin `row0`, read any row of it); the offset net and the
    backbone run on the rank's rows with PROP_HALO4 rows of halo;
  * soft split / soft comp and the fusion FFN: the 7x7 stride-3 patches
    cross slab edges: `halo_rows` brings the feature or token rows each
    needs; the fold normaliser is the whole image's, at global rows;
  * window attention: queries, window keys, occupancy and t_sel are per
    window, so local; the rolled K/V (+-3 token rows, circular over the
    window-padded height) come from `halo_rows(..., circular=True)`; each
    rank pools the 4x4 pool rows that start in its rows (3 token rows of
    halo below) and the pooled tokens (1/16 of them) are all-gathered;
    B3/B4 run on the rank's windows by the JAX size estimate on its own
    inputs (a port-side choice: JAX takes XLA twins under its split);
  * decoder: `decode_rows`, the crop decoder's window at the rank's rows
    (DECODER_HALO4 feature rows of halo), full width or the node's crop.

Row partition: the token grid's window rows (5 token rows) split over the
ranks in contiguous runs, the first `n_wh % n` ranks one more than the
rest (ranks at the end take one fewer, or none: 2 window rows on 4 ranks
leave ranks 2 and 3 without rows; they still take part in every
collective). A window row is 5 token rows, 15 feature rows and 60 pixel
rows, so each rank's windows stay whole and every slab edge falls on a
multiple of 4 pixels, as the encoder's two stride-2 convs need. A grid's
rows past its height (the window padding of the token grid, pixel rows
past the frame) belong to the rank holding the last window row.

`halo_rows` moves each rank's halo rows point to point from the ranks
that hold them (`Mesh.send_recv`; a neighbour with fewer rows than the
halo, or none, is read past); at the true image edge a halo is empty
(the op's own padding applies), except in the circular form, which
wraps. `gather_rows` all-gathers every rank's rows (`Mesh.all_gather`).
Without a mesh, a `Partition` or `RowSplit` is one rank's whole grid
(halos from its own rows, the gather the identity): the ops keep one
body for the single process and the split.
"""

from __future__ import annotations

import functools
from contextlib import contextmanager

import torch
import torch.nn.functional as F

from .mesh import MODEL_AXIS, Mesh

WINDOW_ROWS = 5  # token rows of a (5, 9) attention window
TOKEN_ROWS = 3  # feature rows a token row (the soft split's stride)
FEATURE_ROWS = 4  # pixel rows a feature row
ENC_HALO4 = 8  # the encoder's reach in feature rows (9 3x3 convs, two of stride 2: 7.25)
PROP_HALO4 = 6  # a propagation step's: the offset net's 4 convs and the backbone's 2

# (mesh, axis) while the feature stage runs H-split; the generator
# (models/propainter.py) reads it, as it reads `sequence_active`
_ACTIVE: tuple[Mesh, str] | None = None


def spatial_active() -> tuple[Mesh, str] | None:
    """(mesh, axis) inside `spatial_sharding`, else None."""
    return _ACTIVE


@contextmanager
def spatial_sharding(mesh: Mesh, axis: str = MODEL_AXIS):
    """Run the generator forwards called inside H-split over `axis`: each
    rank's feature-grid tensors, in and out, are its rows of the grid
    (`Partition`), the flows and masks stay whole."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = (mesh, axis)
    try:
        yield
    finally:
        _ACTIVE = prev


def token_rows(h4: int) -> int:
    """Rows of the token grid over h4 feature rows (7x7, stride 3, pad 3)."""
    return (h4 - 1) // TOKEN_ROWS + 1


def window_row_cuts(fh: int, n: int) -> list[int]:
    """Rank r holds window rows [cuts[r], cuts[r + 1]) of a token grid of
    fh rows: ceil(fh / 5) window rows, the first n_wh % n ranks one more."""
    n_wh = -(-fh // WINDOW_ROWS)
    base, extra = divmod(n_wh, n)
    cuts = [0]
    for r in range(n):
        cuts.append(cuts[-1] + base + (r < extra))
    return cuts


class RowSplit:
    """One grid's rows over the axis: rank r holds rows bounds[r] = (lo,
    hi) of `total`; lo, hi are this rank's. With mesh None, one rank holds
    the whole grid: its halos stop at the edges (or wrap onto its own
    rows) and its gather is the identity, so the ops take one body with
    and without the split."""

    def __init__(self, mesh: Mesh | None, axis: str | None, bounds: list[tuple[int, int]], total: int):
        self.mesh, self.axis, self.bounds, self.total = mesh, axis, bounds, total
        self.me = 0 if mesh is None else mesh.index(axis)
        self.lo, self.hi = bounds[self.me]

    @classmethod
    def whole(cls, total: int) -> RowSplit:
        return cls(None, None, [(0, total)], total)

    @property
    def rows(self) -> int:
        return self.hi - self.lo

    def widened(self, halo: int) -> tuple[int, int]:
        """This rank's rows with `halo` rows each side, clamped to the grid
        (empty for a rank with no rows)."""
        if self.lo == self.hi:
            return self.lo, self.lo
        return max(0, self.lo - halo), min(self.total, self.hi + halo)

    def clipped(self, start: int, end: int) -> RowSplit:
        """The split of rows [start, end) of the grid, counted from start."""
        clip = [(min(max(lo, start), end) - start, min(max(hi, start), end) - start) for lo, hi in self.bounds]
        return RowSplit(self.mesh, self.axis, clip, end - start)

    def halo(self, x, above: int, below: int, h_dim: int, circular: bool = False):
        return halo_rows(x, above, below, h_dim, self, circular)

    def gather(self, x, h_dim: int):
        return gather_rows(x, h_dim, self)


class Partition:
    """The window-row partition of a token grid of fh rows over the mesh
    axis, and each grid's `RowSplit` under it; with mesh None, the whole
    grids of one rank."""

    def __init__(self, mesh: Mesh | None, axis: str | None, fh: int):
        self.mesh, self.axis, self.fh = mesh, axis, fh
        self.cuts = window_row_cuts(fh, 1 if mesh is None else mesh.shape[axis])

    @property
    def whole(self) -> bool:
        return len(self.cuts) == 2

    def _split(self, unit: int, total: int) -> RowSplit:
        c = self.cuts
        return RowSplit(self.mesh, self.axis, [(min(unit * a, total), min(unit * b, total)) for a, b in zip(c, c[1:])], total)

    def tokens(self) -> RowSplit:
        return self._split(WINDOW_ROWS, self.fh)

    def padded_tokens(self) -> RowSplit:
        """The token grid padded to whole windows (the attention's)."""
        return self._split(WINDOW_ROWS, WINDOW_ROWS * self.cuts[-1])

    def features(self, h4: int) -> RowSplit:
        return self._split(WINDOW_ROWS * TOKEN_ROWS, h4)

    def pixels(self, h: int) -> RowSplit:
        return self._split(WINDOW_ROWS * TOKEN_ROWS * FEATURE_ROWS, h)

    def pool_rows(self, p_h: int) -> RowSplit:
        """The 4x4 pooled grid's rows: each to the rank that holds its first
        token row."""
        c = self.cuts
        first = [min(-(-WINDOW_ROWS * a // 4), p_h) for a in c]
        return RowSplit(self.mesh, self.axis, list(zip(first, first[1:])), p_h)


@functools.lru_cache(maxsize=256)
def _halo_plan(bounds: tuple, total: int, above: int, below: int, circular: bool) -> tuple:
    """For each rank: the global rows its halo takes (those above its rows,
    then those below, in order), each as (owner rank, owner's local row)."""

    def owner(g: int) -> tuple[int, int]:
        for q, (lo, hi) in enumerate(bounds):
            if lo <= g < hi:
                return q, g - lo
        raise ValueError(f"halo_rows: row {g} belongs to no rank of {list(bounds)}")

    plan = []
    for lo, hi in bounds:
        top = [g % total if circular else g for g in range(lo - above, lo) if circular or g >= 0]
        bottom = [g % total if circular else g for g in range(hi, hi + below) if circular or g < total]
        plan.append((tuple(owner(g) for g in top), tuple(owner(g) for g in bottom)))
    return tuple(plan)


def _runs(src, idx, h_dim: int) -> list:
    """The rows idx of src along h_dim as the narrows of their runs."""
    runs = []
    for i in idx:
        if runs and i == runs[-1][0] + runs[-1][1]:
            runs[-1][1] += 1
        else:
            runs.append([i, 1])
    return [src.narrow(h_dim, a, n) for a, n in runs]


def halo_rows(x: torch.Tensor, above: int, below: int, h_dim: int, rows: RowSplit, circular: bool = False):
    """x (this rank's rows of `rows`, along h_dim) with the `above` rows
    before them and the `below` rows after them, and the global row of its
    first row. At the grid's edges the halo stops (fewer rows: the op's
    own padding applies there), or with circular=True wraps around the
    grid. The rows come from the ranks that hold them, a neighbour with
    fewer rows than the halo, or none, read past: one `Mesh.send_recv`
    of the rows each pair of ranks needs. Every rank of the axis must
    call it."""
    plan = _halo_plan(tuple(rows.bounds), rows.total, above, below, circular)
    me = rows.me
    top, bottom = plan[me]
    sends = {}
    for q, (q_top, q_bottom) in enumerate(plan):
        mine = [l for o, l in q_top + q_bottom if o == me]
        if q != me and mine:
            sends[q] = torch.cat(_runs(x, mine, h_dim), dim=h_dim)
    need = {}
    for o, _ in top + bottom:
        if o != me:
            need[o] = need.get(o, 0) + 1
    got = rows.mesh.send_recv(sends, {q: (h_dim, n) for q, n in need.items()}, rows.axis, x) if sends or need else {}
    if not top and not bottom:
        return x, rows.lo
    taken = dict.fromkeys(got, 0)

    def assembled(part):  # the halo's rows in order: runs of x or of a received block
        srcs, idx = [], []
        for o, l in part:
            if o != me:
                l, taken[o] = taken[o], taken[o] + 1
            srcs.append(o)
            idx.append(l)
        pieces, i = [], 0
        while i < len(srcs):
            j = i
            while j < len(srcs) and srcs[j] == srcs[i]:
                j += 1
            pieces += _runs(x if srcs[i] == me else got[srcs[i]], idx[i:j], h_dim)
            i = j
        return pieces

    ext = torch.cat(assembled(top) + [x] + assembled(bottom), dim=h_dim)
    return ext, rows.lo - len(top)


def gather_rows(x: torch.Tensor, h_dim: int, rows: RowSplit) -> torch.Tensor:
    """Every rank's rows of `rows` (x: this rank's, along h_dim) in order:
    the whole grid, on every rank. One all_gather, each rank's rows padded
    to the most any rank holds."""
    if rows.mesh is None:
        return x
    most = max(hi - lo for lo, hi in rows.bounds)
    pad = [0, 0] * (x.dim() - 1 - h_dim) + [0, most - x.shape[h_dim]]
    every = rows.mesh.all_gather(F.pad(x, pad), rows.axis, dim=h_dim)
    parts = [every.narrow(h_dim, q * most, hi - lo) for q, (lo, hi) in enumerate(rows.bounds)]
    return torch.cat(parts, dim=h_dim)


def spatial_parallel_window_predict(params: dict, mesh: Mesh, num_local_frames: int, axis: str = MODEL_AXIS):
    """The InpaintGenerator forward H-split over `axis` (the JAX function's
    counterpart): fn(frames, flows_f, flows_b, masks_in, masks_updated),
    each whole on every rank, -> the predicted local frames [B, l_t, H,
    W, 3], whole on every rank (the ranks' rows gathered)."""
    from ..models import propainter as pp  # the generator imports this module

    def run(frames, ff, fb, m_in, m_upd):
        with spatial_sharding(mesh, axis):
            mine = pp.inpaint_generator_forward(params, frames, ff, fb, m_in, m_upd, num_local_frames)
        h = frames.shape[2]
        return Partition(mesh, axis, token_rows(h // FEATURE_ROWS)).pixels(h).gather(mine, 2)

    return run
