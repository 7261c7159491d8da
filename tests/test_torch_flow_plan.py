"""RAFT in the port's `Pipeline.compute_flow` and streaming driver against
the JAX package's stage plan: every RAFT call takes the lookup (the
blend of B1, or B6's padded form) that the JAX stage takes for the same
clip, whichever form the port runs; the forms themselves (one call,
chunks, a pair a call, a pair a call with the directions in turn) give
the same flows; `raft_forward` and `raft_bi_forward_seqdir` are the JAX
functions; streaming above 640x480 makes the JAX driver's 24-pair
`compute_flow` calls.

The JAX choice is traced: `jax.eval_shape` of the JAX stage's
`_flow_fn` with abstract inputs, its pyramid builders replaced by probes
that name the branch and the call's pair count (Pallas enabled, as on a
TPU). Flows are compared in fp32 on the CPU: 1e-4 of the largest flow
against the JAX package (tests/test_torch_models.py's tolerance), atol
1e-4 px between the port's forms (the same arithmetic on other batches)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from comfyui_propainter_nodes_tpu.config import PipelineConfig as JaxConfig
from comfyui_propainter_nodes_tpu.models import raft as jraft
from comfyui_propainter_nodes_tpu.ops import deform_conv as jdc
from comfyui_propainter_nodes_tpu.ops.pallas import corr_lanes as jlanes
from comfyui_propainter_nodes_tpu.pipeline import stages as jstages
from comfyui_propainter_nodes_tpu.pipeline import streaming as jstreaming
from comfyui_propainter_nodes_tpu.utils.weights import random_params
from comfyui_propainter_nodes_tpu_torch.config import PipelineConfig
from comfyui_propainter_nodes_tpu_torch.models import raft as traft
from comfyui_propainter_nodes_tpu_torch.pipeline import stages
from comfyui_propainter_nodes_tpu_torch.pipeline import streaming
from comfyui_propainter_nodes_tpu_torch.utils.params import from_jax_params
from test_torch_streaming import ShapesOnly, moving_box_clip, stream

torch.set_num_threads(1)

VARS = ("PROPAINTER_TPU_CORR_KERNEL", "PROPAINTER_TPU_LANES_BUDGET", "PROPAINTER_TPU_LANES_WMAX",
        "PROPAINTER_TPU_RAFT_ALLPAIRS_BYTES", "PROPAINTER_TPU_RAFT_SEQDIR_BYTES", "PROPAINTER_TPU_CLIP_PARALLEL")


class _Chose(Exception):
    pass


def _probe(name):
    def f(f1, f2, pad=None):
        branch = name if pad is None else ("pallas" if pad else "map")
        raise _Chose((branch, f1.shape[0]))

    return f


@pytest.fixture(scope="module")
def raft_shapes():
    return {k: v.shape for k, v in random_params("raft", seed=1).items()}


def jax_stage_branch(monkeypatch, shapes, cfg: JaxConfig, t: int, hw):
    """(lookup, pairs) of the first RAFT call of the JAX stage's
    `_flow_fn(t, hw)` on a TPU, traced with abstract inputs."""
    monkeypatch.setattr(jdc, "_USE_PALLAS", True)
    monkeypatch.setattr(jlanes, "build_corr_pyramids_lanes", _probe("lanes"))
    monkeypatch.setattr(jraft, "build_corr_pyramid_bi", _probe(None))
    monkeypatch.setattr(jraft, "build_corr_pyramid", _probe(None))
    stage = types.SimpleNamespace(config=cfg, _clip_parallel=lambda: False)
    fn = jstages.Pipeline._flow_fn(stage, t, hw)
    dt = jnp.bfloat16 if cfg.raft_half else jnp.float32
    spec = {k: jax.ShapeDtypeStruct(s, dt) for k, s in shapes.items()}
    frames = jax.ShapeDtypeStruct((1, t) + tuple(hw) + (3,), jnp.float32)
    with pytest.raises(_Chose) as chose:
        jax.eval_shape(fn, spec, frames)
    return chose.value.args[0]


# (t, H, W): a portrait phone clip where the JAX stage runs a pair a call
# (13 and 25 frames at 640x1136: lanes in bf16, where one port chunk of 11
# pairs took the map blend); 720x480, where JAX's streaming sub-range fits
# the all-pairs budget (one call of 24 pairs: map) and the whole chunk runs
# chunk by chunk (8 pairs: lanes); the paths' sizes
CLIPS = [(13, 1136, 640), (25, 1136, 640), (25, 480, 720), (86, 480, 720),
         (24, 360, 640), (24, 720, 1280), (25, 1080, 1920), (86, 360, 640)]
ENVS = {
    "default": {},
    "budgets lowered": {"PROPAINTER_TPU_RAFT_ALLPAIRS_BYTES": "3e8", "PROPAINTER_TPU_RAFT_SEQDIR_BYTES": "1e8"},
    "corr switch": {"PROPAINTER_TPU_CORR_KERNEL": "pallas"},
}
EXPECTED_BF16 = {(13, 1136, 640): "lanes", (25, 1136, 640): "lanes", (25, 480, 720): "map", (86, 480, 720): "lanes",
                 (24, 360, 640): "lanes", (24, 720, 1280): "map", (25, 1080, 1920): "map", (86, 360, 640): "lanes"}


@pytest.mark.parametrize("env", list(ENVS))
@pytest.mark.parametrize("fp16", ["enable", "disable"])
@pytest.mark.parametrize("t,h,w", CLIPS)
def test_jax_flow_lookup_is_the_jax_stage_branch(monkeypatch, raft_shapes, env, fp16, t, h, w):
    for k in VARS:
        monkeypatch.delenv(k, raising=False)
    for k, v in ENVS[env].items():
        monkeypatch.setenv(k, v)
    widgets = dict(fp16=fp16, raft_iter=1, process_size=(w, h))
    branch, pairs = jax_stage_branch(monkeypatch, raft_shapes, JaxConfig(**widgets), t, (h, w))
    assert stages.jax_flow_lookup(PipelineConfig(**widgets), t, (h, w)) == branch
    if env == "default" and fp16 == "enable":
        assert branch == EXPECTED_BF16[(t, h, w)], (branch, pairs)


def test_portrait_clip_diverged_before(monkeypatch, raft_shapes):
    """13 frames at 640x1136 in bf16: the JAX stage runs a pair a call
    (lanes); the dispatcher alone, given the port's first chunk of 11
    pairs, picks the map blend."""
    for k in VARS:
        monkeypatch.delenv(k, raising=False)
    cfg = JaxConfig(raft_iter=1, process_size=(640, 1136))
    assert jax_stage_branch(monkeypatch, raft_shapes, cfg, 13, (1136, 640)) == ("lanes", 1)
    assert traft.lookup_mode(11, 142, 80, torch.bfloat16) == "map"


# ------------------------------------------------ the blends RAFT is handed


def _recording(monkeypatch, seen):
    """Stand-ins for RAFT's two bidirectional forms: zero flows of the right
    shape; each call records (pairs, the lookup it would take)."""

    def stand_in(params, frames, iters=20, blend=None):
        b, t, h, w, _ = frames.shape
        mode = blend if blend is not None else traft.lookup_mode(b * (t - 1), h // 8, w // 8, torch.bfloat16)
        seen.append((t - 1, mode))
        z = torch.zeros(()).expand(b, t - 1, h, w, 2)
        return z, z

    monkeypatch.setattr(traft, "raft_bi_forward", stand_in)
    monkeypatch.setattr(traft, "raft_bi_forward_seqdir", stand_in)


@pytest.mark.parametrize("t,h,w", [(13, 1136, 640), (86, 480, 720), (25, 1080, 1920), (24, 360, 640)])
def test_compute_flow_hands_every_call_the_jax_blend(monkeypatch, t, h, w):
    for k in VARS:
        monkeypatch.delenv(k, raising=False)
    seen = []
    _recording(monkeypatch, seen)
    cfg = PipelineConfig(process_size=(w, h))
    pipe = stages.Pipeline({"fnet.conv1.weight": torch.zeros(1)}, {}, {}, cfg, device="cpu")
    ff, fb = pipe.compute_flow(torch.zeros(()).expand(1, t, h, w, 3))
    assert ff.shape == fb.shape == (1, t - 1, h, w, 2)
    assert sum(n for n, _ in seen) == t - 1
    assert {m for _, m in seen} == {EXPECTED_BF16.get((t, h, w), stages.jax_flow_lookup(cfg, t, (h, w)))}


class Recording(ShapesOnly):
    """The shapes-only pipeline, recording the frame count of every
    `compute_flow` call."""

    def __init__(self, config):
        super().__init__(config)
        self.flow_calls = []

    def compute_flow(self, frames):
        self.flow_calls.append(frames.shape[1])
        return super().compute_flow(frames)


def test_streaming_makes_the_jax_drivers_flow_calls(monkeypatch):
    """40 frames at 720x480, subvideo_length 30 (completion chunks of pairs
    0-35 and 25-39): above 640x480 RAFT runs in sub-ranges of 24 pairs,
    each its own compute_flow call (25, 12 and 15 frames), as the JAX
    driver's `_flows_range` calls it; a 25-frame call at 720x480 takes
    the JAX stage's one-call lookup (24 pairs: the map blend in bf16),
    the whole 36-frame chunk would take its chunk-by-chunk one (lanes)."""
    monkeypatch.delenv("PROPAINTER_TPU_STREAM_FLOW_PAIRS", raising=False)
    t, h, w = 40, 480, 720
    cfg = PipelineConfig(subvideo_length=30, raft_iter=1, process_size=(w, h))
    frames, masks = moving_box_clip(t, h, w)
    pipe = Recording(cfg)
    stream(pipe, frames, masks)
    expected = []
    step = streaming.stream_flow_pairs()
    for s_f, e_f, _, _ in stages.complete_chunk_plan(cfg, t - 1):
        expected += [min(e_f, a + step) - a + 1 for a in range(s_f, e_f, step)]
    assert pipe.flow_calls == expected == [25, 12, 15]
    assert stages.jax_flow_lookup(cfg, 25, (h, w)) == "map"
    assert stages.jax_flow_lookup(cfg, 36, (h, w)) == "lanes"


class JaxRecording:
    """A stand-in for the JAX package's `Pipeline` in its streaming driver,
    keeping only the shapes (zero flows, completion and image propagation
    returning their inputs, a window returning the tail under it) and
    recording the frame count of every `compute_flow` call."""

    def __init__(self, config: JaxConfig):
        self.config, self.cdtype, self.flow_calls = config, jnp.float32, []
        self.raft_params, self.inpaint_params = {"fnet.conv1.weight": jnp.zeros(1)}, {}

    def compute_flow(self, frames):
        self.flow_calls.append(frames.shape[1])
        z = jnp.zeros(frames.shape[:1] + (frames.shape[1] - 1,) + frames.shape[2:4] + (2,), jnp.float32)
        return z, z

    def complete_flow_chunk(self, ff, fb, mk, n, t_static):
        return ff, fb

    def image_prop_chunk(self, fr, mk, ff, fb, n, t_static):
        return fr, mk

    def feature_window_fn(self, l_t_max, ref_max, hw):
        return lambda prm, uf, sm, su, ff, fb, old, orig, blend, l_t, n_ref: old

    def _report(self, *args):
        pass


@pytest.mark.parametrize("pairs", [12, 30])
def test_streaming_reads_the_flow_pairs_variable(monkeypatch, pairs):
    """PROPAINTER_TPU_STREAM_FLOW_PAIRS at 12 and 30: the port's streaming
    driver makes the JAX driver's compute_flow calls (frames a call, in
    order) on the clip of the test above, both reading the variable."""
    monkeypatch.setenv("PROPAINTER_TPU_STREAM_FLOW_PAIRS", str(pairs))
    t, h, w = 40, 480, 720
    frames, masks = moving_box_clip(t, h, w)
    pipe = Recording(PipelineConfig(subvideo_length=30, raft_iter=1, process_size=(w, h)))
    stream(pipe, frames, masks)
    jpipe = JaxRecording(JaxConfig(subvideo_length=30, raft_iter=1, process_size=(w, h)))
    jstreaming.process_streaming(
        jpipe, lambda s, c: frames[s : s + c], lambda s, c: masks[s : s + c], t, lambda s, a: None, 4, 4
    )
    assert pipe.flow_calls == jpipe.flow_calls
    assert max(pipe.flow_calls) == pairs + 1 and pipe.flow_calls != [25, 12, 15]


def test_streaming_at_640x480_makes_one_call_a_chunk():
    """At 640x480 and below a completion chunk's pairs are one call."""
    t, h, w = 20, 32, 48
    cfg = PipelineConfig(subvideo_length=8, raft_iter=1, process_size=(w, h))
    frames, masks = moving_box_clip(t, h, w)
    pipe = Recording(cfg)
    stream(pipe, frames, masks)
    assert pipe.flow_calls == [e - s + 1 for s, e, _, _ in stages.complete_chunk_plan(cfg, t - 1)]


# ------------------------------------------------------------- RAFT forms


@pytest.fixture(scope="module")
def raft_pair():
    raw = random_params("raft", seed=1)
    frames = np.random.default_rng(13).uniform(-1, 1, (1, 2, 64, 96, 3)).astype(np.float32)
    return {k: jnp.asarray(v) for k, v in raw.items()}, from_jax_params(raw), frames


def close_jax(out, ref, rel=1e-4):
    out, ref = out.detach().numpy(), np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(out - ref).max()) <= rel * scale


def close_port(out, ref, atol=1e-4):
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(), rtol=0, atol=atol)


def test_raft_forward_and_seqdir(raft_pair, monkeypatch):
    """A 2-frame 64x96 clip, 2 iterations: `raft_forward` and
    `raft_bi_forward_seqdir` against the JAX functions (on the CPU they
    take `lookup_corr`: the map blend) and against `raft_bi_forward`
    with the map blend."""
    monkeypatch.delenv("PROPAINTER_TPU_CORR_KERNEL", raising=False)
    pj, pt, frames = raft_pair
    x = torch.from_numpy(frames)
    both = traft.raft_bi_forward(pt, x, 2, "map")
    seq = traft.raft_bi_forward_seqdir(pt, x, 2)
    fwd = traft.raft_forward(pt, x[:, 0], x[:, 1], 2)
    close_port(fwd, seq[0][:, 0], atol=1e-5)
    close_jax(fwd, jraft.raft_forward(pj, jnp.asarray(frames[:, 0]), jnp.asarray(frames[:, 1]), iters=2))
    for o, u, r in zip(seq, both, jraft.raft_bi_forward_seqdir(pj, jnp.asarray(frames), iters=2)):
        close_port(o, u)
        close_jax(o, r)


def test_raft_forward_under_the_corr_switch(raft_pair, monkeypatch):
    """PROPAINTER_TPU_CORR_KERNEL=pallas: one direction on the padded
    pyramid (B6's plain version), against the map lookup and JAX's
    padded `raft_forward`."""
    monkeypatch.setenv("PROPAINTER_TPU_CORR_KERNEL", "pallas")
    pj, pt, frames = raft_pair
    x = torch.from_numpy(frames)
    assert traft.forward_lookup_mode() == "pallas"
    out = traft.raft_forward(pt, x[:, 1], x[:, 0], 2)
    close_port(out, traft.raft_forward(pt, x[:, 1], x[:, 0], 2, "map"))
    close_jax(out, jraft.raft_forward(pj, jnp.asarray(frames[:, 1]), jnp.asarray(frames[:, 0]), iters=2))


@pytest.mark.parametrize(
    "budget, form, calls",
    [(1e12, "one call", [3]), (2e5, "per pair", [1, 1, 1]), (5e4, "per pair, directions in turn", [1, 1, 1])],
)
def test_compute_flow_forms(raft_pair, monkeypatch, budget, form, calls):
    """4 frames at 64x96, 2 iterations, RAFT_CALL_BYTES lowered (one call
    of 3 pairs holds 294,912 bytes, one pair 98,304): a pair a call, then
    a pair a call with the directions in turn, against the one-call form;
    every call takes the lookup `jax_flow_lookup` names."""
    monkeypatch.delenv("PROPAINTER_TPU_CORR_KERNEL", raising=False)
    _, pt, _ = raft_pair
    frames = torch.from_numpy(np.random.default_rng(14).uniform(-1, 1, (1, 4, 64, 96, 3)).astype(np.float32))
    cfg = PipelineConfig(fp16="disable", raft_iter=2, process_size=(96, 64))
    pipe = stages.Pipeline(pt, {}, {}, cfg, device="cpu")
    whole = pipe.compute_flow(frames)
    seen = []
    for name in ("raft_bi_forward", "raft_bi_forward_seqdir"):
        fn = getattr(traft, name)
        monkeypatch.setattr(traft, name, lambda p, f, it, blend, fn=fn: seen.append((f.shape[1] - 1, blend)) or fn(p, f, it, blend))
    monkeypatch.setattr(stages, "RAFT_CALL_BYTES", budget)
    assert stages.raft_form(cfg, 4, (64, 96)) == form
    out = pipe.compute_flow(frames)
    assert seen == [(n, stages.jax_flow_lookup(cfg, 4, (64, 96))) for n in calls]
    for o, u in zip(out, whole):
        close_port(o, u)


def test_call_bytes_counts_the_product_and_both_pyramids():
    """One pair at 1920x1080 in bf16: the fp32 product and its bf16 cast
    (6 bytes a value, 5.87 GiB) outweigh both directions' pyramids (5.33
    bytes a value); in fp32 the pyramids (10.67) outweigh the product."""
    v = (135 * 240) ** 2
    assert traft.call_bytes(1, 135, 240, 2, "map") == 6 * v
    assert traft.call_bytes(1, 135, 240, 4, "map") == pytest.approx(32 / 3 * v)
    assert traft.call_bytes(2, 135, 240, 2, "lanes") == 12 * v
    assert traft.call_bytes(1, 135, 240, 2, "map", directions=1) == 6 * v
    assert traft.call_bytes(1, 135, 240, 2, "pallas") > traft.call_bytes(1, 135, 240, 2, "map")


def jax_clip_parallel_branch(monkeypatch, shapes, cfg: JaxConfig, t: int, hw, dp: int):
    """(lookup, pairs) of the RAFT call of the JAX stage's clip-parallel
    `_flow_fn(t, hw)`: with dp = 1 under PROPAINTER_TPU_CLIP_PARALLEL=1
    and no mesh, else on a dp-device mesh (the branch is on by default),
    traced with abstract inputs; inside shard_map the probe sees one
    device's share."""
    from comfyui_propainter_nodes_tpu.parallel.mesh import make_mesh

    monkeypatch.setattr(jdc, "_USE_PALLAS", True)
    monkeypatch.setattr(jlanes, "build_corr_pyramids_lanes", _probe("lanes"))
    monkeypatch.setattr(jraft, "build_corr_pyramid_bi", _probe(None))
    monkeypatch.setattr(jraft, "build_corr_pyramid", _probe(None))
    if dp == 1:
        monkeypatch.setenv("PROPAINTER_TPU_CLIP_PARALLEL", "1")
    stage = jstages.Pipeline({}, {}, {}, cfg, mesh=None if dp == 1 else make_mesh(dp, model_parallel=1))
    assert stage._clip_parallel() and stage._dp() == dp
    fn = stage._flow_fn(t, hw)
    dt = jnp.bfloat16 if cfg.raft_half else jnp.float32
    spec = {k: jax.ShapeDtypeStruct(s, dt) for k, s in shapes.items()}
    frames = jax.ShapeDtypeStruct((1, t) + tuple(hw) + (3,), jnp.float32)
    with pytest.raises(_Chose) as chose:
        jax.eval_shape(fn, spec, frames)
    return chose.value.args[0]


# clips of 2 or more RAFT chunks: path C's (9 chunks of 12 at 640x360),
# the 720x480 and 1280x720 buckets, the portrait phone clip
CP_CLIPS = [(100, 360, 640), (25, 480, 720), (24, 720, 1280), (13, 1136, 640)]


@pytest.mark.parametrize("dp", [1, 2, 4], ids=["variable", "mesh2", "mesh4"])
@pytest.mark.parametrize("fp16", ["enable", "disable"])
@pytest.mark.parametrize("t,h,w", CP_CLIPS)
def test_jax_flow_lookup_clip_parallel_branch(monkeypatch, raft_shapes, dp, fp16, t, h, w):
    """The clip-parallel branch: each rank's call holds ceil(n_chunks / dp)
    chunks of clip pairs, and `jax_flow_lookup(..., clip_dp=dp)` names the
    lookup the JAX stage's call takes; the port runs the share in one call
    where it fits RAFT_CALL_BYTES, else a chunk a call (1280x720)."""
    for k in VARS:
        monkeypatch.delenv(k, raising=False)
    widgets = dict(fp16=fp16, raft_iter=1, process_size=(w, h))
    cfg = PipelineConfig(**widgets)
    branch, pairs = jax_clip_parallel_branch(monkeypatch, raft_shapes, JaxConfig(**widgets), t, (h, w), dp)
    n_chunks = len(stages.flow_chunk_plan(cfg, t))
    assert n_chunks > 1 and pairs == -(-n_chunks // dp) * cfg.raft_chunk_len()
    assert stages.jax_flow_lookup(cfg, t, (h, w), clip_dp=dp) == branch
    # the port's memory forms apply inside the share's call
    fits = traft.call_bytes(pairs, h // 8, w // 8, 2 if fp16 == "enable" else 4, branch) <= stages.RAFT_CALL_BYTES
    assert stages.raft_form(cfg, t, (h, w), clip_dp=dp) == ("clip-parallel" if fits else "chunks")
    if (t, h, w, dp, fp16) == (100, 360, 640, 1, "enable"):  # path C: 108 pairs at w8 = 80 pass the lanes gate
        assert (branch, pairs) == ("map", 108)


def test_clip_parallel_compute_flow_hands_every_call_the_jax_blend(monkeypatch):
    """Path C's clip at 640x360 under PROPAINTER_TPU_CLIP_PARALLEL=1: one
    RAFT call of the 9 chunks padded to 13 frames (108 pairs), with the
    JAX stage's blend; the flows of the real pairs come back in order."""
    for k in VARS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("PROPAINTER_TPU_CLIP_PARALLEL", "1")
    seen = []
    _recording(monkeypatch, seen)
    t, h, w = 100, 360, 640
    cfg = PipelineConfig(process_size=(w, h))
    pipe = stages.Pipeline({"fnet.conv1.weight": torch.zeros(1)}, {}, {}, cfg, device="cpu")
    ff, fb = pipe.compute_flow(torch.zeros(()).expand(1, t, h, w, 3))
    assert ff.shape == fb.shape == (1, t - 1, h, w, 2)
    assert seen == [(12, "map")]  # stand-in records pairs per clip: one call of 9 clips of 12 pairs
