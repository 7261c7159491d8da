"""The nodes' byte prep and composition on the device, against the host
prep and paste they replace.

`_quantize` is held against `_to_u8` bit for bit, `_unit` against the
host's division of every byte, and the crop plan made from one fetched
[H, W] map of the masks' union against the plan made from the host masks.
Both nodes run with device="cpu" (the same torch ops the card runs) and
are held bit for bit against `host_inpaint` / `host_outpaint`, the NumPy
prep and paste the nodes used before: once on a stand-in pipeline, whose
inputs are compared too, over the branches (crop, whole frame, empty
mask, 2-D and length-1 masks, uint8 and float64 inputs, values outside
0..1, the PIL resize and the device resize, outpaint with two and with
four bands), and once each on the real pipeline."""

import numpy as np
import pytest
import torch

from comfyui_propainter_nodes_tpu_torch import nodes
from comfyui_propainter_nodes_tpu_torch.config import ImageConfig, OutpaintConfig, PipelineConfig
from comfyui_propainter_nodes_tpu_torch.ops.dilation import binary_dilation
from comfyui_propainter_nodes_tpu_torch.utils import profiling
from comfyui_propainter_nodes_tpu_torch.utils.image import resize_frames, ring_masks

# ------------------------------------------------- the host's prep and paste


def _config(w: dict, process_size) -> PipelineConfig:
    return PipelineConfig(ref_stride=w["ref_stride"], neighbor_length=w["neighbor_length"],
                          subvideo_length=w["subvideo_length"], raft_iter=w["raft_iter"], fp16=w["fp16"],
                          process_size=process_size)


def _upload_u8(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _paste(full, crop, window):
    y0, x0, ch, cw = crop
    full[:, y0 : y0 + ch, x0 : x0 + cw] = window.cpu().numpy()
    return torch.from_numpy(full)


def host_inpaint(pipe, image, mask, w, dev="cpu"):
    """The inpaint node's prep and paste as the host made them: NumPy
    quantization (`_to_u8`), the resize, the crop plan on the host masks,
    uint8 uploads, and the crop pasted over float32 frames on the host.
    Returns the outputs, the crop and the pipeline's inputs."""
    pw, ph = ImageConfig(w["width"], w["height"], w["mask_dilates"], w["flow_mask_dilates"]).process_size
    t = len(image)
    pad = max(w["flow_mask_dilates"], w["mask_dilates"]) + 1
    frames = np.asarray(image)
    if frames.dtype != np.uint8:
        frames = frames.astype(np.float32, copy=False)
    masks = np.asarray(mask)
    if masks.dtype != np.uint8:
        masks = masks.astype(np.float32, copy=False)
    if masks.ndim == 2:
        masks = masks[None]
    frames_u8, masks_u8 = nodes._to_u8(frames), nodes._to_u8(masks)
    if masks_u8.shape[0] == 1:
        masks_u8 = np.broadcast_to(masks_u8, (t,) + masks_u8.shape[1:])
    frames_r = nodes._host_resize_u8(frames_u8, pw, ph)
    masks_r = nodes._host_resize_u8(masks_u8, pw, ph)
    on_host = frames_r is not None and masks_r is not None
    if on_host:
        masks_bin = masks_r != 0
        crop = nodes._mask_crop_plan(masks_bin, ph, pw, pad)
        byte = _upload_u8(frames_r, dev).float()
        base = _upload_u8(masks_bin, dev).float()
    else:
        h_in, w_in = masks_u8.shape[1], masks_u8.shape[2]
        iy = np.minimum((np.arange(ph) * h_in / ph).astype(int), h_in - 1)
        ix = np.minimum((np.arange(pw) * w_in / pw).astype(int), w_in - 1)
        crop = nodes._mask_crop_plan((masks_u8 != 0)[:, iy][:, :, ix], ph, pw, pad + 4)
        byte = resize_frames(_upload_u8(frames_u8, dev).float(), pw, ph)
        m = _upload_u8(masks_u8, dev).float()[..., None]
        base = (resize_frames(m, pw, ph)[..., 0] > 0.5).float()
    frames_norm = byte / 255.0 * 2.0 - 1.0
    fmd, md_ = w["flow_mask_dilates"], w["mask_dilates"]
    flow_masks = binary_dilation(base, fmd) if fmd > 0 else base
    masks_dilated = binary_dilation(base, md_) if md_ > 0 else base
    inputs = (frames_norm[None], flow_masks[None, ..., None], masks_dilated[None, ..., None], byte)
    comp_crop = pipe.process(*inputs, crop=crop)
    comp = comp_crop.to(torch.uint8).cpu()
    base_u8 = frames_r if on_host else byte.to(torch.uint8).cpu().numpy()
    y0, x0, ch, cw = crop
    window = (slice(None), slice(y0, y0 + ch), slice(x0, x0 + cw))
    out_images = _paste(base_u8.astype(np.float32), crop, comp).div_(255.0)
    fm = _paste(np.zeros((t, ph, pw), np.float32), crop, flow_masks[window].bool())
    md = _paste(np.zeros((t, ph, pw), np.float32), crop, masks_dilated[window].bool())
    return (out_images, fm.squeeze(), md.squeeze()), crop, inputs


def host_outpaint(pipe, image, w, dev="cpu"):
    """The outpaint node's prep and paste as the host made them: uint8
    bytes (the host's resize, or the device's without PIL), the canvas
    through its round trip (the bytes / 255 quantized again, centred, /
    255 and * 255), the composed canvas as uint8, and its bands pasted
    around the interior bytes on the host. Returns the outputs and the
    pipeline's inputs."""
    img_cfg = OutpaintConfig(w["width"], w["height"], w["mask_dilates"], w["flow_mask_dilates"],
                             w["width_scale"], w["height_scale"])
    pw, ph = img_cfg.process_size
    cw, chh = img_cfg.outpaint_size
    t = len(image)
    frames = np.asarray(image)
    if frames.dtype != np.uint8:
        frames = frames.astype(np.float32, copy=False)
    frames_u8 = nodes._to_u8(frames)
    frames_r = nodes._host_resize_u8(frames_u8, pw, ph)
    if frames_r is not None:
        interior = frames_r
        frames_dev = _upload_u8(frames_r, dev)
    else:
        frames_dev = resize_frames(_upload_u8(frames_u8, dev).float(), pw, ph).to(torch.uint8)
        interior = frames_dev.cpu().numpy()
    h_start, w_start = (chh - ph) // 2, (cw - pw) // 2
    rows, cols = slice(h_start, h_start + ph), slice(w_start, w_start + pw)
    unit = frames_dev.float() / 255.0
    canvas = unit.new_zeros((t, chh, cw, 3))
    canvas[:, rows, cols] = torch.floor(torch.clamp(unit * 255.0, 0.0, 255.0)) / 255.0
    canvas = canvas * 255.0
    shape = (t, chh, cw, 1)
    fm, md = (m[None, :, :, None].expand(shape).contiguous() for m in ring_masks((ph, pw), (chh, cw), dev))
    inputs = ((canvas / 255.0 * 2.0 - 1.0)[None], fm[None], md[None], canvas)
    out = pipe.process(*inputs).to(torch.uint8).cpu().numpy().astype(np.float32)
    out[:, rows, cols] = interior
    mask = ring_masks((ph, pw), (chh, cw))[1]
    return (torch.from_numpy(out).div_(255.0), mask.expand(t, chh, cw).clone().squeeze(), cw, chh), inputs


class StandIn:
    """A pipeline whose outputs are fixed functions of its inputs: a crop
    with fractions the inpaint node's uint8 cast truncates, or a whole
    canvas of bytes; it records its inputs."""

    def __init__(self):
        self.progress = None
        self.calls = []

    def process(self, frames_norm, flow_masks, masks_dilated, byte, crop=None):
        self.calls.append((frames_norm, flow_masks, masks_dilated, byte, crop))
        if crop is None:  # the outpaint canvas: the input's bytes where its dilated mask is 0, as the composite
            gen = torch.Generator().manual_seed(byte.shape[1] * 1000 + byte.shape[2])
            fill = torch.randint(0, 256, byte.shape, generator=gen).to(byte)
            return torch.where(masks_dilated[0] != 0, fill, byte)
        y0, x0, ch, cw = crop
        win = byte[:, y0 : y0 + ch, x0 : x0 + cw]
        return 255.0 - 0.75 * win + 0.4 * masks_dilated[0, :, y0 : y0 + ch, x0 : x0 + cw]


def _assert_same(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and a.shape == b.shape and a.device.type == "cpu"
            assert torch.equal(a, b)
        else:
            assert a == b


# ------------------------------------------------- the helpers


def _grid() -> np.ndarray:
    """float32 from -0.1 to 1.1, every k / 255 and its neighbours one ulp
    away, and 0 and 1."""
    g = np.linspace(-0.1, 1.1, 120001, dtype=np.float32)
    k = np.arange(256, dtype=np.float32) / np.float32(255)
    x = np.concatenate([g, k, np.float32([0.0, 1.0])])
    return np.concatenate([x, np.nextafter(x, np.float32(2)), np.nextafter(x, np.float32(-2))])


def test_quantize_matches_to_u8_bit_for_bit():
    x = _grid()
    want = nodes._to_u8(x)
    src = torch.from_numpy(x.copy())
    got = nodes._quantize(src)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want.astype(np.float32))
    assert np.array_equal(got.to(torch.uint8).numpy(), want)
    assert torch.equal(src, torch.from_numpy(x))  # left as it was


def test_quantize_keeps_uint8_bytes():
    b = torch.arange(256, dtype=torch.uint8)
    assert torch.equal(nodes._quantize(b), b.float())


def test_unit_divides_every_byte_as_the_host():
    k = np.arange(256, dtype=np.float32)
    want = k / np.float32(255)
    assert np.array_equal(nodes._unit(torch.arange(256, dtype=torch.float32)).numpy(), want)
    # the product with the reciprocal, which CUDA takes for a host scalar, is not
    assert int((k * (np.float32(1) / np.float32(255)) != want).sum()) == 126


def _plan_masks():
    rng = np.random.default_rng(5)
    cases = {"empty": np.zeros((4, 64, 96), bool)}
    for i in range(4):
        m = np.zeros((4, 64, 96), bool)
        for t in range(4):
            y, x = rng.integers(0, 60), rng.integers(0, 90)
            m[t, y : y + rng.integers(1, 20), x : x + rng.integers(1, 30)] = True
        cases[f"boxes{i}"] = m
    big = np.zeros((4, 64, 96), bool)
    big[:, 2:60, 3:90] = True  # past 70% of the frame: the whole frame
    cases["fallback"] = big
    edge = np.zeros((4, 64, 96), bool)
    edge[2, 60:, 90:] = True  # at the corner: the box shifts inward
    cases["corner"] = edge
    return cases


@pytest.mark.parametrize("case", sorted(_plan_masks()))
@pytest.mark.parametrize("pad", [0, 5, 9])
def test_crop_plan_from_the_union_map(case, pad):
    m = _plan_masks()[case]
    union = (torch.from_numpy(m).float() != 0).any(0).numpy()
    assert nodes._mask_crop_plan(union[None], 64, 96, pad) == nodes._mask_crop_plan(m, 64, 96, pad)


# ------------------------------------------------- both nodes on a stand-in pipeline

T, H, W = 5, 48, 64
INPAINT = dict(width=W, height=H, mask_dilates=2, flow_mask_dilates=3, ref_stride=3, neighbor_length=4,
               subvideo_length=80, raft_iter=1, fp16="disable")


def _clip(t=T, h=H, w=W, seed=0):
    rng = np.random.default_rng(seed)
    frames = rng.random((t, h, w, 3), dtype=np.float32)
    masks = np.zeros((t, h, w), np.float32)
    for i in range(t):
        masks[i, 10 + i : 22 + i, 12 + 2 * i : 26 + 2 * i] = 1.0
    return frames, masks


def _masks(kind: str, masks: np.ndarray):
    if kind == "empty":
        return np.zeros_like(masks)
    if kind == "large":  # past 70%: the whole frame
        m = np.zeros_like(masks)
        m[:, 1:-1, 1:-1] = 0.6
        return m
    if kind == "2d":
        return masks[2]
    if kind == "len1":
        return masks[1:2]
    if kind == "soft":  # one level inside the box, just under one outside it
        return np.where(masks > 0, np.float32(0.004), np.float32(0.0039))
    return masks


INPAINT_CASES = [
    ("crop", "float32"), ("large", "float32"), ("empty", "float32"), ("2d", "float32"), ("len1", "float32"),
    ("soft", "float32"), ("crop", "uint8"), ("crop", "float64"), ("crop", "out_of_range"), ("crop", "tensor"),
]


def _inputs(kind, dtype, frames, masks):
    m = _masks(kind, masks)
    if dtype == "uint8":
        return (frames * 255).astype(np.uint8), (m * 255).astype(np.uint8)
    if dtype == "float64":
        return frames.astype(np.float64), m.astype(np.float64)
    if dtype == "out_of_range":
        return frames * 1.4 - 0.2, m
    if dtype == "tensor":
        return torch.from_numpy(frames), torch.from_numpy(m)
    return frames, m


@pytest.mark.parametrize("kind,dtype", INPAINT_CASES)
def test_inpaint_node_matches_the_host_paste(monkeypatch, kind, dtype):
    frames, masks = _inputs(kind, dtype, *_clip())
    to_u8_calls = []
    real_to_u8 = nodes._to_u8
    monkeypatch.setattr(nodes, "_to_u8", lambda a: to_u8_calls.append(a.shape) or real_to_u8(a))
    stand_in = StandIn()
    monkeypatch.setattr(nodes, "get_pipeline", lambda *a: stand_in)
    node = nodes.ProPainterInpaint(device="cpu")
    profiling.reset()
    got = node.propainter_inpainting(frames, masks, **INPAINT)
    assert not to_u8_calls  # at the process size the bytes are made where the pipeline runs
    assert profiling.counters().get("node_card_io", 0) == 0  # no card here
    args = (np.asarray(frames), np.asarray(masks))
    want, crop, inputs = host_inpaint(StandIn(), *args, INPAINT)
    assert node.last_crop == crop
    _assert_same(got, want)
    _assert_same(stand_in.calls[0][:4], inputs)
    if kind == "large":
        assert crop == (0, 0, H, W)
    if kind == "empty":
        assert crop == (0, 0, 32, 32) and not got[1].any() and not got[2].any()


@pytest.mark.parametrize("pil", [True, False])
def test_inpaint_node_resized_matches_the_host_paste(monkeypatch, pil):
    """A clip at another size keeps the host's quantization and resize (or
    the device resize without PIL); the composition is the device's."""
    frames, masks = _clip(h=60, w=80)
    stand_in = StandIn()
    monkeypatch.setattr(nodes, "get_pipeline", lambda *a: stand_in)
    if not pil:
        monkeypatch.setattr(nodes, "_host_resize_u8", lambda *a: None)
    got = nodes.ProPainterInpaint(device="cpu").propainter_inpainting(frames, masks, **INPAINT)
    want, _, inputs = host_inpaint(StandIn(), frames, masks, INPAINT)
    _assert_same(got, want)
    _assert_same(stand_in.calls[0][:4], inputs)


@pytest.mark.parametrize("pil", [True, False])
def test_inpaint_node_resized_single_frame_mask_matches_the_host_paste(monkeypatch, pil):
    """A one-frame mask of another size is resized once and expanded over
    the clip after the resize; the host expanded it before."""
    frames, masks = _clip(h=60, w=80)
    stand_in = StandIn()
    monkeypatch.setattr(nodes, "get_pipeline", lambda *a: stand_in)
    if not pil:
        monkeypatch.setattr(nodes, "_host_resize_u8", lambda *a: None)
    node = nodes.ProPainterInpaint(device="cpu")
    got = node.propainter_inpainting(frames, masks[2], **INPAINT)
    want, crop, inputs = host_inpaint(StandIn(), frames, masks[2], INPAINT)
    assert node.last_crop == crop
    _assert_same(got, want)
    _assert_same(stand_in.calls[0][:4], inputs)


OUTPAINT = dict(INPAINT, width_scale=1.25, height_scale=1.0)


@pytest.mark.parametrize("scales,size,dtype", [
    ((1.25, 1.0), (H, W), "float32"),  # the two side bands
    ((1.25, 1.5), (H, W), "float32"),  # four bands
    ((1.0, 1.5), (H, W), "uint8"),  # top and bottom only
    ((1.25, 1.5), (H, W), "out_of_range"),
    ((1.25, 1.5), (60, 80), "float32"),  # the PIL resize
    ((1.25, 1.5), (60, 80), "no_pil"),  # the device resize
])
def test_outpaint_node_matches_the_host_paste(monkeypatch, scales, size, dtype):
    frames, _ = _clip(h=size[0], w=size[1])
    if dtype == "uint8":
        frames = (frames * 255).astype(np.uint8)
    elif dtype == "out_of_range":
        frames = frames * 1.4 - 0.2
    elif dtype == "no_pil":
        monkeypatch.setattr(nodes, "_host_resize_u8", lambda *a: None)
    w = dict(OUTPAINT, width_scale=scales[0], height_scale=scales[1])
    stand_in = StandIn()
    monkeypatch.setattr(nodes, "get_pipeline", lambda *a: stand_in)
    got = nodes.ProPainterOutpaint(device="cpu").propainter_outpainting(frames, **w)
    want, inputs = host_outpaint(StandIn(), frames, w)
    _assert_same(got, want)
    _assert_same(stand_in.calls[0][:4], inputs)


# ------------------------------------------------- both nodes on the real pipeline


def test_inpaint_node_on_the_pipeline_matches_the_host_paste():
    frames, masks = _clip(t=6)
    node = nodes.ProPainterInpaint(device="cpu")
    got = node.propainter_inpainting(frames, masks, _allow_random_weights=True, **INPAINT)
    pipe = nodes.get_pipeline(_config(INPAINT, (W, H)), torch.device("cpu"), True)
    want, crop, _ = host_inpaint(pipe, frames, masks, INPAINT)
    assert node.last_crop == crop != (0, 0, H, W)
    _assert_same(got, want)


def test_outpaint_node_on_the_pipeline_matches_the_host_paste():
    frames, _ = _clip(t=6)
    w = dict(OUTPAINT, height_scale=1.5)
    got = nodes.ProPainterOutpaint(device="cpu").propainter_outpainting(frames, _allow_random_weights=True, **w)
    cw, chh = OutpaintConfig(W, H, 2, 3, 1.25, 1.5).outpaint_size
    pipe = nodes.get_pipeline(_config(w, (cw, chh)), torch.device("cpu"), True)
    want, _ = host_outpaint(pipe, frames, w)
    _assert_same(got, want)
