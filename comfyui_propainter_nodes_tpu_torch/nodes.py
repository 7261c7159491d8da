"""ComfyUI node API for the PyTorch port.

`ProPainterInpaint` and `ProPainterOutpaint` have the same INPUT_TYPES /
RETURN_TYPES / RETURN_NAMES / FUNCTION / CATEGORY contract as the
reference (and the JAX package), so workflow JSONs run unchanged. They
run on the card: `ProPainterInpaint()` resolves to CUDA and raises when
there is none; `device="cpu"` runs the plain versions of the kernels on
the host. Outputs are CPU torch tensors.

Only what can differ from the input comes back from the device: the
inpaint node's mask bounding box (`_mask_crop_plan`), the outpaint
node's bands. The host pastes them over the frames it holds and builds
the masks outside them itself.

Each run reports its stages' progress (`utils/profiling.py::NodeProgress`:
ComfyUI's progress bar, tqdm or stderr) and leaves a run record
(`utils/metrics.py::last_run`, and a JSON line in the file that
PROPAINTER_TPU_METRICS names).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .config import ImageConfig, OutpaintConfig, PipelineConfig
from .ops.dilation import binary_dilation
from .pipeline.stages import Pipeline
from .utils import profiling
from .utils import weights as weights_zoo
from .utils.image import resize_frames, ring_masks
from .utils.metrics import RunRecorder
from .utils.params import to_device

_PIPELINE_CACHE: dict = {}
_PARAM_CACHE: dict = {}  # (model, dtype, device, allow_random) -> params on the device


def _to_numpy(x) -> np.ndarray:
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _to_u8(a: np.ndarray) -> np.ndarray:
    """Host byte quantization, truncating like the reference's PIL round
    trip (utils/image_utils.py:106-139)."""
    if a.dtype == np.uint8:
        return a
    return np.floor(np.clip(a * 255.0, 0.0, 255.0)).astype(np.uint8)


def _host_resize_u8(stack_u8: np.ndarray, pw: int, ph: int):
    """PIL bicubic resize of a [T, H, W(, C)] uint8 stack (the reference's
    own prep, utils/image_utils.py:98-103); None without PIL."""
    if stack_u8.shape[1] == ph and stack_u8.shape[2] == pw:
        return stack_u8
    try:
        from PIL import Image
    except ImportError:
        return None
    out = np.empty((stack_u8.shape[0], ph, pw) + stack_u8.shape[3:], np.uint8)
    for i, fr in enumerate(stack_u8):
        out[i] = np.asarray(Image.fromarray(fr).resize((pw, ph)))
    return out


def _mask_crop_plan(masks_bin: np.ndarray, ph: int, pw: int, pad: int) -> tuple[int, int, int, int]:
    """(y0, x0, ch, cw): the union bounding box of the masks grown by the
    dilation radius `pad`, its sides rounded up to multiples of 32 (the JAX
    node's plan). The composed video equals the input outside the dilated
    mask, so only this crop is computed and fetched; past 70% of the frame
    the whole frame is."""
    any_t = masks_bin.any(axis=0)
    rows = any_t.any(axis=1)
    cols = any_t.any(axis=0)
    if not rows.any():
        return 0, 0, min(32, ph), min(32, pw)

    def span(flags, size):
        a = int(flags.argmax())
        b = size - int(flags[::-1].argmax())
        a = max(0, a - pad)
        b = min(size, b + pad)
        length = min(size, -(-(b - a) // 32) * 32)
        return min(a, size - length), length

    y0, ch = span(rows, ph)
    x0, cw = span(cols, pw)
    if ch * cw >= 0.7 * ph * pw:
        return 0, 0, ph, pw
    return y0, x0, ch, cw


def _paste(full: np.ndarray, crop, window: torch.Tensor) -> torch.Tensor:
    """full [T, H, W(, C)] float32 with `window` (a device tensor) fetched
    and written over it at the crop. NumPy on the host: a zero array's
    pages stay unwritten outside the crop."""
    y0, x0, ch, cw = crop
    full[:, y0 : y0 + ch, x0 : x0 + cw] = window.cpu().numpy()
    return torch.from_numpy(full)


def check_inputs(frames: np.ndarray, masks: np.ndarray) -> None:
    """Input validation (reference propainter_nodes.py:21-35)."""
    if frames.shape[0] <= 1:
        raise Exception(
            f"""Image length must be greater than 1, but got:
                        Image length: ({frames.shape[0]})"""
        )
    if frames.shape[0] != masks.shape[0] and masks.shape[0] != 1:
        raise Exception(
            f"""Image and Mask must have the same length or Mask have length 1, but got:
                        Image length: {frames.shape[0]}
                        Mask length: {masks.shape[0]}"""
        )
    if frames.shape[1] != masks.shape[1] or frames.shape[2] != masks.shape[2]:
        raise Exception(
            f"""Image and Mask must have the same dimensions, but got:
                        Image: ({frames.shape[1]}, {frames.shape[2]})
                        Mask: ({masks.shape[1]}, {masks.shape[2]})"""
        )


def resolve_device(device=None) -> torch.device:
    """`None` means the card; a missing card is an error, not a fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the ProPainter nodes run on a CUDA device and none is available; "
            'pass device="cpu" to run the plain (kernel-free) path on the host'
        )
    return dev


def _upload_u8(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _cached_params(model: str, dtype: torch.dtype, device, allow_random: bool) -> dict:
    """A model's params, loaded once and cast and moved once per (dtype,
    device): the pipelines of every config on a device share them, as the
    JAX package's device params are shared (nodes.py:161-187 there). The
    host copy is `get_params`' in-process cache; a run that asks for
    random weights (`_allow_random_weights`, tests and benchmarks) takes a
    local cache or checkpoint where one exists and never downloads."""
    key = (model, dtype, str(device), allow_random)
    if key not in _PARAM_CACHE:
        host = weights_zoo.get_params(model, allow_download=not allow_random, allow_random=allow_random)
        _PARAM_CACHE[key] = to_device(host, device, dtype)
    return _PARAM_CACHE[key]


def get_pipeline(config: PipelineConfig, device, allow_random_weights: bool = False) -> Pipeline:
    """Pipeline cached per (config, device), on device params shared by
    every config of the same dtypes (`_cached_params`)."""
    key = (config, str(device), allow_random_weights)
    if key not in _PIPELINE_CACHE:
        rdt = torch.bfloat16 if config.raft_half else torch.float32
        cdt = torch.bfloat16 if config.use_bf16 else torch.float32
        _PIPELINE_CACHE[key] = Pipeline(
            _cached_params("raft", rdt, device, allow_random_weights),
            _cached_params("flow_completion", cdt, device, allow_random_weights),
            _cached_params("inpaint_generator", cdt, device, allow_random_weights),
            config,
            device,
        )
    return _PIPELINE_CACHE[key]


@contextlib.contextmanager
def _node_progress(pipe: Pipeline, t: int):
    """The run's stages tick a `NodeProgress` of its own; the cached
    pipeline's earlier callback is back after the run."""
    prev = pipe.progress
    pipe.progress = profiling.NodeProgress(t)
    try:
        yield
    finally:
        pipe.progress = prev


class ProPainterInpaint:
    """ComfyUI Node for performing inpainting on video frames using ProPainter."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.last_pipeline: Pipeline | None = None
        self.last_crop: tuple[int, int, int, int] | None = None

    @classmethod
    def INPUT_TYPES(s):  # noqa: N804 - ComfyUI contract
        return {
            "required": {
                "image": ("IMAGE",),
                "mask": ("MASK",),
                "width": ("INT", {"default": 640, "min": 0, "max": 2560}),
                "height": ("INT", {"default": 360, "min": 0, "max": 2560}),
                "mask_dilates": ("INT", {"default": 5, "min": 0, "max": 100}),
                "flow_mask_dilates": ("INT", {"default": 8, "min": 0, "max": 100}),
                "ref_stride": ("INT", {"default": 10, "min": 1, "max": 100}),
                "neighbor_length": ("INT", {"default": 10, "min": 2, "max": 300}),
                "subvideo_length": ("INT", {"default": 80, "min": 1, "max": 300}),
                "raft_iter": ("INT", {"default": 20, "min": 1, "max": 100}),
                "fp16": (["enable", "disable"],),
            },
        }

    RETURN_TYPES = ("IMAGE", "MASK", "MASK")
    RETURN_NAMES = ("IMAGE", "FLOW_MASK", "MASK_DILATE")
    FUNCTION = "propainter_inpainting"
    CATEGORY = "ProPainter"

    def propainter_inpainting(
        self,
        image,
        mask,
        width: int,
        height: int,
        mask_dilates: int,
        flow_mask_dilates: int,
        ref_stride: int,
        neighbor_length: int,
        subvideo_length: int,
        raft_iter: int,
        fp16: str,
        _allow_random_weights: bool = False,
    ):
        """Perform inpainting on images input using the ProPainter pipeline."""
        frames = _to_numpy(image)
        if frames.dtype != np.uint8:
            frames = frames.astype(np.float32, copy=False)
        masks = _to_numpy(mask)
        if masks.dtype != np.uint8:
            masks = masks.astype(np.float32, copy=False)
        if masks.ndim == 2:
            masks = masks[None]
        check_inputs(frames, masks)

        pw, ph = ImageConfig(width, height, mask_dilates, flow_mask_dilates).process_size
        config = PipelineConfig(
            ref_stride=ref_stride,
            neighbor_length=neighbor_length,
            subvideo_length=subvideo_length,
            raft_iter=raft_iter,
            fp16=fp16,
            process_size=(pw, ph),
        )
        t = frames.shape[0]
        frames_u8 = _to_u8(frames)
        masks_u8 = _to_u8(masks)
        if masks_u8.shape[0] == 1:
            masks_u8 = np.broadcast_to(masks_u8, (t,) + masks_u8.shape[1:])
        pad = max(flow_mask_dilates, mask_dilates) + 1
        dev = self.device

        # host resize (PIL bicubic, as the reference); on-device otherwise
        frames_r = _host_resize_u8(frames_u8, pw, ph)
        masks_r = _host_resize_u8(masks_u8, pw, ph)
        if frames_r is not None and masks_r is not None:
            masks_bin = masks_r != 0
            crop = _mask_crop_plan(masks_bin, ph, pw, pad)
            byte = _upload_u8(frames_r, dev).float()
            base = _upload_u8(masks_bin, dev).float()
        else:
            # the plan from the input-resolution mask's nearest projection,
            # with a 4 px margin for the bicubic resize's spill
            h_in, w_in = masks_u8.shape[1], masks_u8.shape[2]
            iy = np.minimum((np.arange(ph) * h_in / ph).astype(int), h_in - 1)
            ix = np.minimum((np.arange(pw) * w_in / pw).astype(int), w_in - 1)
            crop = _mask_crop_plan((masks_u8 != 0)[:, iy][:, :, ix], ph, pw, pad + 4)
            byte = resize_frames(_upload_u8(frames_u8, dev).float(), pw, ph)
            m = _upload_u8(masks_u8, dev).float()[..., None]
            base = (resize_frames(m, pw, ph)[..., 0] > 0.5).float()
        frames_norm = byte / 255.0 * 2.0 - 1.0
        flow_masks = binary_dilation(base, flow_mask_dilates) if flow_mask_dilates > 0 else base
        masks_dilated = binary_dilation(base, mask_dilates) if mask_dilates > 0 else base

        pipe = get_pipeline(config, dev, _allow_random_weights)
        self.last_pipeline, self.last_crop = pipe, crop
        with _node_progress(pipe, t), RunRecorder("inpaint", config, t):
            comp_crop = pipe.process(
                frames_norm[None], flow_masks[None, ..., None], masks_dilated[None, ..., None], byte, crop=crop
            )
            # fetch the crops only; paste them over the host's own bytes (or
            # the device-resized frames, fetched once) and over zero masks
            y0, x0, ch, cw = crop
            window = (slice(None), slice(y0, y0 + ch), slice(x0, x0 + cw))
            base_u8 = frames_r if frames_r is not None else byte.to(torch.uint8).cpu().numpy()
            out_images = _paste(base_u8.astype(np.float32), crop, comp_crop.to(torch.uint8)).div_(255.0)
            fm = _paste(np.zeros((t, ph, pw), np.float32), crop, flow_masks[window].bool())
            md = _paste(np.zeros((t, ph, pw), np.float32), crop, masks_dilated[window].bool())
        return out_images, fm.squeeze(), md.squeeze()


class ProPainterOutpaint:
    """ComfyUI Node for performing outpainting on video frames using ProPainter."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.last_pipeline: Pipeline | None = None

    @classmethod
    def INPUT_TYPES(s):  # noqa: N804 - ComfyUI contract
        return {
            "required": {
                "image": ("IMAGE",),
                "width": ("INT", {"default": 640, "min": 0, "max": 2560}),
                "height": ("INT", {"default": 360, "min": 0, "max": 2560}),
                "width_scale": ("FLOAT", {"default": 1.2, "min": 0.0, "max": 10.0, "step": 0.01}),
                "height_scale": ("FLOAT", {"default": 1.0, "min": 0.0, "max": 10.0, "step": 0.01}),
                "mask_dilates": ("INT", {"default": 5, "min": 0, "max": 100}),
                "flow_mask_dilates": ("INT", {"default": 8, "min": 0, "max": 100}),
                "ref_stride": ("INT", {"default": 10, "min": 1, "max": 100}),
                "neighbor_length": ("INT", {"default": 10, "min": 2, "max": 300}),
                "subvideo_length": ("INT", {"default": 80, "min": 1, "max": 300}),
                "raft_iter": ("INT", {"default": 20, "min": 1, "max": 100}),
                "fp16": (["enable", "disable"],),
            },
        }

    RETURN_TYPES = ("IMAGE", "MASK", "INT", "INT")
    RETURN_NAMES = ("IMAGE", "OUTPAINT_MASK", "output_width", "output_height")
    FUNCTION = "propainter_outpainting"
    CATEGORY = "ProPainter"

    def propainter_outpainting(
        self,
        image,
        width: int,
        height: int,
        width_scale: float,
        height_scale: float,
        mask_dilates: int,
        flow_mask_dilates: int,
        ref_stride: int,
        neighbor_length: int,
        subvideo_length: int,
        raft_iter: int,
        fp16: str,
        _allow_random_weights: bool = False,
    ):
        """Perform outpainting on images input using the ProPainter pipeline."""
        frames = _to_numpy(image)
        if frames.dtype != np.uint8:
            frames = frames.astype(np.float32, copy=False)
        img_cfg = OutpaintConfig(width, height, mask_dilates, flow_mask_dilates, width_scale, height_scale)
        pw, ph = img_cfg.process_size
        cw, chh = img_cfg.outpaint_size
        config = PipelineConfig(
            ref_stride=ref_stride,
            neighbor_length=neighbor_length,
            subvideo_length=subvideo_length,
            raft_iter=raft_iter,
            fp16=fp16,
            process_size=(cw, chh),
        )
        t = frames.shape[0]
        frames_u8 = _to_u8(frames)
        dev = self.device
        frames_r = _host_resize_u8(frames_u8, pw, ph)
        if frames_r is not None:
            interior = frames_r
            frames_dev = _upload_u8(frames_r, dev)
        else:  # resize on the device; its bytes are the interior, fetched once
            frames_dev = resize_frames(_upload_u8(frames_u8, dev).float(), pw, ph).to(torch.uint8)
            interior = frames_dev.cpu().numpy()

        pipe = get_pipeline(config, dev, _allow_random_weights)
        self.last_pipeline = pipe
        with _node_progress(pipe, t), RunRecorder("outpaint", config, t):
            bands = [b.cpu().numpy() for b in pipe.process_node_outpaint(frames_dev, (chh, cw))]

        # the interior is the host's own bytes (composed == input there,
        # exactly); the bands fill the ring around it
        out = np.zeros((t, chh, cw, 3), np.float32)
        h_start, w_start = (chh - ph) // 2, (cw - pw) // 2
        out[:, h_start : h_start + ph, w_start : w_start + pw] = interior
        bi = iter(bands)
        if h_start:
            out[:, :h_start] = next(bi)
            out[:, h_start + ph :] = next(bi)
        if w_start:
            out[:, h_start : h_start + ph, :w_start] = next(bi)
            out[:, h_start : h_start + ph, w_start + pw :] = next(bi)
        # the ring mask is static geometry, built on the host
        mask = ring_masks((ph, pw), (chh, cw))[1]
        return torch.from_numpy(out).div_(255.0), mask.expand(t, chh, cw).clone().squeeze(), cw, chh


NODE_CLASS_MAPPINGS = {
    "ProPainterInpaint": ProPainterInpaint,
    "ProPainterOutpaint": ProPainterOutpaint,
}

NODE_DISPLAY_NAME_MAPPINGS = {
    "ProPainterInpaint": "ProPainter Inpainting",
    "ProPainterOutpaint": "ProPainter Outpainting",
}
