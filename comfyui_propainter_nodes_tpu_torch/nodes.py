"""ComfyUI node API for the PyTorch port.

`ProPainterInpaint` and `ProPainterOutpaint` have the same INPUT_TYPES /
RETURN_TYPES / RETURN_NAMES / FUNCTION / CATEGORY contract as the
reference (and the JAX package), so workflow JSONs run unchanged. They
run on the card: `ProPainterInpaint()` resolves to CUDA and raises when
there is none; `device="cpu"` runs the plain versions of the kernels on
the host. Outputs are CPU torch tensors, new ones each call.

The host moves bytes and plans; the device does the rest. Both nodes
turn their ComfyUI tensors into bytes at the process size in one place
(`_process_bytes`): a clip already at that size goes up as ComfyUI hands
it over and is quantized on the device (`_quantize`, `_to_u8`'s
arithmetic), and the counter "node_card_io" counts the call; a clip of
another size takes the PIL resize on the host, or the device resize
without PIL. The inpaint node fetches one [H, W] map of the mask's union
for its padded box (`_mask_crop_plan`) and decodes only that crop; the
outpaint node centres the bytes on its canvas (`outpaint_canvas`) and
takes the composed canvas whole. The outputs are composed on the device
(`_compose`, `_unit`) and fetched once (`_fetch`).

Each run reports its stages' progress (`utils/profiling.py::NodeProgress`:
ComfyUI's progress bar, tqdm or stderr) and leaves a run record
(`utils/metrics.py::last_run`, and a JSON line in the file that
PROPAINTER_TPU_METRICS names). Its host phases are spans
(`utils/profiling.py::span`): the root "node.inpaint" / "node.outpaint";
"node.prepare" before the pipeline ("node.to_bytes", the bytes at the
input's size: on the device at the process size, else on the host;
"node.resize" with the resize and its upload; "node.crop_plan"
(inpaint); "node.upload" with the normalisation, the dilations or the
canvas); "node.finish" after it ("node.paste", the composition on the
device, and "node.fetch").
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
from .utils.image import outpaint_canvas, resize_frames
from .utils.metrics import RunRecorder
from .utils.params import to_device
from .utils.profiling import span

_PIPELINE_CACHE: dict = {}
_PARAM_CACHE: dict = {}  # (model, dtype, device, allow_random) -> params on the device


def _as_tensor(x) -> torch.Tensor:
    """A ComfyUI IMAGE or MASK, a tensor or an array wherever it lies, as a
    tensor: uint8 as it is, any other dtype as float32."""
    x = x.detach() if torch.is_tensor(x) else torch.from_numpy(np.ascontiguousarray(x))
    return x if x.dtype == torch.uint8 else x.float()


def _to_u8(a: np.ndarray) -> np.ndarray:
    """Host byte quantization, truncating like the reference's PIL round
    trip (utils/image_utils.py:106-139)."""
    if a.dtype == np.uint8:
        return a
    return np.floor(np.clip(a * 255.0, 0.0, 255.0)).astype(np.uint8)


def _quantize(x: torch.Tensor) -> torch.Tensor:
    """`_to_u8`'s bytes of x (uint8 or float32) as float32, where x lies:
    floor(clamp(x * 255, 0, 255)), the multiply in float32 as on the host.
    A new tensor; x is left as it is."""
    if x.dtype == torch.uint8:
        return x.float()
    return torch.mul(x, 255.0).clamp_(0.0, 255.0).floor_()


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

    def extent(flags, size):
        a = int(flags.argmax())
        b = size - int(flags[::-1].argmax())
        a = max(0, a - pad)
        b = min(size, b + pad)
        length = min(size, -(-(b - a) // 32) * 32)
        return min(a, size - length), length

    y0, ch = extent(rows, ph)
    x0, cw = extent(cols, pw)
    if ch * cw >= 0.7 * ph * pw:
        return 0, 0, ph, pw
    return y0, x0, ch, cw


def _compose(shape, pieces, device) -> torch.Tensor:
    """A float32 tensor of `shape` [T, H, W(, C)] on `device`: zeros, with
    each (rows, cols, tensor) of `pieces` written over it in turn (rows
    and cols slice H and W)."""
    out = torch.zeros(shape, dtype=torch.float32, device=device)
    for rows, cols, piece in pieces:
        out[:, rows, cols] = piece
    return out


def _unit(byte: torch.Tensor) -> torch.Tensor:
    """byte / 255 in place, each of the 256 quotients correctly rounded as
    the host's division gives it. The divisor is a tensor on byte's device:
    CUDA divides by a host scalar as a product with its reciprocal, which
    moves 126 of the 256 quotients by an ulp."""
    return byte.div_(torch.tensor(255.0, device=byte.device))


def _upload(x: torch.Tensor, device) -> torch.Tensor:
    """x on `device`. From the host to the card it goes through page-locked
    memory of PyTorch's caching host allocator, registered at the first
    call and reused by later ones (3.2 against 10.1 ms for a 24-frame
    640x360 IMAGE by a pageable copy on an H100's host, PERF.md)."""
    if torch.device(device).type == "cuda" and x.device.type == "cpu":
        return x.pin_memory().to(device, non_blocking=True)
    return x.to(device)


def _fetch(x: torch.Tensor) -> torch.Tensor:
    """x, a tensor the node made, in host memory. From the card it lands in
    page-locked memory of PyTorch's caching host allocator: a new block
    while the caller holds the last output, a freed one reused otherwise
    (1.3 against 33 ms for a 24-frame 640x360 IMAGE in float32, whose
    fresh pageable pages fault one by one; PERF.md)."""
    if x.device.type == "cuda":
        return torch.empty(x.shape, dtype=x.dtype, pin_memory=True).copy_(x)
    return x.cpu()


def _process_bytes(pw: int, ph: int, device, *xs: torch.Tensor) -> tuple[list[torch.Tensor], bool]:
    """The ComfyUI IMAGE [T, H, W, 3] and MASK [T, H, W] tensors xs (of one
    H and W, `_as_tensor`) as float bytes at the process size (pw, ph) on
    `device`, and whether the device resized them. A clip at the process
    size goes up as it is and is quantized there (`_quantize`); on the card
    that counts one "node_card_io" a call. Another size is quantized on the
    host (`_to_u8`) and resized by PIL (bicubic, as the reference), or on
    the device without PIL (`resize_frames`)."""
    with span("node.to_bytes"):
        at = xs[0].shape[1] == ph and xs[0].shape[2] == pw
        if at and torch.device(device).type == "cuda":
            profiling.count("node_card_io")
        made = [_quantize(_upload(x, device)) if at else _to_u8(x.cpu().numpy()) for x in xs]
    with span("node.resize"):
        if at:
            return made, False
        resized = [_host_resize_u8(a, pw, ph) for a in made]
        if all(r is not None for r in resized):
            return [_upload(torch.from_numpy(r), device).float() for r in resized], False
        ups = [_upload(torch.from_numpy(np.ascontiguousarray(a)), device).float() for a in made]
        return [resize_frames(b.reshape(b.shape[:3] + (-1,)), pw, ph).reshape((len(b), ph, pw) + b.shape[3:])
                for b in ups], True


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
        pw, ph = ImageConfig(width, height, mask_dilates, flow_mask_dilates).process_size
        config = PipelineConfig(
            ref_stride=ref_stride,
            neighbor_length=neighbor_length,
            subvideo_length=subvideo_length,
            raft_iter=raft_iter,
            fp16=fp16,
            process_size=(pw, ph),
        )
        t = len(image)
        pad = max(flow_mask_dilates, mask_dilates) + 1
        dev = self.device
        with span("node.inpaint"), RunRecorder("inpaint", config, t):
            with span("node.prepare"):
                frames, masks = _as_tensor(image), _as_tensor(mask)
                if masks.ndim == 2:
                    masks = masks[None]
                check_inputs(frames, masks)
                (byte, mask_bytes), resized_on_device = _process_bytes(pw, ph, dev, frames, masks)
                with span("node.crop_plan"):
                    if resized_on_device:
                        # the plan from the input-resolution mask's nearest projection,
                        # with a 4 px margin for the bicubic resize's spill
                        union = (_quantize(masks) != 0).any(0).cpu().numpy()
                        h_in, w_in = union.shape
                        iy = np.minimum((np.arange(ph) * h_in / ph).astype(int), h_in - 1)
                        ix = np.minimum((np.arange(pw) * w_in / pw).astype(int), w_in - 1)
                        crop = _mask_crop_plan(union[iy][:, ix][None], ph, pw, pad + 4)
                    else:  # one [H, W] map of the masks' union comes back
                        crop = _mask_crop_plan((mask_bytes != 0).any(0).cpu().numpy()[None], ph, pw, pad)
                with span("node.upload"):
                    base = (mask_bytes != 0).expand(t, ph, pw).float()
                    del mask_bytes  # freed before the pipeline runs
                    frames_norm = byte / 255.0 * 2.0 - 1.0
                    flow_masks = binary_dilation(base, flow_mask_dilates) if flow_mask_dilates > 0 else base
                    masks_dilated = binary_dilation(base, mask_dilates) if mask_dilates > 0 else base
                pipe = get_pipeline(config, dev, _allow_random_weights)
                self.last_pipeline, self.last_crop = pipe, crop

            with _node_progress(pipe, t):
                comp_crop = pipe.process(
                    frames_norm[None], flow_masks[None, ..., None], masks_dilated[None, ..., None], byte, crop=crop
                )

            # the crops pasted over the frames' bytes and over zero masks on the
            # device; the three outputs come back once
            with span("node.finish"):
                with span("node.paste"):
                    y0, x0, ch, cw = crop
                    rows, cols, whole = slice(y0, y0 + ch), slice(x0, x0 + cw), slice(None)
                    pieces = [(whole, whole, byte), (rows, cols, comp_crop.to(torch.uint8))]
                    out_images = _unit(_compose(byte.shape, pieces, dev))
                    fm = _compose((t, ph, pw), [(rows, cols, flow_masks[:, rows, cols].bool())], dev)
                    md = _compose((t, ph, pw), [(rows, cols, masks_dilated[:, rows, cols].bool())], dev)
                with span("node.fetch"):
                    out_images, fm, md = _fetch(out_images), _fetch(fm), _fetch(md)
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
        t = len(image)
        dev = self.device
        with span("node.outpaint"), RunRecorder("outpaint", config, t):
            with span("node.prepare"):
                (byte,), _ = _process_bytes(pw, ph, dev, _as_tensor(image))
                with span("node.upload"):
                    canvas, flow_masks, masks_dilated = outpaint_canvas(byte, (chh, cw))
                    del byte  # the canvas holds the bytes
                    frames_norm = canvas / 255.0 * 2.0 - 1.0
                pipe = get_pipeline(config, dev, _allow_random_weights)
                self.last_pipeline = pipe

            with _node_progress(pipe, t):
                composed = pipe.process(frames_norm[None], flow_masks[None], masks_dilated[None], canvas)

            # the composed canvas is the input's bytes inside the ring (its
            # dilated mask is 0 there), so it is the output whole; a copy, as
            # the pipeline's output is an inference tensor
            with span("node.finish"):
                with span("node.paste"):
                    image_out = _unit(composed.clone())
                with span("node.fetch"):
                    image_out, mask_out = _fetch(image_out), _fetch(masks_dilated[..., 0]).squeeze()
        return image_out, mask_out, cw, chh


NODE_CLASS_MAPPINGS = {
    "ProPainterInpaint": ProPainterInpaint,
    "ProPainterOutpaint": ProPainterOutpaint,
}

NODE_DISPLAY_NAME_MAPPINGS = {
    "ProPainterInpaint": "ProPainter Inpainting",
    "ProPainterOutpaint": "ProPainter Outpainting",
}
