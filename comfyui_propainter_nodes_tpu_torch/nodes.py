"""ComfyUI node API for the PyTorch port.

`ProPainterInpaint` has the same INPUT_TYPES / RETURN_TYPES /
RETURN_NAMES / FUNCTION / CATEGORY contract as the reference (and the
JAX package), so workflow JSONs run unchanged. It runs on the card:
`ProPainterInpaint()` resolves to CUDA and raises when there is none;
`ProPainterInpaint(device="cpu")` runs the plain versions of the kernels
on the host. Outputs are CPU torch tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import ImageConfig, PipelineConfig
from .ops.dilation import binary_dilation
from .pipeline.stages import Pipeline
from .utils import weights as weights_zoo
from .utils.image import resize_frames

_PIPELINE_CACHE: dict = {}
_PARAM_CACHE: dict = {}


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
            "ProPainterInpaint runs on a CUDA device and none is available; "
            'pass device="cpu" to run the plain (kernel-free) path on the host'
        )
    return dev


def _cached_params(model: str, allow_random: bool) -> dict:
    key = (model, allow_random)
    if key not in _PARAM_CACHE:
        _PARAM_CACHE[key] = weights_zoo.get_params(model, allow_random=allow_random)
    return _PARAM_CACHE[key]


def get_pipeline(config: PipelineConfig, device, allow_random_weights: bool = False) -> Pipeline:
    """Pipeline with weights loaded once, cached per (config, device)."""
    key = (config, str(device), allow_random_weights)
    if key not in _PIPELINE_CACHE:
        _PIPELINE_CACHE[key] = Pipeline(
            _cached_params("raft", allow_random_weights),
            _cached_params("flow_completion", allow_random_weights),
            _cached_params("inpaint_generator", allow_random_weights),
            config,
            device,
        )
    return _PIPELINE_CACHE[key]


class ProPainterInpaint:
    """ComfyUI Node for performing inpainting on video frames using ProPainter."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.last_pipeline: Pipeline | None = None

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
        dev = self.device

        # host resize (PIL bicubic, as the reference); on-device otherwise
        frames_r = _host_resize_u8(frames_u8, pw, ph)
        masks_r = _host_resize_u8(masks_u8, pw, ph)
        if frames_r is not None and masks_r is not None:
            byte = torch.from_numpy(np.ascontiguousarray(frames_r)).to(dev).float()
            base = torch.from_numpy(np.ascontiguousarray(masks_r) != 0).to(dev).float()
        else:
            byte = resize_frames(torch.from_numpy(np.ascontiguousarray(frames_u8)).to(dev).float(), pw, ph)
            m = torch.from_numpy(np.ascontiguousarray(masks_u8)).to(dev).float()[..., None]
            base = (resize_frames(m, pw, ph)[..., 0] > 0.5).float()
        frames_norm = byte / 255.0 * 2.0 - 1.0
        flow_masks = binary_dilation(base, flow_mask_dilates) if flow_mask_dilates > 0 else base
        masks_dilated = binary_dilation(base, mask_dilates) if mask_dilates > 0 else base

        pipe = get_pipeline(config, dev, _allow_random_weights)
        self.last_pipeline = pipe
        composed = pipe.process(
            frames_norm[None], flow_masks[None, ..., None], masks_dilated[None, ..., None], byte
        )
        out_images = composed.to(torch.uint8).cpu().float() / 255.0
        return (
            out_images,
            flow_masks.float().cpu().squeeze(),
            masks_dilated.float().cpu().squeeze(),
        )


NODE_CLASS_MAPPINGS = {"ProPainterInpaint": ProPainterInpaint}

NODE_DISPLAY_NAME_MAPPINGS = {"ProPainterInpaint": "ProPainter Inpainting"}
