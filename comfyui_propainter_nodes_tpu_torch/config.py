"""Frozen config tree for the pipeline.

Re-declares the JAX package's `ImageConfig` / `OutpaintConfig` /
`PipelineConfig` so the port needs nothing from it. Same fields, same
defaults, same derived properties: a config means the same run in both
packages.
"""

from __future__ import annotations

from dataclasses import dataclass


def _mod8(v: int) -> int:
    return v - v % 8


@dataclass(frozen=True)
class ImageConfig:
    """Process-size derivation (reference utils/image_utils.py:12-27)."""

    width: int = 640
    height: int = 360
    mask_dilates: int = 5
    flow_mask_dilates: int = 8

    @property
    def process_size(self) -> tuple[int, int]:
        return (_mod8(self.width), _mod8(self.height))


@dataclass(frozen=True)
class OutpaintConfig(ImageConfig):
    """Adds the scaled outpaint canvas (reference utils/image_utils.py:30-49)."""

    width_scale: float = 1.2
    height_scale: float = 1.0

    @property
    def outpaint_size(self) -> tuple[int, int]:
        return (
            _mod8(int(self.width_scale * self.width)),
            _mod8(int(self.height_scale * self.height)),
        )


@dataclass(frozen=True)
class PipelineConfig:
    """Driver knobs (reference propainter_inference.py:17-33 + node widgets
    propainter_nodes.py:44-78)."""

    ref_stride: int = 10
    neighbor_length: int = 10
    subvideo_length: int = 80
    raft_iter: int = 20
    fp16: str = "enable"  # -> bfloat16 for all three networks
    process_size: tuple[int, int] = (640, 360)  # (W, H)
    # RAFT compute dtype. bf16 keeps fp32's exponent range, so fp16="enable"
    # extends to RAFT (params, convs and the correlation volume). Flow state
    # (coords), convex upsampling and the returned flows stay fp32 either
    # way. None = follow the fp16 knob; True/False pins it explicitly.
    raft_bf16: bool | None = None

    @property
    def use_bf16(self) -> bool:
        return self.fp16 == "enable"

    @property
    def raft_half(self) -> bool:
        return self.use_bf16 if self.raft_bf16 is None else self.raft_bf16

    @property
    def neighbor_stride(self) -> int:
        return self.neighbor_length // 2

    def raft_chunk_len(self) -> int:
        """Width-bucketed RAFT clip chunking
        (reference propainter_inference.py:65-72)."""
        w = self.process_size[0]
        if w <= 640:
            return 12
        if w <= 720:
            return 8
        if w <= 1280:
            return 4
        return 2
