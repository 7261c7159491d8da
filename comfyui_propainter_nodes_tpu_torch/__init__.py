"""ProPainter video inpainting in PyTorch, with hand-written CUDA kernels
for Hopper (sm_90a).

A port of the JAX package `comfyui_propainter_nodes_tpu`, which stays the
reference; this package imports nothing of it and never imports jax.

Layouts: public functions keep the JAX package's layouts so the two can
be compared on the same inputs: activations NHWC ([N, H, W, C], video
[B, T, H, W, C]), deformable-conv offsets [N, H, W, G, K, 2] in (dy, dx)
order, flows (dx, dy). Weights are upstream (torch state-dict) layout:
conv OIHW, conv3d OIDHW, linear (out, in). Convs view NHWC activations
as channels-last NCHW for cuDNN.

Kernels (ops/cuda/, sources in csrc/): the RAFT correlation lookup, the
modulated deformable conv and the occupancy-sparse window attention.
Each wrapper launches its kernel for CUDA tensors and takes its plain
PyTorch version for CPU tensors.
"""

from .nodes import NODE_CLASS_MAPPINGS, NODE_DISPLAY_NAME_MAPPINGS

__all__ = ["NODE_CLASS_MAPPINGS", "NODE_DISPLAY_NAME_MAPPINGS"]
