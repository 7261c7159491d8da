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

Nodes: `ProPainterInpaint` and `ProPainterOutpaint` (nodes.py), with the
JAX package's contract; each run reports progress and leaves a run record
(utils/profiling.py, utils/metrics.py).

Long videos: `pipeline/streaming.py::process_streaming` streams a clip
through the four stages with a working set of O(subvideo_length) frames,
bit for bit the in-memory run, fed by `utils/frameio.py::VideoSource`
(the native .npy reader of native/frameio.cpp).

Multi-device inference (parallel/): `make_mesh` lays the ranks of a
torch.distributed process group out as a (data, model) grid (NCCL where
each rank has a card, gloo where ranks share one or run on the CPU);
`Pipeline(..., mesh=)` splits the chunk loops and window groups over the
data ranks, and over the model ranks the transformer's frames (gathered
K/V, below 512 rows) or the frames' rows (the spatial H split,
parallel/spatial.py), and every rank returns the whole video. The nodes and streaming
take no mesh. `parallel/sharding.py` holds the weights' rule table.

Kernels (ops/cuda/, sources in csrc/), one for each of the JAX package's
seven Pallas kernels:
  B1 the RAFT correlation window lookup, both directions in one launch
     (corr_lookup.cu: the lanes blend, and the map-dtype blend of the
     JAX dispatcher's other branch);
  B2 the modulated deformable 3x3 conv (deform_conv.cu), also on a row
     slab of its output (`row0`, the H split's);
  B3 the occupancy-sparse window attention, single pass
     (window_attention.cu);
  B4 the segment-tiled window attention (window_attention_tiled.cu);
  B5 the halo window attention (window_attention_halo.cu);
  B6 the four-level padded-map correlation lookup and B7 its one-level
     form (corr_window.cu).
Each wrapper launches its kernel for CUDA tensors and takes its plain
PyTorch version for CPU tensors.
"""

from .nodes import NODE_CLASS_MAPPINGS, NODE_DISPLAY_NAME_MAPPINGS

__all__ = ["NODE_CLASS_MAPPINGS", "NODE_DISPLAY_NAME_MAPPINGS"]
