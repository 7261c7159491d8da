"""node_ms.prepare: the node's host work before the pipeline (nodes.py: the
ComfyUI tensors to bytes, the PIL resize, the inpaint node's crop plan,
the upload with the normalisation and the dilations), a clip: the
program's spans "node.prepare" that started in the traced window, summed
and divided by its clips (benchmark/core/spans.py)."""

from benchmark.core.spans import ms_per_clip

SPAN = "node.prepare"


def read(ctx):
    return ms_per_clip(ctx, SPAN)
