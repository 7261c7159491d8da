"""node_ms.finish: the node's host work after the pipeline (nodes.py: the
fetch of the composed crop or bands, and the paste over the host's
frames, with the masks), a clip: the program's spans "node.finish" that
started in the traced window, summed and divided by its clips
(benchmark/core/spans.py)."""

from benchmark.core.spans import ms_per_clip

SPAN = "node.finish"


def read(ctx):
    return ms_per_clip(ctx, SPAN)
