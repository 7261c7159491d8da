"""raft_ms.refine: RAFT's update loop and convex upsampling
(models/raft.py::_refine: the 20 iterations with their corr lookups),
every RAFT call of the compute_flow stage, a clip: the program's spans
"raft.refine" that started in the traced window, summed and divided by
its clips (benchmark/core/spans.py)."""

from benchmark.core.spans import ms_per_clip

SPAN = "raft.refine"


def read(ctx):
    return ms_per_clip(ctx, SPAN)
