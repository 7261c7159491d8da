"""raft_ms.encode: RAFT's encoders (models/raft.py: fnet, cnet and the
correlation pyramids), every RAFT call of the compute_flow stage, a
clip: the program's spans "raft.encode" that started in the traced
window, summed and divided by its clips (benchmark/core/spans.py)."""

from benchmark.core.spans import ms_per_clip

SPAN = "raft.encode"


def read(ctx):
    return ms_per_clip(ctx, SPAN)
