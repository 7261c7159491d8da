"""node_host_ms: the node layer's own time a clip (nodes.py: the ComfyUI
tensors to bytes, the crop plan, the upload, the fetch and the paste):
the benchmark's clip range less the program's blocking stage timers,
averaged over the traced window's clips."""


def read(ctx):
    stages = sum(v["seconds"] for v in ctx.stages.values())
    if not stages:
        return None
    wall = sum(c1 - c0 for c0, c1 in ctx.clips)
    return 1e3 * (wall - stages) / len(ctx.clips)
