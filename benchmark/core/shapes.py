"""Shapes the kernel readers count their bounds from, read off a cell's
widgets alone."""


def canvas_hw(ctx):
    """(height, width) of the canvas the networks run on, each a multiple
    of 8: the node's size, or for outpaint the size the scales give."""
    w = ctx.widgets
    if ctx.kind == "outpaint":
        return int(w["height_scale"] * w["height"]) // 8 * 8, int(w["width_scale"] * w["width"]) // 8 * 8
    return w["height"] // 8 * 8, w["width"] // 8 * 8
