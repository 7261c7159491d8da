"""stage_ms.feature_propagation: the feature_propagation stage's time a clip, from the program's
stage timer (utils/profiling.py::stage_timer, blocking in the traced
window), averaged over the window's clips."""

STAGE = "feature_propagation"


def read(ctx):
    row = ctx.stages.get(STAGE)
    if not row or not row["calls"]:
        return None
    return 1e3 * row["seconds"] / len(ctx.clips)
