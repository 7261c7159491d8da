"""feature_ms.transformer: the feature stage's transformer
(models/propainter.py: soft split, the 8 blocks on B3/B4/B5 attention,
soft comp), every window group's call, a clip: the program's spans
"feature.transformer" that started in the traced window, summed and
divided by its clips (benchmark/core/spans.py)."""

from benchmark.core.spans import ms_per_clip

SPAN = "feature.transformer"


def read(ctx):
    return ms_per_clip(ctx, SPAN)
