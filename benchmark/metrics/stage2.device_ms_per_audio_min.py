"""Device milliseconds of stage 2 (StageTimings.stage2_ms), per minute of
audio."""

from benchmark import readings


def read(ctx):
    if not ctx["on_card"]:
        return None
    return readings.span_sum(ctx, "stage2_ms") / readings.audio_min(ctx)
