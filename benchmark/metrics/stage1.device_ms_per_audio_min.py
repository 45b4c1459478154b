"""Device milliseconds of stage 1 (StageTimings.stage1_ms, CUDA events
around its launch: any wait of the card for the host is in it), per
minute of audio."""

from benchmark import readings


def read(ctx):
    if not ctx["on_card"]:
        return None
    return readings.span_sum(ctx, "stage1_ms") / readings.audio_min(ctx)
