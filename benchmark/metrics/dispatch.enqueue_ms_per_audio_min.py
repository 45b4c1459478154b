"""Host milliseconds a request spends in prep and in launching its device
stages (StageTimings.segmentation: the dispatch never waits for the card),
per minute of audio."""

from benchmark import readings


def read(ctx):
    return 1000.0 * readings.span_sum(ctx, "segmentation") / readings.audio_min(ctx)
