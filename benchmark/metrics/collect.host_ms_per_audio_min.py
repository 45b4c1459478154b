"""Host milliseconds of collecting a request: the wait for and copy of what
the host needs, the host clustering (host route) and the decode
(StageTimings.fetch + clustering), per minute of audio."""

from benchmark import readings


def read(ctx):
    return 1000.0 * readings.span_sum(ctx, "fetch", "clustering") / readings.audio_min(ctx)
