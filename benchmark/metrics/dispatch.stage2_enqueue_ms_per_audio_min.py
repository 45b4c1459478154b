"""Host milliseconds of the program's ``dispatch.stage2`` spans (the launch
of stage 2), per minute of audio."""

from benchmark import spans


def read(ctx):
    return spans.named_ms_per_audio_min(ctx, lambda name: name == "dispatch.stage2")
