"""Host milliseconds of the program's ``dispatch.stage1`` spans (the
chunks to the device and the launch of stage 1), per minute of audio."""

from benchmark import spans


def read(ctx):
    return spans.named_ms_per_audio_min(ctx, lambda name: name == "dispatch.stage1")
