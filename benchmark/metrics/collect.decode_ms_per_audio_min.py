"""Host milliseconds of the program's ``collect.decode`` spans (activations
and count to speech turns), per minute of audio."""

from benchmark import spans


def read(ctx):
    return spans.named_ms_per_audio_min(ctx, lambda name: name == "collect.decode")
