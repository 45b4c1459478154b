"""Host milliseconds of the program's ``collect.cluster`` spans (the host
clusterer and the membership build, host route), per minute of audio."""

from benchmark import spans


def read(ctx):
    return spans.named_ms_per_audio_min(ctx, lambda name: name == "collect.cluster")
