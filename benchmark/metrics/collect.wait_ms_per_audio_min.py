"""Host milliseconds blocked on the card in the collect: the program's
``collect.fetch.wait`` and ``collect.post.wait`` spans, each around one
stream synchronize, per minute of audio."""

from benchmark import spans


def read(ctx):
    return spans.named_ms_per_audio_min(
        ctx, lambda name: name.startswith("collect.") and name.endswith(".wait"))
