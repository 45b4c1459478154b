"""Device kernels in the traced window (torch.profiler: a CUDA graph's
replayed kernels count too), per minute of audio."""

from benchmark import readings


def read(ctx):
    kernels = ctx["trace"].kernels()
    return len(kernels) / readings.audio_min(ctx) if kernels else None
