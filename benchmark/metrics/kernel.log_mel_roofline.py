"""The fused log-mel kernel (csrc/frontend.cu log_mel_kernel): the least
time of its calls in the window over their traced device time, in
percent."""

from benchmark import readings


def read(ctx):
    return readings.roofline_share(ctx, "log_mel_kernel", readings.log_mel_bound_s(ctx))
