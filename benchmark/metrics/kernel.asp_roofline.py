"""The bfloat16 attentive-statistics-pooling kernel (csrc/asp.cu
asp_bf16_kernel): the least time of its calls in the window over their
traced device time, in percent."""

from benchmark import readings


def read(ctx):
    if ctx["cfg"]["compute_dtype"] != "bfloat16":
        return None
    return readings.roofline_share(ctx, "asp_bf16_kernel", readings.asp_bound_s(ctx, "bfloat16"))
