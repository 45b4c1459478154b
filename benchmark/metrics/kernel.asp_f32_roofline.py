"""The float32 attentive-statistics-pooling kernel (csrc/asp.cu
asp_f32_kernel, 3xTF32): the least time of its calls in the window over
their traced device time, in percent."""

from benchmark import readings


def read(ctx):
    if ctx["cfg"]["compute_dtype"] != "float32":
        return None
    return readings.roofline_share(ctx, "asp_f32_kernel", readings.asp_bound_s(ctx, "float32"))
