"""The analytic FLOPs of the window's recordings (PyanNet on every window,
ECAPA-TDNN on every (window, local speaker) row; benchmark/roofline.py)
over the window's wall time and the card's peak in the ECAPA trunk's
precision (bfloat16 989 TFLOP/s, float32 67 TFLOP/s), in percent."""

from benchmark import roofline


def read(ctx):
    if not ctx["on_card"]:
        return None
    cfg = ctx["cfg"]
    peak = roofline.PEAK_FLOPS[cfg["compute_dtype"]]
    flops = sum(roofline.recording_flops(r.num_chunks, cfg) for r in ctx["requests"])
    return 100.0 * flops / (ctx["window_s"] * peak)
