"""Share of the traced window in which the card was idle while the host
was inside a request's ``dispatch`` span, in percent: the trace's idle
stretches inside the program's ``dispatch`` roots, placed on the device
clock by the wait spans' fit (benchmark/spans.py). None without a trace
or a fit that checks."""

from benchmark import spans


def read(ctx):
    return spans.idle_share_in(ctx, "dispatch")
