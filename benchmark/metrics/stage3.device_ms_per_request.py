"""Device milliseconds of stage 3 on the card (StageTimings.stage3_ms), the
mean over the requests that ran it."""


def read(ctx):
    if not ctx["on_card"]:
        return None
    spans = [r.timings.stage3_ms for r in ctx["requests"] if r.timings.stage3_ms > 0.05]
    return sum(spans) / len(spans) if spans else None
