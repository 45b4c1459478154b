"""Share of the window's stage-2 batches that the program ran as a replay of
its captured CUDA graph, in percent: the ``replayed`` and ``batches``
counters of the program's ``dispatch.stage2`` spans, summed over the
window's requests. None when the program records no such counters (an
older one)."""

from benchmark import spans


def read(ctx):
    counted = [s[4] for rs in (spans.requests_spans(ctx) or []) for s in rs
               if s[0] == "dispatch.stage2" and s[4] and "batches" in s[4]]
    batches = sum(c["batches"] for c in counted)
    if not batches:
        return None
    return 100.0 * sum(c["replayed"] for c in counted) / batches
