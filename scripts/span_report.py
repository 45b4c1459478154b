"""Run one benchmark cell traced and report what its span readers rest on:
the clock fit of the program's wait spans onto the trace's
``cudaStreamSynchronize`` calls (pairs, rate, residuals), the root spans'
coverage of the window, the collect routes, the card's idle put down to
the innermost program span open at each moment, the stage-2 batches
replayed from the program's captured graph, and the host cost of the span
record itself. Imports no JAX; needs the card.

    python3 scripts/span_report.py --workload v2.1-calls --seed 8100000011 \\
        --seconds 20 [--out spans-v2.1-calls.json]

The benchmark's own result line is printed first, as ``benchmark.run``
prints it; the report is the last line (and ``--out``).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import run, spans  # noqa: E402


def idle_by_span(ctx, fit):
    """{innermost span name or "outside": idle seconds of the card} over the
    traced window: the window is cut at every span boundary, each piece goes
    to the deepest span open over it, and each name gets the trace's idle
    stretches inside its pieces."""
    tr = ctx["trace"]
    lo, hi = tr.window
    marks = [(fit.at(s[2] * 1e-9), fit.at(s[3] * 1e-9), _depth(rs, s), s[0])
             for rs in spans.requests_spans(ctx) for s in rs]
    cuts = sorted({lo, hi} | {t for m in marks for t in m[:2] if lo < t < hi})
    pieces = {}
    for a, b in zip(cuts, cuts[1:]):
        mid = 0.5 * (a + b)
        open_ = [m for m in marks if m[0] <= mid < m[1]]
        name = max(open_, key=lambda m: m[2])[3] if open_ else "outside"
        pieces.setdefault(name, []).append((a, b))
    gaps = tr.gaps()
    out = {name: spans.overlap_s(gaps, ps, lo, hi) for name, ps in pieces.items()}
    return {k: out[k] for k in sorted(out, key=lambda k: -out[k])}


def _depth(rs, s):
    depth, p = 0, s[1]
    while p is not None:
        depth, p = depth + 1, rs[p][1]
    return depth


def record_cost_ns(n: int = 200_000) -> float:
    """Host nanoseconds of one span (a begin and an end) in the program's
    record, 12 spans a request."""
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines.diarization import (
        StageTimings,
    )

    t = StageTimings()
    t0 = time.perf_counter_ns()
    for k in range(n):
        if k % 12 == 0:
            t.restart(k)
        t.end(t.begin("collect.fetch.wait", 0))
    return (time.perf_counter_ns() - t0) / n


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--out")
    args = ap.parse_args()

    seen = {}
    load = run.load_reader

    def load_reader(name):
        read = load(name)

        def wrapped(ctx):
            seen["ctx"] = ctx
            return read(ctx)

        return wrapped

    run.load_reader = load_reader
    rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--trace", "1"])
    if rc != 0 or "ctx" not in seen:
        return rc or 1
    ctx = seen["ctx"]
    tr = ctx["trace"]
    fit = spans.clock_fit(ctx)
    report = {"workload": args.workload, "seed": args.seed, "window_s": tr.window_s}
    syncs = [h for h in tr.host if h[0] == spans.SYNC]
    report["trace_syncs"] = len(syncs)
    if fit is not None:
        res_us = sorted(1e6 * max(abs(a), abs(b)) for a, b in fit.residuals)
        report["fit"] = {
            "waits": fit.waits, "matched": fit.matched, "ok": fit.ok, "rate": fit.rate,
            "residual_us": {"median": statistics.median(res_us) if res_us else None,
                            "p95": res_us[int(0.95 * (len(res_us) - 1))] if res_us else None,
                            "max": res_us[-1] if res_us else None},
        }
        if fit.ok:
            report["coverage"] = spans.coverage(ctx)
            idle = idle_by_span(ctx, fit)
            report["idle_ms_per_audio_min"] = {
                k: 1e3 * v / (ctx["audio_s"] / 60.0) for k, v in idle.items()}
            report["idle_share_pct"] = 100.0 * (1.0 - tr.busy_s() / tr.window_s)
            report["idle_in_pct"] = {r: spans.idle_share_in(ctx, r) for r in ("dispatch", "collect")}
            longest = sorted(tr.gaps(), key=lambda g: g[0] - g[1])[:10]
            report["longest_gaps"] = [
                [round(1e3 * (e - s), 3), _innermost(ctx, fit, 0.5 * (s + e))] for s, e in longest]
    per_request = [len(rs) for rs in spans.requests_spans(ctx)]
    enqueue = [r.timings.segmentation for r in ctx["requests"]]
    cost = record_cost_ns()
    report["routes"] = spans.route_shares(ctx)
    report["stage2_replayed_of_batches"] = replayed_of_batches(ctx)
    report["spans_per_request"] = statistics.mean(per_request)
    report["record_ns_per_span"] = cost
    report["record_us_per_request"] = 1e-3 * cost * statistics.mean(per_request)
    report["record_share_of_enqueue"] = (
        1e-9 * cost * statistics.mean(per_request) / statistics.mean(enqueue))
    line = json.dumps(report)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


def replayed_of_batches(ctx):
    """[replayed, batches] of the window's stage-2 batches, from the
    ``dispatch.stage2`` spans' counters; None when they carry none."""
    counted = [s[4] for rs in spans.requests_spans(ctx) for s in rs
               if s[0] == "dispatch.stage2" and s[4]]
    if not counted:
        return None
    return [sum(c["replayed"] for c in counted), sum(c["batches"] for c in counted)]


def _innermost(ctx, fit, t):
    open_ = [(_depth(rs, s), s[0]) for rs in spans.requests_spans(ctx) for s in rs
             if fit.at(s[2] * 1e-9) <= t < fit.at(s[3] * 1e-9)]
    return max(open_)[1] if open_ else "outside"


if __name__ == "__main__":
    sys.exit(main())
