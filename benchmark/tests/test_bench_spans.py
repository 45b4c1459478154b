"""The program's spans in the benchmark (``benchmark/spans.py`` and the
readers built on it): the clock fit on synthetic traces with a known
offset, a drift and extra synchronize calls, its refusal when the waits do
not land on the calls, the card's idle split on a synthetic window, and
each new reader's answer without a trace or without spans. A whole CPU run
of the tiny cell reads the span metrics. The card test fits one traced
group of requests: python3 -m pytest benchmark/tests -m cuda"""

from __future__ import annotations

import importlib.util
import json
import types
from pathlib import Path

import numpy as np
import pytest

from benchmark import run, spans
from benchmark.tests import tiny
from benchmark.trace import Trace

ROOT = Path(__file__).resolve().parents[2]
SPAN_READERS = ["dispatch.stage1_enqueue_ms_per_audio_min",
                "dispatch.stage2_enqueue_ms_per_audio_min", "collect.wait_ms_per_audio_min",
                "collect.cluster_ms_per_audio_min", "collect.decode_ms_per_audio_min"]
CARD_READERS = ["card.idle_in_dispatch_share", "card.idle_in_collect_share"]
OFFSET = 12.345678  # trace seconds at program second 0
NS = 1_000_000_000


def reader(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "benchmark" / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def request_spans(a: float, wait_s: float = 0.004):
    """One host-route request at program second ``a``: dispatch for 50 ms,
    collect for 10 ms, a wait of ``wait_s`` ending at 55 ms."""
    def ns(t):
        return int(round((a + t) * NS))

    return [
        ("dispatch", None, ns(0.0), ns(0.050), None),
        ("dispatch.prep", 0, ns(0.0), ns(0.002), None),
        ("dispatch.stage1", 0, ns(0.002), ns(0.020), None),
        ("dispatch.stage2", 0, ns(0.020), ns(0.050), None),
        ("collect", None, ns(0.050), ns(0.060), {"route": "host"}),
        ("collect.fetch", 4, ns(0.050), ns(0.055), None),
        ("collect.fetch.wait", 5, ns(0.055 - wait_s), ns(0.055), None),
        ("collect.cluster", 4, ns(0.055), ns(0.057), None),
        ("collect.decode", 4, ns(0.057), ns(0.060), None),
    ]


def synthetic(starts, to_trace=lambda t: t + OFFSET, jitter_s=2e-6, seed=0, extra=True):
    """(ctx, expected idle seconds in dispatch, in collect, in all): the
    card busy from 20 ms into each request to 55 ms; the trace's
    synchronize calls are the waits moved by ``to_trace``, each end moved by
    up to ``jitter_s``, plus calls the program's waits did not make."""
    rng = np.random.default_rng(seed)
    requests, syncs, device = [], [], []
    for a in starts:
        sp = request_spans(a, rng.uniform(0.001, 0.005))
        requests.append(types.SimpleNamespace(timings=types.SimpleNamespace(spans=sp)))
        ws, we = sp[6][2] / NS, sp[6][3] / NS
        syncs.append((to_trace(ws) + rng.uniform(-jitter_s, jitter_s),
                      to_trace(we) + rng.uniform(-jitter_s, jitter_s)))
        device.append(("kernel", to_trace(a + 0.020), to_trace(a + 0.055)))
    if extra:
        # other synchronize calls: one of a wait's length, others not
        for t, length in ((0.0815, 0.004), (0.0733, 0.0007), (0.0901, 0.002)):
            s = to_trace(starts[len(starts) // 2] + t)
            syncs.append((s, s + length))
    tr = Trace()
    tr.window = (to_trace(starts[0]), to_trace(starts[-1] + 0.1))
    tr.device = device
    tr.host = sorted([("cudaStreamSynchronize", s, e) for s, e in syncs]
                     + [("cudaLaunchKernel", s - 1e-4, s - 9e-5) for s, _ in syncs])
    ctx = {"requests": requests, "trace": tr, "audio_s": 60.0 * len(starts),
           "window_s": tr.window_s, "on_card": True}
    n = len(starts)
    return ctx, 0.020 * n, 0.005 * n, tr.window_s - tr.busy_s()


def test_bench_spans_fit_finds_a_known_offset_among_extra_calls():
    ctx, *_ = synthetic([100.0 + 0.1 * k for k in range(10)])
    fit = spans.clock_fit(ctx)
    assert fit.ok and fit.matched == fit.waits == 10
    assert fit.rate == 1.0
    assert abs(fit.at(100.0) - (100.0 + OFFSET)) < 5e-6
    assert fit.worst_s() < 1e-5


def test_bench_spans_fit_takes_a_rate_when_the_clocks_drift():
    rate = 1 + 40e-6  # 0.4 ms over the ~10 s window: past the tolerance
    starts = 100.0 + np.cumsum(np.random.default_rng(2).uniform(0.1, 1.9, 11))
    ctx, *_ = synthetic(list(starts), to_trace=lambda t: OFFSET + 100.0 + rate * (t - 100.0))
    fit = spans.clock_fit(ctx)
    assert fit.ok and fit.matched == 11
    assert fit.rate == pytest.approx(rate, abs=2e-6)
    assert fit.worst_s() < 1e-5


def test_bench_spans_fit_refuses_wide_residuals():
    ctx, *_ = synthetic([100.0 + 0.1 * k for k in range(20)], jitter_s=3e-4, seed=1)
    fit = spans.clock_fit(ctx)
    assert fit is not None and not fit.ok
    assert fit.matched < spans.MIN_SHARE * fit.waits
    for name in CARD_READERS:
        assert reader(name)(ctx) is None


def test_bench_spans_idle_split():
    ctx, in_dispatch, in_collect, idle = synthetic([100.0 + 0.1 * k for k in range(10)])
    window = ctx["trace"].window_s
    got_d = reader("card.idle_in_dispatch_share")(ctx)
    got_c = reader("card.idle_in_collect_share")(ctx)
    assert got_d == pytest.approx(100.0 * in_dispatch / window, abs=0.01)
    assert got_c == pytest.approx(100.0 * in_collect / window, abs=0.01)
    idle_share = reader("card.idle_share")(ctx)
    assert idle_share == pytest.approx(100.0 * idle / window)
    assert got_d + got_c <= idle_share
    assert spans.coverage(ctx) == pytest.approx(0.6, abs=1e-3)
    assert spans.route_shares(ctx) == {"host": 1.0}


def test_bench_spans_overlap_clips_to_the_spans_and_window():
    gaps = [(0.0, 1.0), (2.0, 3.0), (4.0, 5.0)]
    assert spans.overlap_s(gaps, [(0.5, 4.5)], 0.0, 5.0) == pytest.approx(2.0)
    assert spans.overlap_s(gaps, [(2.2, 2.4), (2.6, 2.7)], 0.0, 5.0) == pytest.approx(0.3)
    assert spans.overlap_s(gaps, [(1.0, 2.0)], 0.0, 5.0) == 0.0
    assert spans.overlap_s(gaps, [(-1.0, 9.0)], 0.5, 4.2) == pytest.approx(0.5 + 1.0 + 0.2)


def test_bench_spans_span_readers():
    ctx, *_ = synthetic([100.0 + 0.1 * k for k in range(10)])
    # ten requests over ten audio minutes: each span's ms a request
    waits = [s[3] - s[2] for r in ctx["requests"] for s in r.timings.spans if s[1] == 5]
    want = {"dispatch.stage1_enqueue_ms_per_audio_min": 18.0,
            "dispatch.stage2_enqueue_ms_per_audio_min": 30.0,
            "collect.wait_ms_per_audio_min": 1e-6 * sum(waits) / 10,
            "collect.cluster_ms_per_audio_min": 2.0, "collect.decode_ms_per_audio_min": 3.0}
    for name, value in want.items():
        assert reader(name)(ctx) == pytest.approx(value, abs=1e-6), name


@pytest.mark.parametrize("name", SPAN_READERS + CARD_READERS)
def test_bench_spans_readers_without_spans(name):
    """A program that records no spans (an older one) reads None."""
    ctx, *_ = synthetic([100.0, 100.1])
    for r in ctx["requests"]:
        r.timings = types.SimpleNamespace(segmentation=0.1, fetch=0.0, clustering=0.0)
    assert reader(name)(ctx) is None


@pytest.mark.parametrize("name", CARD_READERS)
def test_bench_spans_card_readers_without_a_trace(name):
    ctx, *_ = synthetic([100.0, 100.1])
    ctx["trace"] = Trace()
    assert reader(name)(ctx) is None


def test_bench_spans_a_cpu_run_reads_the_span_metrics(capsys):
    rc = run.main(tiny.argv(7, trace=1), device="cpu", cell_override=tiny.cell({"num_speakers": 2}))
    assert rc == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for name in SPAN_READERS:
        assert got["metrics"][name]["value"] > 0, name
    for name in CARD_READERS:
        assert name not in got["metrics"]


@pytest.mark.cuda
def test_bench_spans_fit_on_the_card():
    """One group of host-route requests at the test widths under the
    harness's CUDA-only profiler: every wait lands on a
    cudaStreamSynchronize within the tolerance at both ends."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the fit reads the card's trace")
    from benchmark import trace, traffic as T

    device = torch.device("cuda", 0)
    cfg = json.loads((tiny.DATA / "tiny-config.json").read_text())
    traffic = json.loads((tiny.DATA / "tiny-traffic.json").read_text())
    pipe = run.build_pipeline(cfg, None, device)
    drv = run.Driver(pipe, {"num_speakers": 2})
    audios = [T.recording(traffic, s, 3, i, device) for i, s in enumerate((12.27, 21.27, 9.27))]
    drv.group(audios)
    with trace.traced(torch, True, 0.5) as tr:
        done = drv.group(audios)
    ctx = {"requests": [types.SimpleNamespace(timings=t) for _, _, t in done], "trace": tr,
           "audio_s": sum(len(a) for a in audios) / cfg["sample_rate"]}
    fit = spans.clock_fit(ctx)
    assert fit is not None and fit.waits == 2 * len(audios)
    assert fit.matched == fit.waits and fit.worst_s() <= spans.TOL_S, fit
    assert 0.0 <= spans.coverage(ctx) <= 1.0
