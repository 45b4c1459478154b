"""The reader of ``dispatch.stage2_graph_share`` on synthetic span records:
the share of the window's stage-2 batches replayed from the program's
captured graph, summed over the requests; None where the program's
``dispatch.stage2`` spans carry no counters (an older program) or record no
spans at all."""

from __future__ import annotations

import importlib.util
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
NAME = "dispatch.stage2_graph_share"


def reader():
    spec = importlib.util.spec_from_file_location(NAME, ROOT / "benchmark" / "metrics" / f"{NAME}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def ctx_of(counters):
    """One request a counter set, each with the spans a dispatch records."""
    requests = []
    for c in counters:
        spans = [("dispatch", None, 0, 50, None), ("dispatch.prep", 0, 0, 2, None),
                 ("dispatch.stage1", 0, 2, 20, None), ("dispatch.stage2", 0, 20, 50, c),
                 ("collect", None, 50, 60, {"route": "host"})]
        requests.append(types.SimpleNamespace(timings=types.SimpleNamespace(spans=spans)))
    return {"requests": requests, "audio_s": 60.0 * len(requests)}


@pytest.mark.parametrize("counters,share", [
    ([{"batches": 12, "replayed": 12}, {"batches": 6, "replayed": 6}], 100.0),
    ([{"batches": 12, "replayed": 11}, {"batches": 4, "replayed": 0}], 100.0 * 11 / 16),
    ([{"batches": 12, "replayed": 0}], 0.0),
])
def test_bench_graph_share_reads_the_counters(counters, share):
    assert reader()(ctx_of(counters)) == pytest.approx(share)


def test_bench_graph_share_without_counters():
    """The parent program's spans carry no stage-2 counters."""
    assert reader()(ctx_of([None, None])) is None


def test_bench_graph_share_without_spans():
    ctx = ctx_of([None])
    ctx["requests"][0].timings = types.SimpleNamespace(segmentation=0.1)
    assert reader()(ctx) is None
