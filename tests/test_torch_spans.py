"""The port's per-request span record (``StageTimings.request`` and
``StageTimings.spans``), on the CPU with the tiny1s pipeline.

A request records the root spans ``dispatch`` and ``collect`` and their
children at each layer boundary; every child lies inside its parent and
siblings do not overlap; a request's record carries its own id; a reused
StageTimings holds one request's spans; the JAX fields keep what they
measured, inside their spans' bounds; the ``collect`` root counts the route
taken; ``map`` gives one record per request.
"""

import numpy as np
import pytest
import torch

from _torch_cfg import make_tiny1s_pipeline
from _torch_threads import two_torch_threads  # noqa: F401
from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines.diarization import (
    StageTimings,
    to_host,
)

DISPATCH = ["dispatch", "dispatch.prep", "dispatch.stage1", "dispatch.stage2"]
ROUTES = {
    "device": DISPATCH + ["dispatch.stage3", "collect", "collect.fetch", "collect.fetch.wait",
                          "collect.decode"],
    "host": DISPATCH + ["collect", "collect.fetch", "collect.fetch.wait", "collect.cluster",
                        "collect.post", "collect.post.wait", "collect.decode"],
}
# the call's bounds that send a request down each route
BOUNDS = {"device": {}, "host": {"num_speakers": 2}}


def _audio(seconds=5.0, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    x = 0.3 * np.sin(2 * np.pi * 220.0 * t) * (t % 2 < 1) + 0.1 * rng.normal(size=t.shape)
    return x.astype(np.float32)


def _turns(annotation):
    return [(t.start, t.end, t.label) for t in annotation.turns()]


def _by_name(timings):
    return {s.name: s for s in timings.spans}


@pytest.fixture(scope="module")
def pipe():
    return make_tiny1s_pipeline(device="cpu")


@pytest.fixture(scope="module")
def records(pipe):
    """route -> the StageTimings of one request down that route."""
    out = {}
    for route, bounds in BOUNDS.items():
        t = StageTimings()
        pipe._collect(pipe._dispatch(_audio(), timings=t, **bounds), timings=t, **bounds)
        out[route] = t
    return out


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_each_route_records_its_spans(records, route):
    t = records[route]
    assert [s.name for s in t.spans] == ROUTES[route]
    assert all(s.end_ns >= s.start_ns > 0 for s in t.spans)
    roots = [s.name for s in t.spans if s.parent is None]
    assert roots == ["dispatch", "collect"]
    for s in t.spans:
        if s.parent is not None:
            assert s.name.startswith(t.spans[s.parent].name + ".")


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_children_nest_and_siblings_do_not_overlap(records, route):
    spans = records[route].spans
    for s in spans:
        if s.parent is not None:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns, (s, p)
    for parent in {s.parent for s in spans}:
        kids = sorted((s.start_ns, s.end_ns) for s in spans if s.parent == parent)
        assert all(a[1] <= b[0] for a, b in zip(kids, kids[1:])), kids


def test_each_request_has_its_own_id(pipe, records):
    ids = [records[r].request for r in sorted(records)]
    assert None not in ids and len(set(ids)) == len(ids)
    t = StageTimings()
    pending = pipe._dispatch(_audio(2.0), timings=t)
    assert pending["request"] == t.request and t.request not in ids
    pipe._collect(pending, timings=t)
    assert t.request == pending["request"]


def test_a_reused_record_holds_the_last_request_alone(pipe):
    pipe(_audio(seed=3))
    first = pipe.timings.request
    pipe(_audio(seed=4), num_speakers=2)
    t = pipe.timings
    assert t.request != first
    assert [s.name for s in t.spans] == ROUTES["host"]


def test_a_collect_for_another_request_starts_the_record_anew(pipe):
    """Two dispatches into one record, then their collects: each collect
    leaves that request's collect spans alone in the record."""
    t = StageTimings()
    a = pipe._dispatch(_audio(2.0, seed=5), timings=t)
    b = pipe._dispatch(_audio(2.0, seed=6), timings=t)
    assert t.request == b["request"]
    pipe._collect(a, timings=t)
    assert t.request == a["request"]
    assert [s.name for s in t.spans if s.parent is None] == ["collect"]


def _length_s(span):
    return (span.end_ns - span.start_ns) * 1e-9


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_the_jax_fields_lie_within_their_spans(records, route):
    t = records[route]
    n = _by_name(t)
    # segmentation runs from after the load to the dispatch's end
    assert _length_s(n["dispatch"]) - _length_s(n["dispatch.prep"]) <= t.segmentation
    assert t.segmentation <= _length_s(n["dispatch"])
    assert t.embedding == 0.0
    assert t.fetch == pytest.approx(_length_s(n["collect.fetch"]), abs=1e-9)
    first = n["collect.cluster"] if route == "host" else n["collect.decode"]
    want = (n["collect.decode"].end_ns - first.start_ns) * 1e-9
    assert t.clustering == pytest.approx(want, abs=1e-9)
    assert t.clustering <= _length_s(n["collect"])


def test_profiled_stage_spans_hold_the_jax_fields(pipe):
    pipe.profile = True
    try:
        pipe(_audio(seed=7))
        t = pipe.timings
    finally:
        pipe.profile = False
    n = _by_name(t)
    assert t.embedding == pytest.approx(_length_s(n["dispatch.stage2"]), abs=1e-9)
    assert _length_s(n["dispatch.stage1"]) <= t.segmentation
    assert t.segmentation <= _length_s(n["dispatch.prep"]) + _length_s(n["dispatch.stage1"])
    assert [s.name for s in t.spans] == ROUTES["device"]


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_the_collect_root_counts_its_route(records, route):
    counted = {s.name: s.counters for s in records[route].spans if s.counters}
    assert set(counted) == {"dispatch.stage2", "collect"}
    assert counted["collect"] == {"route": route}
    # on the CPU every stage-2 batch runs eagerly
    assert counted["dispatch.stage2"]["replayed"] == 0
    assert counted["dispatch.stage2"]["batches"] > 0


def test_device_stage3_sent_to_the_host_counts_both(pipe):
    t = StageTimings()
    pending = pipe._dispatch(_audio(4.0, seed=44), timings=t)
    assert pending["device_clu"] is not None
    pending["device_clu"]["num_large"] = torch.tensor(0, dtype=torch.int32)
    pipe._collect(pending, timings=t)
    n = _by_name(t)
    assert n["collect"].counters == {"route": "device_then_host"}
    assert [s.name for s in t.spans].count("collect.fetch") == 2
    assert "collect.cluster" in n and "dispatch.stage3" in n


def test_to_host_records_its_wait_on_the_cpu():
    t = StageTimings()
    parent = t.begin("collect.fetch")
    (got,) = to_host(torch.arange(3), timings=t, parent=parent)
    t.end(parent)
    assert got.tolist() == [0, 1, 2]
    wait = t.spans[1]
    assert wait.name == "collect.fetch.wait" and wait.parent == parent
    assert 0 <= wait.end_ns - wait.start_ns < 5_000_000


def test_map_keeps_one_record_per_request(pipe):
    clips = [_audio(3.0, seed=8), _audio(4.0, seed=9), _audio(2.0, seed=10)]
    want = [_turns(pipe(c)) for c in clips]
    got_records = []
    mapped = pipe.map(clips, timings=got_records)
    assert [_turns(a) for a in mapped] == want
    assert len(got_records) == len(clips)
    assert len({r.request for r in got_records}) == len(clips)
    for r in got_records:
        assert [s.name for s in r.spans] == ROUTES["device"]
        assert r.segmentation > 0 and r.fetch > 0
    # the pipeline's own record is a copy of the last request's
    last = got_records[-1]
    assert pipe.timings is not last and pipe.timings.request == last.request
    assert pipe.timings.spans == last.spans and pipe.timings.fetch == last.fetch


def test_map_without_a_list_behaves_as_before(pipe):
    clips = [_audio(3.0, seed=11), _audio(2.0, seed=12)]
    want = [_turns(pipe(c)) for c in clips]
    assert [_turns(a) for a in pipe.map(clips)] == want
    assert [s.name for s in pipe.timings.spans] == ROUTES["device"]
    assert pipe.timings.segmentation > 0
