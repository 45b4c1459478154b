"""The pipeline's ``profile=`` mode in the port, on the CPU (the JAX
package's tests/test_pipeline.py holds the same mode there).

With ``profile`` True, ``timings.segmentation`` and ``timings.embedding``
are per-stage spans and ``fetch`` is what is left: each is > 0, ``total``
is the sum of the four host spans, and the turns are those of an
unprofiled request. Switched off, ``embedding`` is 0.0 again. The port's
StageTimings keeps the JAX package's fields in their order.
"""

import dataclasses

import numpy as np
import pytest

from _torch_cfg import make_tiny1s_pipeline
from _torch_threads import two_torch_threads  # noqa: F401
from pyannote_audio_speaker_diarization_cpp_tpu.pipelines.diarization import (
    StageTimings as JaxStageTimings,
)
from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines.diarization import (
    StageTimings,
)


def _audio(seconds=5.0, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    x = 0.3 * np.sin(2 * np.pi * 220.0 * t) * (t % 2 < 1) + 0.1 * rng.normal(size=t.shape)
    return x.astype(np.float32)


def _turns(annotation):
    return [(t.start, t.end, t.label) for t in annotation.turns()]


@pytest.fixture(scope="module")
def pipe():
    return make_tiny1s_pipeline(device="cpu")


def test_profile_spans_each_stage(pipe):
    audio = _audio()
    plain = _turns(pipe(audio))
    assert pipe.timings.embedding == 0.0
    pipe.profile = True
    try:
        profiled = _turns(pipe(audio))
        t = pipe.timings
    finally:
        pipe.profile = False
    assert t.segmentation > 0 and t.embedding > 0 and t.fetch > 0
    assert t.total == t.segmentation + t.embedding + t.fetch + t.clustering
    assert profiled == plain
    # switched off, no stale span is left
    assert _turns(pipe(audio)) == plain
    assert pipe.timings.embedding == 0.0
    assert pipe.timings.segmentation > 0 and pipe.timings.fetch > 0


def test_profile_on_the_host_route(pipe):
    """With a speaker bound (the host clusterer), the spans are the same."""
    audio = _audio(seed=1)
    pipe.profile = True
    try:
        profiled = _turns(pipe(audio, num_speakers=2))
        t = pipe.timings
    finally:
        pipe.profile = False
    assert t.segmentation > 0 and t.embedding > 0 and t.fetch > 0
    assert profiled == _turns(pipe(audio, num_speakers=2))


def test_constructor_takes_profile():
    pipe = make_tiny1s_pipeline(device="cpu", profile=True)
    assert pipe.profile is True
    pipe(_audio(2.0))
    assert pipe.timings.embedding > 0


def test_stage_timings_keep_the_jax_fields_in_order():
    jax_fields = [f.name for f in dataclasses.fields(JaxStageTimings)]
    port_fields = [f.name for f in dataclasses.fields(StageTimings)]
    positions = [port_fields.index(name) for name in jax_fields]
    assert positions == sorted(positions)
    empty = StageTimings()
    assert empty.total == 0.0 and empty.embedding == 0.0
