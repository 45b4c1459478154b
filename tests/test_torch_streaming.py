"""The port's StreamingDiarizer (pipelines/streaming.py) on the CPU: the JAX
package's streaming cases run against the port, then the port's stream
against the JAX package's stream on the same weights and blocks.

The flush's exactness contract is against the offline HOST-clustering
request (device_clustering=False), string for string; against the default
device route it is partition-equivalent. Emissions of the two packages'
streams agree as the two pipelines do end to end: turns equal up to a
permutation of the labels, stored scores and embeddings at rtol 1e-3 /
atol 1e-4, stored binarized scores exactly."""

import dataclasses
import os

import numpy as np
import pytest

from _cfg import TINY1S_CFG
from _torch_threads import two_torch_threads  # noqa: F401
from test_torch_pipeline import RTOL, ATOL, build_pair, port_config, same_turns
from pyannote_audio_speaker_diarization_cpp_tpu.config import DEFAULT_CONFIG
from pyannote_audio_speaker_diarization_cpp_tpu.models.convert import load_checkpoint
from pyannote_audio_speaker_diarization_cpp_tpu.pipelines.streaming import (
    StreamingDiarizer as JaxStreamingDiarizer,
)
from pyannote_audio_speaker_diarization_cpp_tpu_torch.core.sliding_window import SlidingWindow
from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines import reconstruct as rec
from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines.diarization import (
    SpeakerDiarizationPipeline,
)
from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines.streaming import (
    StreamingDiarizer,
)

GATE_CKPT = os.path.join(os.path.dirname(__file__), "goldens", "gate_ckpt")
SMALL5S_CFG = dataclasses.replace(DEFAULT_CONFIG, chunk_bucket=4)


@pytest.fixture(scope="module")
def tiny_pair():
    """(JAX pipeline, port pipeline), tiny1s, host clustering, same weights."""
    return build_pair(TINY1S_CFG, batch=8, device_clustering=False)


@pytest.fixture(scope="module")
def tiny_pipeline(tiny_pair):
    return tiny_pair[1]


def _audio(num_samples, seed):
    rng = np.random.default_rng(seed)
    return (0.1 * rng.normal(size=num_samples)).astype(np.float32)


def gapped_clip(seconds: float = 30.0, seed: int = 0, sr: int = 16000) -> np.ndarray:
    """Tone-and-noise speech turns of 2-4 s from three voices, separated by
    zero-filled gaps of 1.5-2.5 s (the gate model, an energy voice-activity
    detector, gives count == 0 there), int16-quantized."""
    rng = np.random.default_rng(seed)
    out = np.zeros(int(seconds * sr), np.float32)
    voices = ((220.0, 1100.0), (410.0, 2500.0), (150.0, 700.0))
    t, i = 0.5, 0
    while True:
        dur = rng.uniform(2.0, 4.0)
        if t + dur > seconds - 0.3:
            break
        f0, f1 = voices[i % 3]
        n0, n = int(t * sr), int(dur * sr)
        tt = np.arange(n) / sr
        out[n0 : n0 + n] = (
            0.3 * np.sin(2 * np.pi * f0 * tt)
            + 0.2 * np.sin(2 * np.pi * f1 * tt * (1 + 0.05 * np.sin(2 * np.pi * 0.7 * tt)))
            + 0.05 * rng.standard_normal(n)
        )
        t += dur + rng.uniform(1.5, 2.5)
        i += 1
    q = np.clip(np.round(out * 20000.0), -32768, 32767).astype(np.int16)
    return q.astype(np.float32) / 32768.0


def _run(stream, blocks):
    """Every feed's emission (None where it emitted nothing), then the flush."""
    outs = [stream.feed(b) for b in blocks]
    return outs + [stream.flush()]


# ---------------------------------------------------------------------------
# the JAX package's streaming cases, on the port
# ---------------------------------------------------------------------------


def test_streaming_flush_equals_offline(tiny_pipeline):
    audio = _audio(9 * 16000 + 5000, seed=10)  # includes a short orphan tail
    offline = tiny_pipeline(audio)
    stream = StreamingDiarizer(tiny_pipeline, emit_every=4)
    emitted = 0
    for start in range(0, len(audio), 7777):  # odd block size
        if stream.feed(audio[start : start + 7777]) is not None:
            emitted += 1
    final = stream.flush()
    assert emitted >= 1
    assert str(final) == str(offline)


def test_streaming_one_big_feed(tiny_pipeline):
    audio = _audio(6 * 16000, seed=11)
    stream = StreamingDiarizer(tiny_pipeline, emit_every=2)
    stream.feed(audio)
    assert str(stream.flush()) == str(tiny_pipeline(audio))


def test_streaming_bounded_buffer(tiny_pipeline):
    stream = StreamingDiarizer(tiny_pipeline, emit_every=2)
    audio = _audio(8 * 16000, seed=12)
    for start in range(0, len(audio), 16000):
        stream.feed(audio[start : start + 16000])
    seg = tiny_pipeline.config.segmentation
    assert stream._buffer.shape[0] <= seg.window_size + (
        stream.emit_every + 2
    ) * seg.step_size + 16000


def test_streaming_flush_twice_raises(tiny_pipeline):
    stream = StreamingDiarizer(tiny_pipeline)
    stream.feed(_audio(2 * 16000, seed=13))
    stream.flush()
    with pytest.raises(RuntimeError):
        stream.flush()
    with pytest.raises(RuntimeError):
        stream.feed(_audio(100, seed=13))
    stream.reset()
    assert stream.feed(_audio(16000, seed=14)) is None  # usable again


def test_streaming_empty_flush(tiny_pipeline):
    stream = StreamingDiarizer(tiny_pipeline)
    assert len(stream.flush().turns()) == 0


def test_streaming_incremental_clustering(tiny_pipeline):
    """recluster_every > 1: interim emissions assign new embeddings to the
    stored centroids; the flush still reclusters and equals offline."""
    audio = _audio(int(9.7 * 16000), seed=11)
    stream = StreamingDiarizer(tiny_pipeline, emit_every=2, recluster_every=3)
    emitted = sum(
        stream.feed(audio[i : i + 4000]) is not None for i in range(0, len(audio), 4000)
    )
    final = stream.flush()
    assert emitted >= 3
    assert len(stream.feed_latencies) == emitted
    assert all(t > 0 for t in stream.feed_latencies)
    assert stream.recluster_emissions[0] == 0 and len(stream.recluster_emissions) < emitted + 1
    assert str(final) == str(tiny_pipeline(audio))


def test_running_count_grids_bitwise_equal_oneshot(tiny_pipeline):
    """The running count grids give the one-shot speaker count at every
    emission."""
    stream = StreamingDiarizer(tiny_pipeline, emit_every=2)
    seg = tiny_pipeline.config.segmentation
    frame_grid = SlidingWindow(seg.frame_start, seg.frame_step, seg.frame_duration)
    eps = float(np.finfo(np.float64).eps)
    checks = 0
    for block in np.array_split(_audio(9 * 16000, seed=31), 7):
        if stream.feed(block) is None:
            continue
        covered = (stream._done_chunks - 1) * seg.step_size + seg.window_size
        ns = min(stream.total_samples, covered)
        chunk_frames = SlidingWindow(0.0, seg.step, seg.duration, num_samples=ns)
        count, _ = rec.speaker_count(
            stream._binarized.view(), chunk_frames, frame_grid, ns, warm_up=seg.warm_up
        )
        num = stream._count_num.view()[:, 0]
        den = stream._count_den.view()[:, 0]
        mine = np.rint(np.where(den == 0.0, 0.0, num / np.maximum(den, eps))).astype(np.int64)
        np.testing.assert_array_equal(mine, count)
        checks += 1
    assert checks >= 2


def test_recluster_emissions_match_always_recluster_stream(tiny_pipeline):
    blocks = np.array_split(_audio(12 * 16000, seed=33), 10)

    def run(recluster_every):
        stream = StreamingDiarizer(tiny_pipeline, emit_every=2, recluster_every=recluster_every)
        return [None if a is None else str(a) for a in _run(stream, blocks)]

    always, mixed = run(1), run(2)
    assert [a is None for a in always] == [m is None for m in mixed]
    emitted = [(a, m) for a, m in zip(always[:-1], mixed[:-1]) if a is not None]
    assert len(emitted) >= 3
    for i, (a, m) in enumerate(emitted):
        if i % 2 == 0:  # the mixed stream's recluster emissions
            assert m == a
    assert mixed[-1] == always[-1]


def test_incremental_emission_folds_only_new_batches(tiny_pipeline):
    stream = StreamingDiarizer(tiny_pipeline, emit_every=2, recluster_every=10**9)
    calls = [0]
    fold = stream._fold_batch

    def counting_fold(idx, hard):
        calls[0] += 1
        return fold(idx, hard)

    stream._fold_batch = counting_fold
    folded_per_emit = []
    for b in np.array_split(_audio(14 * 16000, seed=35), 12):
        before = calls[0]
        if stream.feed(b) is not None:
            folded_per_emit.append(calls[0] - before)
    assert len(folded_per_emit) >= 4
    assert all(n == 1 for n in folded_per_emit)


def test_flush_partition_equivalent_to_device_route(tiny_pair):
    jp, tp = tiny_pair
    audio = _audio(7 * 16000, seed=51)
    stream = StreamingDiarizer(tp, emit_every=3)
    for block in np.array_split(audio, 5):
        stream.feed(block)
    flushed = stream.flush()
    device_route = SpeakerDiarizationPipeline(
        port_config(jp.config),
        params={"segmentation": jp.params["segmentation"], "embedding": jp.params["embedding"]},
        seg_batch=8,
        emb_batch=8,
        precision="highest",
        pyannet_cfg=tp.pyannet_cfg,
        ecapa_cfg=tp.ecapa_cfg,
        device="cpu",
    )
    assert device_route._dispatch(audio)["device_clu"] is not None
    offline = device_route(audio)
    assert len(offline.turns()) > 0

    def grouping(ann):
        groups = {}
        for t in ann.turns():
            groups.setdefault(t.label, set()).add((round(t.start, 6), round(t.end, 6)))
        return sorted(map(frozenset, groups.values()), key=sorted)

    spans = lambda ann: [(round(t.start, 6), round(t.end, 6)) for t in ann.turns()]  # noqa: E731
    assert spans(flushed) == spans(offline)
    assert grouping(flushed) == grouping(offline)


def test_doubling_recluster_schedule(tiny_pipeline):
    audio = _audio(14 * 16000, seed=41)
    stream = StreamingDiarizer(
        tiny_pipeline, emit_every=1, recluster_schedule="doubling", recluster_max_interval=4
    )
    for b in np.array_split(audio, 20):
        stream.feed(b)
    final = stream.flush()
    rc = stream.recluster_emissions
    assert rc[:4] == [0, 2, 6, 10]  # gaps 2, 4, 4 (doubling capped at 4)
    assert all(b - a >= 2 for a, b in zip(rc[:-1], rc[1:-1]))
    assert str(final) == str(tiny_pipeline(audio))
    with pytest.raises(ValueError):
        StreamingDiarizer(tiny_pipeline, recluster_schedule="bogus")


# ---------------------------------------------------------------------------
# the port's stream against the JAX package's
# ---------------------------------------------------------------------------


def _same_emissions(port_outs, jax_outs):
    assert [o is None for o in port_outs] == [o is None for o in jax_outs]
    for got, want in zip(port_outs, jax_outs):
        if want is not None:
            same_turns(want, got)


@pytest.mark.parametrize("recluster_every", [1, 3])
def test_stream_equals_jax_stream(tiny_pair, recluster_every):
    jp, tp = tiny_pair
    audio = _audio(int(10.3 * 16000), seed=61)
    blocks = np.array_split(audio, 9)
    streams = [
        cls(pipe, emit_every=2, recluster_every=recluster_every)
        for cls, pipe in ((StreamingDiarizer, tp), (JaxStreamingDiarizer, jp))
    ]
    port_outs, jax_outs = (_run(s, blocks) for s in streams)
    assert sum(o is not None for o in jax_outs[:-1]) >= 3
    assert len(jax_outs[-1].turns()) > 0
    _same_emissions(port_outs, jax_outs)
    ps, js = streams
    assert ps.recluster_emissions == js.recluster_emissions
    np.testing.assert_allclose(ps._segs.view(), js._segs.view(), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(ps._binarized.view(), js._binarized.view())
    np.testing.assert_array_equal(ps._inactive.view(), js._inactive.view())
    np.testing.assert_allclose(
        ps._embeddings.view(), js._embeddings.view(), rtol=RTOL, atol=ATOL, equal_nan=True
    )


# ---------------------------------------------------------------------------
# the frozen-prefix decode: small5s, gate checkpoint, silence-gapped clip
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small5s_pair():
    return build_pair(SMALL5S_CFG, batch=4, params=load_checkpoint(GATE_CKPT))


def test_frozen_prefix_engages_and_is_exact(small5s_pair):
    jp, tp = small5s_pair
    wav = gapped_clip(30.0)
    blocks = np.array_split(wav, 14)

    def run(cls, pipe, disable_freeze):
        stream = cls(pipe, emit_every=8, recluster_every=4)
        if disable_freeze:
            stream._advance_seam = lambda *a, **k: None
        return _run(stream, blocks), stream

    frozen, stream = run(StreamingDiarizer, tp, False)
    plain, _ = run(StreamingDiarizer, tp, True)
    assert [None if o is None else str(o) for o in frozen] == [
        None if o is None else str(o) for o in plain
    ]
    assert stream._seam_cidx > 0
    assert len(stream._frozen_turns) > 0
    assert sum(o is not None for o in frozen[:-1]) >= 4
    assert str(frozen[-1]) == str(tp(wav))
    jax_outs, jax_stream = run(JaxStreamingDiarizer, jp, False)
    _same_emissions(frozen, jax_outs)
    assert stream._seam_cidx == jax_stream._seam_cidx
