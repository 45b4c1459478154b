"""The PyTorch port's host layer against the JAX package: config, core, io,
the aggregation plan and the overlap-add. All exact, except the overlap-add
of arbitrary floats, whose sums may round in another order."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pyannote_audio_speaker_diarization_cpp_tpu import config as jcfg
from pyannote_audio_speaker_diarization_cpp_tpu.core import annotation as jann
from pyannote_audio_speaker_diarization_cpp_tpu.core import segment as jseg
from pyannote_audio_speaker_diarization_cpp_tpu.core import sliding_window as jsw
from pyannote_audio_speaker_diarization_cpp_tpu.io import resample as jrs
from pyannote_audio_speaker_diarization_cpp_tpu.io import wav as jwav
from pyannote_audio_speaker_diarization_cpp_tpu.ops import aggregate as jagg
from pyannote_audio_speaker_diarization_cpp_tpu.ops import windows as jwin
from pyannote_audio_speaker_diarization_cpp_tpu_torch import config as tcfg
from pyannote_audio_speaker_diarization_cpp_tpu_torch.core import annotation as tann
from pyannote_audio_speaker_diarization_cpp_tpu_torch.core import segment as tseg
from pyannote_audio_speaker_diarization_cpp_tpu_torch.core import sliding_window as tsw
from pyannote_audio_speaker_diarization_cpp_tpu_torch.io import resample as trs
from pyannote_audio_speaker_diarization_cpp_tpu_torch.io import wav as twav
from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops import aggregate as tagg
from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops import windows as twin


@pytest.mark.parametrize(
    "name", ["FrontendConfig", "SegmentationConfig", "EmbeddingConfig", "ClusteringConfig", "DiarizationConfig"]
)
def test_config_defaults_equal(name):
    j, t = getattr(jcfg, name)(), getattr(tcfg, name)()
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    for prop in ("win_length", "hop_length", "num_freqs", "window_size", "step_size"):
        if hasattr(j, prop):
            assert getattr(j, prop) == getattr(t, prop)


def test_closest_frame_and_grids_equal():
    rng = np.random.default_rng(0)
    times = np.concatenate([np.arange(5000) * 0.5, rng.uniform(-1.0, 4000.0, 5000)])
    for grid in [(0.0, 0.016875, 0.016875), (0.5, 0.5, 4.0), (0.0, 0.5, 5.0)]:
        j, t = jsw.SlidingWindow(*grid), tsw.SlidingWindow(*grid)
        assert [j.closest_frame(x) for x in times] == [t.closest_frame(x) for x in times]
        focus_j, focus_t = jseg.Segment(1.3, 17.9), tseg.Segment(1.3, 17.9)
        assert j.crop_range(focus_j) == t.crop_range(focus_t)
        assert (j.extent(1234).start, j.extent(1234).end) == (
            t.extent(1234).start,
            t.extent(1234).end,
        )
    for n in (1, 79999, 80000, 80001, 88000, 944000, 1000003):
        jw = jsw.SlidingWindow(0.0, 0.5, 5.0, num_samples=n)
        tw = tsw.SlidingWindow(0.0, 0.5, 5.0, num_samples=n)
        assert [(s.start, s.end) for s in jw.chunk_segments()] == [
            (s.start, s.end) for s in tw.chunk_segments()
        ]
        assert jsw.num_chunks_for_samples(n, 80000, 8000) == tsw.num_chunks_for_samples(
            n, 80000, 8000
        )
        assert jwin.chunk_count(n, 80000, 8000) == twin.chunk_count(n, 80000, 8000)
        assert jseg.crop_range(0.3, 5.3, n, 16000) == tseg.crop_range(0.3, 5.3, n, 16000)


def test_annotation_equal():
    rng = np.random.default_rng(1)
    ja, ta = jann.Annotation(), tann.Annotation()
    for _ in range(60):
        s = float(rng.uniform(0, 50))
        e = s + float(rng.uniform(0.01, 3))
        k = int(rng.integers(0, 4))
        ja.add(s, e, k)
        ta.add(s, e, k)
    for j, t in [
        (ja, ta),
        (ja.support(0.58), ta.support(0.58)),
        (ja.remove_short(0.5), ta.remove_short(0.5)),
        (ja.crop(jseg.Segment(3, 30)), ta.crop(tseg.Segment(3, 30))),
    ]:
        assert str(j) == str(t)
        assert j.to_rttm("x") == t.to_rttm("x")
    assert str(tann.Annotation.from_rttm(ja.to_rttm())) == str(
        jann.Annotation.from_rttm(ja.to_rttm())
    )


def test_wav_and_resample_equal(tmp_path):
    rng = np.random.default_rng(2)
    samples = (rng.normal(size=(2, 4000)) * 3000).astype(np.int16)
    path = str(tmp_path / "a.wav")
    jwav.write_wav(path, samples, 22050)
    j, t = jwav.read_wav(path), twav.read_wav(path)
    assert j.sample_rate == t.sample_rate
    np.testing.assert_array_equal(j.samples, t.samples)
    np.testing.assert_array_equal(j.normalized_mono(), t.normalized_mono())
    np.testing.assert_array_equal(
        jrs.resample(j.normalized_mono(), 22050, 16000),
        trs.resample(t.normalized_mono(), 22050, 16000),
    )
    np.testing.assert_array_equal(jrs.downmix(samples), trs.downmix(samples))
    path2 = str(tmp_path / "b.wav")
    twav.write_wav(path2, samples, 16000)
    assert open(path, "rb").read()[44:] == open(path2, "rb").read()[44:]


def _plans(num_chunks, cfg):
    seg = cfg.segmentation
    out = []
    for mod, sw in ((jagg, jsw), (tagg, tsw)):
        frame_grid = sw.SlidingWindow(seg.frame_start, seg.frame_step, seg.frame_duration)
        chunk_grid = sw.SlidingWindow(0.0, seg.step, seg.duration)
        trimmed = sw.SlidingWindow(
            seg.warm_up[0] * seg.duration, seg.step, (1 - sum(seg.warm_up)) * seg.duration
        )
        out.append(
            [mod.plan_aggregation(num_chunks, g, frame_grid) for g in (chunk_grid, trimmed)]
        )
    return out


@pytest.mark.parametrize("num_chunks", [1, 7, 109, 128, 1024])
def test_plan_aggregation_equal(num_chunks):
    jp, tp = _plans(num_chunks, jcfg.DEFAULT_CONFIG)
    for a, b in zip(jp, tp):
        np.testing.assert_array_equal(a.start_frames, b.start_frames)
        assert a.num_frames == b.num_frames
        assert dataclasses.asdict(a.frames) == dataclasses.asdict(b.frames)


@pytest.mark.parametrize("skip_average", [False, True])
def test_aggregate_matches_jax(skip_average):
    rng = np.random.default_rng(3)
    (jp, _), _ = _plans(37, jcfg.DEFAULT_CONFIG)
    F, K = 293, 3
    binary = (rng.uniform(size=(37, F, K)) > 0.5).astype(np.float32)
    floats = rng.uniform(size=(37, F, K)).astype(np.float32)
    for exact, scores in ((True, binary), (False, floats)):
        scores[5] = np.nan  # a padding chunk
        scores[9, :, 1] = np.nan  # a missing cluster
        want = np.asarray(
            jagg.aggregate(
                jnp.asarray(scores),
                jnp.asarray(jp.start_frames),
                jp.num_frames,
                missing=0.0,
                skip_average=skip_average,
            )
        )
        got = tagg.aggregate(
            torch.from_numpy(scores),
            torch.from_numpy(jp.start_frames),
            jp.num_frames,
            missing=0.0,
            skip_average=skip_average,
        ).numpy()
        if exact:  # integer sums and counts: no rounding on either side
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_aggregate_drops_out_of_range_like_jax():
    scores = np.ones((3, 10, 2), np.float32)
    starts = np.array([0, 5, 12], np.int32)
    want = np.asarray(jagg.aggregate(jnp.asarray(scores), jnp.asarray(starts), 15))
    got = tagg.aggregate(torch.from_numpy(scores), torch.from_numpy(starts), 15).numpy()
    np.testing.assert_array_equal(got, want)
