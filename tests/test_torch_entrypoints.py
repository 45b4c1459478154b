"""The port's other entry points against the JAX package, on the CPU:
``map`` and ``warmup`` (tiny1s, a seeded JAX init), ``run_chunks``,
``run_chunks_device`` and ``stage2_internals`` (small5s, the in-repo gate
checkpoint). Both sides run the same weights in the bit-conservative mode
(float32, HIGHEST, TF32 off); discrete tensors must be equal, floats within
rtol 1e-3 / atol 1e-4, turns equal up to a permutation of the labels."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from _cfg import TINY1S_CFG
from pyannote_audio_speaker_diarization_cpp_tpu.config import DEFAULT_CONFIG
from pyannote_audio_speaker_diarization_cpp_tpu.models.convert import load_checkpoint
from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines.diarization import (
    SpeakerDiarizationPipeline,
)
from _torch_threads import two_torch_threads  # noqa: F401
from test_torch_pipeline import ATOL, RTOL, build_pair, same_turns, synth_audio

GATE_CKPT = os.path.join(os.path.dirname(__file__), "goldens", "gate_ckpt")
SMALL5S_CFG = dataclasses.replace(DEFAULT_CONFIG, chunk_bucket=4)


def orphan_args(pipe, audio):
    """(num_chunks, orphan_frames, orphan_samples) of a recording, as
    run_with_dumps derives them."""
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.models.pyannet import (
        pyannet_num_frames,
    )
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops.windows import chunk_count

    seg = pipe.config.segmentation
    n = chunk_count(len(audio), seg.window_size, seg.step_size)
    orphan = len(audio) - (n - 1) * seg.step_size
    frames = None
    if orphan < seg.window_size:
        frames = max(pyannet_num_frames(orphan, pipe.pyannet_cfg), 0)
    return n, frames, orphan


@pytest.fixture(scope="module")
def tiny1s():
    jp, tp = build_pair(TINY1S_CFG, batch=8)
    # three lengths in one chunk bucket; 2.3 s ends on an orphan chunk
    clips = [synth_audio(s, seed=seed) for s, seed in ((2.3, 1), (3.0, 2), (4.4, 3))]
    return jp, tp, clips


def test_map_equals_sequential_calls_and_jax_map(tiny1s):
    jp, tp, clips = tiny1s
    mapped = tp.map(clips)
    for got, audio in zip(mapped, clips):
        assert str(got) == str(tp(audio))
    want = jp.map(clips)
    assert sum(len(a.turns()) for a in want) > 0
    for w, g in zip(want, mapped):
        same_turns(w, g)


def test_map_device_route_equals_sequential_calls(tiny1s):
    """The same weights with stage 3 on the device (the default route)."""
    _, tp, clips = tiny1s
    auto = SpeakerDiarizationPipeline(
        tp.config,
        params=None,
        seg_batch=tp.seg_batch,
        emb_batch=tp.emb_batch,
        precision="highest",
        pyannet_cfg=tp.pyannet_cfg,
        ecapa_cfg=tp.ecapa_cfg,
        device="cpu",
    )
    auto.segmentation_model.load_state_dict(tp.segmentation_model.state_dict())
    auto.embedding_model.load_state_dict(tp.embedding_model.state_dict())
    assert auto._dispatch(clips[0])["device_clu"] is not None
    mapped = auto.map(clips)
    for got, audio in zip(mapped, clips):
        assert str(got) == str(auto(audio))


def test_warmup_buckets_equal_jax_and_leave_requests_unchanged(tiny1s):
    jp, tp, clips = tiny1s
    before = str(tp(clips[1]))
    warmed = tp.warmup(3.0)
    assert warmed == jp.warmup(3.0)
    assert str(tp(clips[1])) == before


@pytest.mark.parametrize("max_seconds", [1.0, 10.0])
def test_warmup_bucket_list_matches_jax_lattice(tiny1s, max_seconds):
    """Longer spans than the JAX warmup above runs (several buckets): the
    list the JAX package's warmup returns, from its own chunk lattice."""
    from pyannote_audio_speaker_diarization_cpp_tpu.ops.windows import chunk_count

    jp, tp, _ = tiny1s
    seg = jp.config.segmentation
    samples = int(max_seconds * seg.sample_rate)
    max_chunks = max(chunk_count(samples, seg.window_size, seg.step_size), 1)
    want = sorted({jp.chunk_lattice(n) for n in range(1, max_chunks + 1)})
    assert tp.warmup(max_seconds) == want


@pytest.fixture(scope="module")
def small5s():
    jp, tp = build_pair(SMALL5S_CFG, batch=4, params=load_checkpoint(GATE_CKPT))
    audio = synth_audio(12.3)  # 15 complete windows + a short orphan
    return jp, tp, audio, orphan_args(tp, audio)


def test_run_chunks_equals_jax(small5s):
    jp, tp, audio, args = small5s
    want = jp.run_chunks(audio, *args)
    got = tp.run_chunks(audio, *args)
    jsegs, jbin, jemb = (np.asarray(a) for a in want)
    tsegs, tbin, temb = got
    assert tsegs.shape == jsegs.shape and temb.shape == jemb.shape
    np.testing.assert_allclose(tsegs, jsegs, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(tbin, jbin)
    np.testing.assert_array_equal(np.isnan(temb), np.isnan(jemb))
    assert (~np.isnan(jemb)).any()
    np.testing.assert_allclose(temb, jemb, rtol=RTOL, atol=ATOL, equal_nan=True)


def test_run_chunks_device_fetch_and_no_fetch(small5s):
    jp, tp, audio, args = small5s
    n = args[0]
    S = tp.config.segmentation.num_speakers
    segs, binarized, vf, emb, inactive = tp.run_chunks_device(audio, *args)
    jsegs, jbin, jvf, jemb, jinactive = jp.run_chunks_device(audio, *args)
    np.testing.assert_array_equal(vf, np.asarray(jvf))
    np.testing.assert_allclose(segs.numpy(), np.asarray(jsegs), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(binarized.numpy(), np.asarray(jbin))
    np.testing.assert_array_equal(inactive, np.asarray(jinactive))
    np.testing.assert_allclose(emb, np.asarray(jemb), rtol=RTOL, atol=ATOL, equal_nan=True)
    # fetch=False: the same values, left on the device
    lazy = tp.run_chunks_device(audio, *args, fetch=False)
    assert len(lazy) == 6 and all(isinstance(t, torch.Tensor) for t in lazy[3:])
    np.testing.assert_array_equal(lazy[0].numpy(), segs.numpy())
    np.testing.assert_array_equal(lazy[1].numpy(), binarized.numpy())
    np.testing.assert_array_equal(lazy[2], vf)
    emb_lazy = lazy[3].numpy()[: n * S].astype(np.float64)
    emb_lazy[lazy[4].numpy()[: n * S]] = np.nan
    np.testing.assert_array_equal(emb_lazy.reshape(emb.shape), emb)
    np.testing.assert_array_equal(lazy[5].numpy()[:n], inactive)


def test_stage2_internals_equal_jax(small5s):
    jp, tp, audio, args = small5s
    jsig, jlens = (np.asarray(a) for a in jp.stage2_internals(audio, *args))
    tsig, tlens = tp.stage2_internals(audio, *args)
    assert tsig.shape == jsig.shape and tsig.shape[0] == args[0] * 3
    np.testing.assert_array_equal(tsig, jsig)
    # normalized lengths: floats (the two divisions round apart by an ulp)
    np.testing.assert_allclose(tlens, jlens, rtol=RTOL, atol=ATOL)
    assert (tlens < 1.0).any()  # rows with a real (partial) mask were packed


def test_run_chunks_empty_range(small5s):
    _, tp, audio, _ = small5s
    segs, binarized, emb = tp.run_chunks(audio[:0], 0)
    seg = tp.config.segmentation
    assert segs.shape == (0, seg.num_frames, seg.num_speakers) == binarized.shape
    assert emb.shape == (0, seg.num_speakers, tp.ecapa_cfg.emb_dim)
