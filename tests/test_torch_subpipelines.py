"""The port's sub-pipelines and DER against the JAX package's, on the CPU.

``SegmentationPipeline`` (sliding scores with the zero-padded orphan chunk,
VAD turns merged and per local speaker) and ``EmbeddingPipeline`` (with and
without frame masks, cosine similarity) on the small widths with seeded JAX
weights, float32 at HIGHEST on both sides; floats within rtol 1e-3 / atol
1e-4, turns equal. ``der`` and its command line on the same annotations.
"""

import dataclasses

import jax
import numpy as np
import pytest

from _cfg import SMALL_ECAPA, SMALL_PYANNET
from pyannote_audio_speaker_diarization_cpp_tpu.config import DEFAULT_CONFIG
from pyannote_audio_speaker_diarization_cpp_tpu.core.annotation import Annotation as JaxAnnotation
from pyannote_audio_speaker_diarization_cpp_tpu.metrics import der as jder
from pyannote_audio_speaker_diarization_cpp_tpu.models.ecapa import init_ecapa
from pyannote_audio_speaker_diarization_cpp_tpu.models.pyannet import init_pyannet
from pyannote_audio_speaker_diarization_cpp_tpu.pipelines.embedding import (
    EmbeddingPipeline as JaxEmbeddingPipeline,
)
from pyannote_audio_speaker_diarization_cpp_tpu.pipelines.segmentation import (
    SegmentationPipeline as JaxSegmentationPipeline,
)
from pyannote_audio_speaker_diarization_cpp_tpu_torch.core.annotation import Annotation
from pyannote_audio_speaker_diarization_cpp_tpu_torch.metrics import der as tder
from pyannote_audio_speaker_diarization_cpp_tpu_torch.models.ecapa import EcapaConfig
from pyannote_audio_speaker_diarization_cpp_tpu_torch.models.pyannet import PyanNetConfig
from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines.embedding import (
    EmbeddingPipeline,
)
from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines.segmentation import (
    SegmentationPipeline,
)
from _torch_threads import two_torch_threads  # noqa: F401
from test_torch_pipeline import ATOL, RTOL, port_config, synth_audio

CFG = dataclasses.replace(DEFAULT_CONFIG, chunk_bucket=4)
HIGHEST = jax.lax.Precision.HIGHEST


@pytest.fixture(scope="module")
def segmentation_pair():
    params = {"segmentation": jax.tree.map(np.asarray, init_pyannet(jax.random.PRNGKey(3), SMALL_PYANNET))}
    jp = JaxSegmentationPipeline(
        CFG, params=params, seg_batch=4, precision=HIGHEST, pyannet_cfg=SMALL_PYANNET
    )
    tp = SegmentationPipeline(
        port_config(CFG),
        params=params,
        seg_batch=4,
        precision="highest",
        pyannet_cfg=PyanNetConfig(**dataclasses.asdict(SMALL_PYANNET)),
        device="cpu",
    )
    return jp, tp, synth_audio(12.3)  # 15 complete windows + a short orphan


def test_segmentation_slide_equals_jax(segmentation_pair):
    jp, tp, audio = segmentation_pair
    want, got = jp.slide(audio), tp.slide(audio)
    assert got.data.shape == want.data.shape == (16, 293, 3)
    assert dataclasses.asdict(got.sliding_window) == dataclasses.asdict(want.sliding_window)
    np.testing.assert_allclose(got.data, np.asarray(want.data), rtol=RTOL, atol=ATOL)
    # the orphan chunk's frames past the audio are zero, as the JAX module
    # leaves them
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.models.pyannet import (
        pyannet_num_frames,
    )

    valid = pyannet_num_frames(len(audio) - 15 * 8000, tp.pyannet_cfg)
    assert 0 < valid < 293
    assert (got.data[-1, valid:] == 0).all() and (got.data[-1, :valid] != 0).any()


@pytest.mark.parametrize("merge", [True, False])
def test_segmentation_turns_equal_jax(segmentation_pair, merge):
    jp, tp, audio = segmentation_pair
    want = jp(audio, merge_speakers=merge)
    got = tp(audio, merge_speakers=merge)
    assert len(want.turns()) > 0
    assert str(got) == str(want)


@pytest.fixture(scope="module")
def embedding_pair():
    params = {"embedding": jax.tree.map(np.asarray, init_ecapa(jax.random.PRNGKey(4), SMALL_ECAPA))}
    jp = JaxEmbeddingPipeline(CFG, params=params, batch_size=4, precision=HIGHEST, ecapa_cfg=SMALL_ECAPA)
    tp = EmbeddingPipeline(
        port_config(CFG),
        params=params,
        batch_size=4,
        precision="highest",
        ecapa_cfg=EcapaConfig(**dataclasses.asdict(SMALL_ECAPA)),
        device="cpu",
    )
    rng = np.random.default_rng(5)
    audio = synth_audio(8.0, seed=6)
    # six 5 s windows (the last batch is short), and frame masks of speech
    # runs, one too short to embed
    waveforms = np.stack([audio[i * 8000 : i * 8000 + 80000] for i in range(6)])
    runs = np.repeat(rng.uniform(size=(6, 293 // 8 + 1)), 8, axis=1)[:, :293]
    masks = (runs < 0.6).astype(np.float32)
    masks[2, 4:] = 0.0
    return jp, tp, waveforms, masks


@pytest.mark.parametrize("masked", [False, True])
def test_embeddings_equal_jax(embedding_pair, masked):
    jp, tp, waveforms, masks = embedding_pair
    m = masks if masked else None
    want, got = np.asarray(jp(waveforms, m)), tp(waveforms, m)
    assert got.dtype == np.float64 and got.shape == want.shape == (6, SMALL_ECAPA.emb_dim)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[2]).all() == masked
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, equal_nan=True)


def test_cosine_similarity_equals_jax(embedding_pair):
    jp, tp, waveforms, _ = embedding_pair
    emb = tp(waveforms)
    np.testing.assert_array_equal(
        tp.cosine_similarity(emb, emb[:3]), jp.cosine_similarity(emb, emb[:3])
    )


RTTM_REF = """SPEAKER rec 1 0.000 3.000 <NA> <NA> A <NA> <NA>
SPEAKER rec 1 2.500 2.000 <NA> <NA> B <NA> <NA>
SPEAKER rec 1 6.000 1.500 <NA> <NA> A <NA> <NA>
"""
RTTM_HYP = """SPEAKER rec 1 0.100 2.800 <NA> <NA> s1 <NA> <NA>
SPEAKER rec 1 2.900 1.800 <NA> <NA> s0 <NA> <NA>
SPEAKER rec 1 5.500 2.500 <NA> <NA> s1 <NA> <NA>
SPEAKER rec 1 8.000 0.500 <NA> <NA> s2 <NA> <NA>
"""


@pytest.mark.parametrize("collar", [0.0, 0.25])
def test_der_equals_jax(collar):
    want = jder.diarization_error_rate(
        JaxAnnotation.from_rttm(RTTM_REF), JaxAnnotation.from_rttm(RTTM_HYP), collar=collar
    )
    got = tder.diarization_error_rate(
        Annotation.from_rttm(RTTM_REF), Annotation.from_rttm(RTTM_HYP), collar=collar
    )
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert 0.0 < got.der < 1.0
    assert tder.der(Annotation.from_rttm(RTTM_REF), Annotation.from_rttm(RTTM_HYP), collar) == got.der


def test_der_main_prints_what_jax_prints(tmp_path, capsys):
    ref, hyp = tmp_path / "ref.rttm", tmp_path / "hyp.rttm"
    ref.write_text(RTTM_REF)
    hyp.write_text(RTTM_HYP)
    args = [str(ref), str(hyp), "--collar", "0.25"]
    assert jder.main(args) == 0
    want = capsys.readouterr().out
    assert tder.main(args) == 0
    assert capsys.readouterr().out == want
    assert want.startswith("DER=")


def test_timing_helpers_equal_jax(tmp_path):
    """utils/timing.py: the same real-time factor and report as the JAX
    module's; spans accumulate; the profiler trace is written where asked."""
    import torch

    from pyannote_audio_speaker_diarization_cpp_tpu.utils import timing as jtiming
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.utils import timing as ttiming

    for audio_s, wall_s in ((59.0, 0.1626), (12.3, 1.5), (1.0, 0.0)):
        assert ttiming.realtime_factor(audio_s, wall_s) == jtiming.realtime_factor(audio_s, wall_s)
    timer = ttiming.StageTimer()
    for _ in range(2):
        with timer.time("segmentation") as fence:
            fence.append(torch.ones(4).sum())
    assert set(timer.times) == {"segmentation"} and timer.times["segmentation"] > 0.0
    jtimer = jtiming.StageTimer()
    jtimer.times = timer.times = {"segmentation": 0.0123, "embedding": 0.5}
    assert timer.report() == jtimer.report()
    with ttiming.profiler_trace(None) as prof:
        assert prof is None
    with ttiming.profiler_trace(str(tmp_path / "trace")) as prof:
        torch.ones(8).sum()
    assert prof is not None and (tmp_path / "trace" / "trace.json").stat().st_size > 0
