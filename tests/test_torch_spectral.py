"""The port's spectral clusterer (clustering/spectral.py, an owned copy)
against the JAX package's, alone and through the tiny1s pipeline, and the
constructor's rule that keeps stage 3 on the host with it."""

import numpy as np
import pytest

from _cfg import TINY1S_CFG
from _torch_threads import two_torch_threads  # noqa: F401
from test_torch_pipeline import build_pair, port_config, same_turns, synth_audio
from pyannote_audio_speaker_diarization_cpp_tpu.clustering.spectral import (
    SpectralClustering as JaxSpectral,
)
from pyannote_audio_speaker_diarization_cpp_tpu_torch.clustering.spectral import (
    SpectralClustering,
)
from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines.diarization import (
    SpeakerDiarizationPipeline,
)


def _embeddings(seed, num_chunks, num_speakers=3, dim=32, n_clusters=4, p_active=0.7):
    """Speaker-like clusters, NaN rows for silent speakers."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, dim)) * 3
    emb = np.full((num_chunks, num_speakers, dim), np.nan)
    for c in range(num_chunks):
        for s in range(num_speakers):
            if rng.uniform() < p_active:
                emb[c, s] = centers[rng.integers(n_clusters)] + 0.5 * rng.normal(size=dim)
    return emb


@pytest.mark.parametrize(
    "seed, num_chunks, kwargs",
    [
        (0, 40, {}),
        (1, 40, {"num_clusters": 3}),
        (2, 60, {"min_clusters": 2, "max_clusters": 5}),
        (3, 1, {}),
        (4, 200, {}),
    ],
)
def test_spectral_equals_jax(seed, num_chunks, kwargs):
    emb = _embeddings(seed, num_chunks)
    want_hard, want_soft = JaxSpectral()(emb, **kwargs)
    got_hard, got_soft = SpectralClustering()(emb, **kwargs)
    np.testing.assert_array_equal(got_hard, want_hard)
    np.testing.assert_allclose(got_soft, want_soft, rtol=0, atol=1e-12)
    if num_chunks > 1:
        assert len(np.unique(got_hard)) > 1


def test_spectral_cluster_equals_jax():
    X = np.random.default_rng(9).normal(size=(80, 16))
    X[:40] += 4.0
    want = JaxSpectral(seed=3).cluster(X, 1, 10)
    got = SpectralClustering(seed=3).cluster(X, 1, 10)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        SpectralClustering().cluster(X, 1, 40, num_clusters=4),
        JaxSpectral().cluster(X, 1, 40, num_clusters=4),
    )


def test_tiny1s_spectral_turns_equal_jax():
    jp, tp = build_pair(TINY1S_CFG, batch=8, clusterer="spectral")
    assert isinstance(tp.clusterer, SpectralClustering)
    audio = synth_audio(6.3, seed=5)
    assert tp._dispatch(audio)["device_clu"] is None
    want, got = jp(audio), tp(audio)
    assert len(want.turns()) > 0
    same_turns(want, got)


def test_spectral_keeps_stage3_on_the_host():
    cfg = port_config(TINY1S_CFG)
    with pytest.raises(ValueError, match="device_clustering=True"):
        SpeakerDiarizationPipeline(cfg, device="cpu", device_clustering=True, clusterer="spectral")
    pipe = SpeakerDiarizationPipeline(cfg, device="cpu", clusterer="spectral")
    assert pipe._device_clu_key() is None
    with pytest.raises(ValueError, match="unknown clusterer"):
        SpeakerDiarizationPipeline(cfg, device="cpu", clusterer="kmeans")
