"""The port's host clustering (clustering/ahc.py and clustering/base.py,
owned copies) against the JAX package's: the same embeddings give the same
dendrogram, the same hard labels and the same soft scores, bit for bit."""

import numpy as np
import pytest

from pyannote_audio_speaker_diarization_cpp_tpu.clustering import ahc as jahc
from pyannote_audio_speaker_diarization_cpp_tpu.clustering import base as jbase
from pyannote_audio_speaker_diarization_cpp_tpu.config import ClusteringConfig as JClusteringConfig
from pyannote_audio_speaker_diarization_cpp_tpu_torch.clustering import ahc as tahc
from pyannote_audio_speaker_diarization_cpp_tpu_torch.clustering import base as tbase
from pyannote_audio_speaker_diarization_cpp_tpu_torch.config import ClusteringConfig

THRESHOLD = 0.7153814381597874


def _embeddings(seed, num_chunks, num_speakers=3, dim=32, n_clusters=4, p_active=0.7):
    """Speaker-like clusters on the unit sphere, NaN rows for silent speakers."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, dim)) * 3
    emb = np.full((num_chunks, num_speakers, dim), np.nan)
    for c in range(num_chunks):
        for s in range(num_speakers):
            if rng.uniform() < p_active:
                emb[c, s] = centers[rng.integers(n_clusters)] + 0.4 * rng.normal(size=dim)
    return emb


@pytest.mark.parametrize("backend", ["scipy", "numpy"])
@pytest.mark.parametrize("method", ["centroid", "average", "ward"])
def test_linkage_equal(method, backend):
    X = np.random.default_rng(11).normal(size=(60, 12))
    np.testing.assert_array_equal(
        tahc.linkage(X, method=method, backend=backend),
        jahc.linkage(X, method=method, backend=backend),
    )


@pytest.mark.parametrize(
    "num_chunks, kwargs",
    [
        (30, {}),
        (30, {"num_clusters": 4}),
        (30, {"min_clusters": 2, "max_clusters": 3}),
        (500, {}),  # 1500 rows: past the 1000-embedding training cap
    ],
)
def test_agglomerative_clustering_equal(num_chunks, kwargs):
    emb = _embeddings(num_chunks, num_chunks)
    cfg = dict(threshold=THRESHOLD, min_cluster_size=3)
    want_hard, want_soft = jbase.AgglomerativeClustering(JClusteringConfig(**cfg))(emb, **kwargs)
    got_hard, got_soft = tbase.AgglomerativeClustering(ClusteringConfig(**cfg))(emb, **kwargs)
    np.testing.assert_array_equal(got_hard, want_hard)
    np.testing.assert_array_equal(got_soft, want_soft)
    assert len(np.unique(got_hard)) > 1
