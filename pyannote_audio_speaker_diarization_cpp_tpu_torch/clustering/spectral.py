"""Spectral clustering alternative to AHC (affinity + eigengap).

No reference counterpart — this is the second clusterer called for by the
framework configs (BASELINE.json: "spectral clustering alternative
(affinity + eigengap speaker-count estimation) swapped for AHC"), following
the standard speaker-diarization recipe (Wang et al., "Speaker Diarization
with LSTM"; refined affinity + normalized-Laplacian eigengap + k-means).

Same interface as AgglomerativeClustering so the pipeline can swap it in:
``SpectralClustering(...)(embeddings, num_clusters=..., ...)``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from .base import assign_embeddings, filter_embeddings, set_num_clusters


def _refine_affinity(A: np.ndarray, p_percentile: float = 0.95) -> np.ndarray:
    """Row-wise percentile thresholding + symmetrization."""
    A = np.array(A)
    np.fill_diagonal(A, 0.0)
    thresh = np.quantile(A, p_percentile, axis=1, keepdims=True)
    A_thr = np.where(A >= thresh, A, A * 0.01)
    A_sym = np.maximum(A_thr, A_thr.T)
    np.fill_diagonal(A_sym, 1.0)
    return A_sym


def _eigengap_num_clusters(
    eigvals: np.ndarray, min_clusters: int, max_clusters: int
) -> int:
    """Pick k maximizing the gap between consecutive Laplacian eigenvalues
    within [min_clusters, max_clusters]."""
    hi = min(max_clusters, len(eigvals) - 1)
    if hi <= min_clusters:
        return max(1, min_clusters)
    gaps = eigvals[1 : hi + 1] - eigvals[:hi]
    ks = np.arange(1, hi + 1)
    valid = ks >= min_clusters
    return int(ks[valid][np.argmax(gaps[valid])])


def _kmeans(X: np.ndarray, k: int, iters: int = 50, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    # k-means++ init
    centers = [X[rng.integers(len(X))]]
    for _ in range(1, k):
        d2 = np.min(
            [np.sum((X - c) ** 2, axis=1) for c in centers], axis=0
        )
        probs = d2 / np.maximum(d2.sum(), 1e-12)
        centers.append(X[rng.choice(len(X), p=probs)])
    C = np.stack(centers)
    labels = np.zeros(len(X), dtype=np.int64)
    for _ in range(iters):
        dists = ((X[:, None, :] - C[None, :, :]) ** 2).sum(-1)
        new_labels = np.argmin(dists, axis=1)
        if np.array_equal(new_labels, labels):
            labels = new_labels
            break
        labels = new_labels
        for j in range(k):
            members = X[labels == j]
            if len(members):
                C[j] = members.mean(axis=0)
    # renumber by first appearance for determinism
    seen: dict = {}
    for lab in labels:
        if lab not in seen:
            seen[lab] = len(seen)
    return np.array([seen[lab] for lab in labels], dtype=np.int64)


@dataclasses.dataclass
class SpectralClustering:
    """Affinity -> normalized Laplacian -> eigengap k -> k-means."""

    p_percentile: float = 0.95
    min_affinity_samples: int = 2
    seed: int = 0
    max_num_embeddings: Optional[int] = None

    def cluster(
        self,
        embeddings: np.ndarray,
        min_clusters: int,
        max_clusters: int,
        num_clusters: Optional[int] = None,
    ) -> np.ndarray:
        n = embeddings.shape[0]
        if n == 1:
            return np.zeros((1,), dtype=np.int64)
        emb = embeddings / np.maximum(
            np.linalg.norm(embeddings, axis=-1, keepdims=True), 1e-12
        )
        A = _refine_affinity(emb @ emb.T, self.p_percentile)
        deg = A.sum(axis=1)
        d_inv_sqrt = 1.0 / np.sqrt(np.maximum(deg, 1e-12))
        L = np.eye(n) - d_inv_sqrt[:, None] * A * d_inv_sqrt[None, :]
        eigvals, eigvecs = np.linalg.eigh(L)

        if num_clusters is None:
            num_clusters = _eigengap_num_clusters(eigvals, min_clusters, max_clusters)
        num_clusters = int(np.clip(num_clusters, 1, n))
        if num_clusters == 1:
            return np.zeros(n, dtype=np.int64)

        V = eigvecs[:, :num_clusters]
        norms = np.linalg.norm(V, axis=1, keepdims=True)
        V = V / np.maximum(norms, 1e-12)
        return _kmeans(V, num_clusters, seed=self.seed)

    def __call__(
        self,
        embeddings: np.ndarray,
        num_clusters: Optional[int] = None,
        min_clusters: Optional[int] = None,
        max_clusters: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        train_embeddings, train_chunk_idx, train_speaker_idx = filter_embeddings(
            embeddings, max_num_embeddings=self.max_num_embeddings
        )
        num_embeddings = train_embeddings.shape[0]
        num_clusters, min_clusters, max_clusters = set_num_clusters(
            num_embeddings,
            num_clusters=num_clusters,
            min_clusters=min_clusters,
            max_clusters=max_clusters,
        )
        if max_clusters < 2:
            num_chunks, num_speakers, _ = embeddings.shape
            return (
                np.zeros((num_chunks, num_speakers), dtype=np.int64),
                np.ones((num_chunks, num_speakers, 1)),
            )
        train_clusters = self.cluster(
            train_embeddings, min_clusters, max_clusters, num_clusters=num_clusters
        )
        return assign_embeddings(
            embeddings, train_chunk_idx, train_speaker_idx, train_clusters
        )
