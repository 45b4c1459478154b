"""Clustering-stage orchestration: filter -> cluster -> assign.

Re-design of pyannote's BaseClustering/AgglomerativeClustering (reference
clustering/Clustering.py:8-428; C++ port at pipeline/src/speakerDiarizer.cpp:
2044-2425). Host-side numpy — the embeddings matrix is tiny (N x 192) and
arrives from the device via one transfer (or an all_gather in the multi-host
path, see parallel/).

Includes the known-num_clusters dendrogram-search branch
(Clustering.py:352-399) that the C++ reference left unimplemented
(speakerDiarizer.cpp:2368-2369 asserts instead).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from ..config import ClusteringConfig
from . import ahc


def cosine_cdist(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise cosine distances, scipy.spatial.distance.cdist semantics."""
    an = np.linalg.norm(a, axis=-1, keepdims=True)
    bn = np.linalg.norm(b, axis=-1, keepdims=True)
    sim = (a @ b.T) / (an * bn.T)
    return 1.0 - sim


def set_num_clusters(
    num_embeddings: int,
    num_clusters: Optional[int] = None,
    min_clusters: Optional[int] = None,
    max_clusters: Optional[int] = None,
) -> Tuple[Optional[int], int, int]:
    """Bound resolution, Clustering.py:21-43."""
    min_c = num_clusters or min_clusters or 1
    min_c = max(1, min(num_embeddings, min_c))
    max_c = num_clusters or max_clusters or num_embeddings
    max_c = max(1, min(num_embeddings, max_c))
    if min_c > max_c:
        raise ValueError(
            f"min_clusters must be <= max_clusters (got {min_c} > {max_c})"
        )
    if min_c == max_c:
        num_clusters = min_c
    return num_clusters, min_c, max_c


def filter_embeddings(
    embeddings: np.ndarray,
    max_num_embeddings: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Drop NaN rows; (chunks, speakers, d) -> (N, d) + index arrays
    (Clustering.py:46-78). Optionally subsample to ``max_num_embeddings``
    (the pyannote BaseClustering cap, Clustering.py:69-76).

    Subsampling is EVENLY STRIDED over the valid rows in order
    (keep[k] = floor(k*N/K)) — deterministic where pyannote uses the
    unseeded global ``random`` module (so any selection is within
    pyannote's own semantic variance), and exactly mirrored by the
    on-device path (clustering/device.py select_train_rows), so both paths
    cluster the identical train set."""
    chunk_idx, speaker_idx = np.where(~np.any(np.isnan(embeddings), axis=2))
    num = len(chunk_idx)
    if max_num_embeddings is not None and num > max_num_embeddings:
        keep = (np.arange(max_num_embeddings) * num) // max_num_embeddings
        chunk_idx, speaker_idx = chunk_idx[keep], speaker_idx[keep]
    return embeddings[chunk_idx, speaker_idx], chunk_idx, speaker_idx


def assign_embeddings(
    embeddings: np.ndarray,
    train_chunk_idx: np.ndarray,
    train_speaker_idx: np.ndarray,
    train_clusters: np.ndarray,
    constrained: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Centroid assignment of every embedding (Clustering.py:97-164).

    soft = 2 - cosine_distance(embedding, centroid); hard = argmax.
    """
    num_clusters = int(np.max(train_clusters)) + 1
    num_chunks, num_speakers, dim = embeddings.shape
    train_embeddings = embeddings[train_chunk_idx, train_speaker_idx]
    centroids = np.vstack(
        [
            np.mean(train_embeddings[train_clusters == k], axis=0)
            for k in range(num_clusters)
        ]
    )
    e2k = cosine_cdist(embeddings.reshape(-1, dim), centroids).reshape(
        num_chunks, num_speakers, num_clusters
    )
    soft_clusters = 2.0 - e2k
    if constrained:
        hard_clusters = constrained_argmax(soft_clusters)
    else:
        hard_clusters = np.argmax(soft_clusters, axis=2)
    return hard_clusters, soft_clusters


def constrained_argmax(soft_clusters: np.ndarray) -> np.ndarray:
    """One cluster per local speaker via the Hungarian algorithm
    (Clustering.py:81-94 — an option the C++ did not port)."""
    from scipy.optimize import linear_sum_assignment

    soft = np.nan_to_num(soft_clusters, nan=np.nanmin(soft_clusters))
    num_chunks, num_speakers, _ = soft.shape
    hard = -2 * np.ones((num_chunks, num_speakers), dtype=np.int64)
    for c, cost in enumerate(soft):
        speakers, clusters = linear_sum_assignment(cost, maximize=True)
        for s, k in zip(speakers, clusters):
            hard[c, s] = k
    return hard


@dataclasses.dataclass
class AgglomerativeClustering:
    """pyannote AgglomerativeClustering semantics (Clustering.py:241-428)."""

    config: ClusteringConfig = dataclasses.field(default_factory=ClusteringConfig)
    constrained_assignment: bool = False
    # pyannote BaseClustering caps the AHC train set at 1000 and assigns the
    # remaining embeddings to the learned centroids (Clustering.py:12-18,
    # 69-76). _UNSET defers to config.max_num_embeddings (default 1000 —
    # pyannote-compatible); pass None explicitly to cluster on everything.
    # Subsampling is deterministic here (evenly strided, see
    # filter_embeddings) where pyannote uses the unseeded global random
    # module — partition-equivalent behavior, device-path-identical.
    max_num_embeddings: object = dataclasses.field(default="_unset")

    def __post_init__(self):
        if self.max_num_embeddings == "_unset":
            self.max_num_embeddings = getattr(
                self.config, "max_num_embeddings", None
            )

    def cluster(
        self,
        embeddings: np.ndarray,
        min_clusters: int,
        max_clusters: int,
        num_clusters: Optional[int] = None,
        dump=None,
    ) -> np.ndarray:
        cfg = self.config
        num_embeddings = embeddings.shape[0]
        min_cluster_size = min(
            cfg.min_cluster_size, max(1, round(0.1 * num_embeddings))
        )
        if num_embeddings == 1:
            return np.zeros((1,), dtype=np.int64)

        emb = np.array(embeddings, dtype=np.float64)
        if cfg.metric == "cosine" and cfg.method in ("centroid", "median", "ward"):
            # unit-normalize so Euclidean ~ cosine (Clustering.py:319-324)
            with np.errstate(divide="ignore", invalid="ignore"):
                emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
        if dump is not None:
            # reference dump names from the clustering stage
            # (speakerDiarizer.cpp:2319-2327, clustering.cpp:417-440)
            dump.dump("norm_embeddings", emb)
            diff = emb[:, None, :] - emb[None, :, :]
            D = np.sqrt(np.sum(diff * diff, axis=-1))
            iu = np.triu_indices(num_embeddings, k=1)
            dump.dump("dist", D[iu])
        dendrogram = ahc.linkage(emb, method=cfg.method)
        if dump is not None:
            dump.dump("clusterRes", dendrogram)

        clusters = ahc.fcluster_distance(dendrogram, cfg.threshold)
        cluster_unique, cluster_counts = np.unique(clusters, return_counts=True)
        large_clusters = cluster_unique[cluster_counts >= min_cluster_size]
        num_large_clusters = len(large_clusters)

        if num_large_clusters < min_clusters:
            num_clusters = min_clusters
        elif num_large_clusters > max_clusters:
            num_clusters = max_clusters

        if num_clusters is not None:
            # switch stopping criterion to iteration index and walk outward
            # from the optimal threshold (Clustering.py:352-399)
            iteration_crit = np.arange(num_embeddings - 1, dtype=np.float64)
            best_iteration = num_embeddings - 1
            best_num_large = 1
            for iteration in np.argsort(np.abs(dendrogram[:, 2] - cfg.threshold)):
                if dendrogram[iteration, 3] < min_cluster_size:
                    continue
                clusters = ahc.fcluster_distance(
                    dendrogram, float(iteration), monocrit=iteration_crit
                )
                cluster_unique, cluster_counts = np.unique(clusters, return_counts=True)
                large_clusters = cluster_unique[cluster_counts >= min_cluster_size]
                num_large_clusters = len(large_clusters)
                if abs(num_large_clusters - num_clusters) < abs(best_num_large - num_clusters):
                    best_iteration = iteration
                    best_num_large = num_large_clusters
                if num_large_clusters == num_clusters:
                    break
            if num_large_clusters != num_clusters:
                clusters = ahc.fcluster_distance(
                    dendrogram, float(best_iteration), monocrit=iteration_crit
                )
                cluster_unique, cluster_counts = np.unique(clusters, return_counts=True)
                large_clusters = cluster_unique[cluster_counts >= min_cluster_size]
                num_large_clusters = len(large_clusters)

        if num_large_clusters == 0:
            return np.zeros_like(clusters)

        small_clusters = cluster_unique[cluster_counts < min_cluster_size]
        if len(small_clusters) == 0:
            return clusters

        # reassign each small cluster to the nearest large cluster by centroid
        large_centroids = np.vstack(
            [np.mean(emb[clusters == k], axis=0) for k in large_clusters]
        )
        small_centroids = np.vstack(
            [np.mean(emb[clusters == k], axis=0) for k in small_clusters]
        )
        cd = cosine_cdist(large_centroids, small_centroids)
        for small_k, large_k in enumerate(np.argmin(cd, axis=0)):
            clusters[clusters == small_clusters[small_k]] = large_clusters[large_k]
        _, clusters = np.unique(clusters, return_inverse=True)
        return clusters

    def __call__(
        self,
        embeddings: np.ndarray,
        num_clusters: Optional[int] = None,
        min_clusters: Optional[int] = None,
        max_clusters: Optional[int] = None,
        dump=None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(chunks, speakers, d) NaN-padded embeddings -> (hard, soft)
        cluster assignments (Clustering.py:167-238)."""
        train_embeddings, train_chunk_idx, train_speaker_idx = filter_embeddings(
            embeddings, max_num_embeddings=self.max_num_embeddings
        )
        if dump is not None:
            dump.dump("filtered_embeddings", train_embeddings)
        num_embeddings = train_embeddings.shape[0]
        num_clusters, min_clusters, max_clusters = set_num_clusters(
            num_embeddings,
            num_clusters=num_clusters,
            min_clusters=min_clusters,
            max_clusters=max_clusters,
        )
        if max_clusters < 2:
            num_chunks, num_speakers, _ = embeddings.shape
            hard = np.zeros((num_chunks, num_speakers), dtype=np.int64)
            soft = np.ones((num_chunks, num_speakers, 1))
            return hard, soft

        train_clusters = self.cluster(
            train_embeddings,
            min_clusters,
            max_clusters,
            num_clusters=num_clusters,
            dump=dump,
        )
        if dump is not None:
            dump.dump("clusters", train_clusters)
        return assign_embeddings(
            embeddings,
            train_chunk_idx,
            train_speaker_idx,
            train_clusters,
            constrained=self.constrained_assignment,
        )
