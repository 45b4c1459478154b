"""Plain stage 3 of the pyannote v2.1 recipe: pyannote's
AgglomerativeClustering on the embeddings of one recording, in float64
numpy with scipy's linkage and fcluster.

- rows with a NaN embedding are left out; above ``max_num_embeddings``
  valid rows an evenly strided subsample (keep[k] = floor(k N / K), in row
  order) is clustered (pyannote draws it at random; the program under test
  draws it so, and a random draw would make two runs differ);
- rows L2-normalised, centroid linkage, flat clusters where each subtree's
  largest merge distance is at most ``threshold``;
- min_cluster_size = min(15, max(1, round(0.1 N))); with a speaker count
  given, the dendrogram cut is searched outward from the threshold's merge;
- each small cluster joins the large cluster with the nearest centroid;
- every row is assigned to the nearest centroid of the raw train rows by
  cosine; rows of silent local speakers get -2.

Cluster numbers follow the first appearance over the train rows, which is
the numbering a consumer of "cluster 0" (a row with no embedding) sees.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
from scipy.cluster.hierarchy import fcluster, linkage


def _cosine(a, b):
    an = np.linalg.norm(a, axis=-1, keepdims=True)
    bn = np.linalg.norm(b, axis=-1, keepdims=True)
    return 1.0 - (a @ b.T) / (an * bn.T)


def _first_appearance(labels: np.ndarray) -> np.ndarray:
    seen: Dict[int, int] = {}
    return np.array([seen.setdefault(int(x), len(seen)) for x in labels], dtype=np.int64)


def _large(clusters, mcs):
    uniq, counts = np.unique(clusters, return_counts=True)
    return uniq, counts, uniq[counts >= mcs]


def cluster_train(emb: np.ndarray, cfg: Dict, min_c: int, max_c: int,
                  num_clusters: Optional[int]) -> np.ndarray:
    n = emb.shape[0]
    mcs = min(cfg["min_cluster_size"], max(1, round(0.1 * n)))
    if n == 1:
        return np.zeros(1, dtype=np.int64)
    x = emb / np.linalg.norm(emb, axis=-1, keepdims=True)
    Z = linkage(x, method="centroid", metric="euclidean")
    clusters = _first_appearance(fcluster(Z, cfg["threshold"], criterion="distance"))
    uniq, counts, large = _large(clusters, mcs)
    if len(large) < min_c:
        num_clusters = min_c
    elif len(large) > max_c:
        num_clusters = max_c
    if num_clusters is not None:
        crit = np.arange(n - 1, dtype=np.float64)

        def cut(i):
            return _first_appearance(fcluster(Z, float(i), criterion="monocrit", monocrit=crit))

        best_i, best_n = n - 1, 1
        for i in np.argsort(np.abs(Z[:, 2] - cfg["threshold"])):
            if Z[i, 3] < mcs:
                continue
            clusters = cut(i)
            uniq, counts, large = _large(clusters, mcs)
            if abs(len(large) - num_clusters) < abs(best_n - num_clusters):
                best_i, best_n = i, len(large)
            if len(large) == num_clusters:
                break
        if len(large) != num_clusters:
            clusters = cut(best_i)
            uniq, counts, large = _large(clusters, mcs)
    if len(large) == 0:
        return np.zeros_like(clusters)
    small = uniq[counts < mcs]
    if len(small) == 0:
        return clusters
    lc = np.vstack([x[clusters == k].mean(axis=0) for k in large])
    sc = np.vstack([x[clusters == k].mean(axis=0) for k in small])
    for s, l in enumerate(np.argmin(_cosine(lc, sc), axis=0)):
        clusters[clusters == small[s]] = large[l]
    return np.unique(clusters, return_inverse=True)[1]


def cluster(embeddings: np.ndarray, inactive: np.ndarray, cfg: Dict,
            num_speakers: Optional[int] = None) -> np.ndarray:
    """(chunks, S, D) float64 embeddings with NaN rows, (chunks, S) silent
    flags -> (chunks, S) labels."""
    chunks, s, d = embeddings.shape
    ci, si = np.where(~np.any(np.isnan(embeddings), axis=2))
    n = len(ci)
    cap = cfg["max_num_embeddings"]
    if cap is not None and n > cap:
        keep = (np.arange(cap) * n) // cap
        ci, si = ci[keep], si[keep]
    train = embeddings[ci, si]
    n = train.shape[0]
    min_c = max(1, min(n, num_speakers or 1))
    max_c = max(1, min(n, num_speakers or n))
    if max_c < 2:
        hard = np.zeros((chunks, s), dtype=np.int64)
    else:
        labels = cluster_train(train, cfg, min_c, max_c,
                               num_speakers if min_c == max_c else None)
        k = int(labels.max()) + 1
        cent = np.vstack([train[labels == j].mean(axis=0) for j in range(k)])
        with np.errstate(invalid="ignore"):
            sim = 2.0 - _cosine(embeddings.reshape(-1, d), cent)
        hard = np.argmax(sim.reshape(chunks, s, k), axis=2)
    hard[inactive] = -2
    return hard
