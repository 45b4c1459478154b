"""Agglomerative hierarchical clustering with scipy-compatible semantics.

Re-design of the reference's hand-port of scipy's ``fast_linkage``/``fcluster``
(reference pipeline/src/clustering/clustering.cpp:28-468: indexed min-heap,
centroid Lance-Williams update, max-dist DFS and monocrit cut; Python original
scipy.cluster.hierarchy as invoked by clustering/Clustering.py:319-333).

The reference needs 483 lines of heap machinery because it merges one pair at
a time over scalar loops. At diarization scale (N = a few hundred to a few
thousand embeddings for hour-long audio) scipy's linkage, or the simple
O(N^2)-per-merge global argmin over a dense distance matrix kept here as the
dependency-free oracle, is fast enough and trivially verifiable.

Semantics notes:
  - "centroid" linkage can produce dendrogram inversions; fcluster's
    max-dist-per-subtree machinery handles them exactly like scipy.
  - labels are partition-equivalent to scipy's (cluster numbering may
    differ; every consumer renumbers via np.unique, Clustering.py:427).
"""

from __future__ import annotations

import numpy as np


def linkage(
    embeddings: np.ndarray,
    method: str = "centroid",
    backend: str = "auto",
) -> np.ndarray:
    """(N, d) -> (N-1, 4) linkage matrix [id_a, id_b, dist, size].

    Global-minimum merge order over Euclidean centroid distances, matching
    scipy.cluster.hierarchy.linkage(method="centroid"|"single"|"average"|
    "complete"|"ward", metric="euclidean").

    backend: "auto" (scipy, then numpy), "scipy", or "numpy" (the in-tree
    global-argmin implementation, kept as the dependency-free oracle).
    """
    X = np.asarray(embeddings, dtype=np.float64)
    n = X.shape[0]
    if n < 2:
        return np.zeros((0, 4))

    if backend not in ("auto", "scipy", "numpy"):
        raise ValueError(f"unknown linkage backend: {backend!r}")
    if backend in ("auto", "scipy"):
        try:
            from scipy.cluster.hierarchy import linkage as scipy_linkage

            return scipy_linkage(X, method=method, metric="euclidean")
        except ImportError:
            if backend == "scipy":
                raise

    # current inter-cluster distance matrix
    if method in ("centroid", "ward"):
        sq = np.sum(X * X, axis=1)
        D2 = np.maximum(sq[:, None] + sq[None, :] - 2.0 * (X @ X.T), 0.0)
        D = np.sqrt(D2)
    else:
        diff = X[:, None, :] - X[None, :, :]
        D = np.sqrt(np.sum(diff * diff, axis=-1))
    np.fill_diagonal(D, np.inf)

    size = np.ones(n)
    cluster_id = np.arange(n)  # scipy id of the cluster in each active slot
    centroids = X.copy()
    active = np.ones(n, dtype=bool)
    Z = np.zeros((n - 1, 4))

    for it in range(n - 1):
        # D rows/cols of dead slots are kept at +inf, so a plain argmin works
        flat = np.argmin(D)
        i, j = divmod(flat, n)
        if i > j:
            i, j = j, i
        d = D[i, j]
        ida, idb = cluster_id[i], cluster_id[j]
        if ida > idb:
            ida, idb = idb, ida
        ni, nj = size[i], size[j]
        Z[it] = (ida, idb, d, ni + nj)

        # merged cluster occupies slot i; slot j dies
        if method == "centroid":
            centroids[i] = (ni * centroids[i] + nj * centroids[j]) / (ni + nj)
            diff = centroids - centroids[i]
            row = np.sqrt(np.sum(diff * diff, axis=-1))
            row[~active] = np.inf
            D[i, :] = row
            D[:, i] = row
        elif method == "single":
            D[i, :] = np.minimum(D[i, :], D[j, :])
            D[:, i] = D[i, :]
        elif method == "complete":
            D[i, :] = np.maximum(D[i, :], D[j, :])
            D[:, i] = D[i, :]
        elif method == "average":
            D[i, :] = (ni * D[i, :] + nj * D[j, :]) / (ni + nj)
            D[:, i] = D[i, :]
        elif method == "ward":
            nk = size
            dik2, djk2, dij2 = D[i, :] ** 2, D[j, :] ** 2, d * d
            tot = ni + nj + nk
            D[i, :] = np.sqrt(
                ((ni + nk) * dik2 + (nj + nk) * djk2 - nk * dij2) / tot
            )
            D[:, i] = D[i, :]
        else:
            raise ValueError(f"unsupported linkage method: {method}")
        D[i, i] = np.inf
        active[j] = False
        D[j, :] = np.inf
        D[:, j] = np.inf
        size[i] = ni + nj
        cluster_id[i] = n + it

    return Z


def max_dist_per_node(Z: np.ndarray) -> np.ndarray:
    """Max linkage distance within each internal node's subtree.

    Handles centroid inversions like scipy's get_max_dist_for_each_cluster
    (ported by the reference at clustering.cpp:121-172).
    """
    n = Z.shape[0] + 1
    max_dist = np.zeros(n - 1)
    for i in range(n - 1):
        d = Z[i, 2]
        for child in (int(Z[i, 0]), int(Z[i, 1])):
            if child >= n:
                d = max(d, max_dist[child - n])
        max_dist[i] = d
    return max_dist


def fcluster_distance(Z: np.ndarray, t: float, monocrit: np.ndarray | None = None) -> np.ndarray:
    """Flat clusters from a linkage matrix, criterion="distance".

    Cuts the dendrogram wherever the subtree's monocrit (max linkage distance
    by default) exceeds ``t`` — scipy fcluster semantics via cluster_monocrit
    (reference port at clustering.cpp:174-232). Returns 0-based labels in
    leaf-DFS order.
    """
    n = Z.shape[0] + 1
    if n == 1:
        return np.zeros(1, dtype=np.int64)
    crit = max_dist_per_node(Z) if monocrit is None else monocrit
    labels = np.full(n, -1, dtype=np.int64)
    next_label = 0

    # iterative DFS from the root, carrying the cluster label once a subtree
    # with crit <= t is entered; leaves reached without one become singletons
    stack = [(2 * n - 2, -1)]
    while stack:
        node, label = stack.pop()
        if node < n:
            if label < 0:
                label = next_label
                next_label += 1
            labels[node] = label
            continue
        row = node - n
        if label < 0 and crit[row] <= t:
            label = next_label
            next_label += 1
        # push right then left so left leaves are visited first
        stack.append((int(Z[row, 1]), label))
        stack.append((int(Z[row, 0]), label))

    # normalize to consecutive ids in leaf-appearance order
    first_seen: dict = {}
    for lab in labels:
        if lab not in first_seen:
            first_seen[lab] = len(first_seen)
    return np.array([first_seen[lab] for lab in labels], dtype=np.int64)


def cluster(
    embeddings: np.ndarray,
    threshold: float,
    method: str = "centroid",
) -> np.ndarray:
    """L2-normalize + linkage + distance cut — the reference's
    Clustering::cluster (clustering.cpp:459-468). Returns 0-based labels."""
    Z = linkage(embeddings, method=method)
    return fcluster_distance(Z, threshold)
