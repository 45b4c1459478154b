"""Agglomerative clustering on the device: stage 3 of a request without the
embeddings leaving the card.

Ported from the JAX package's clustering/device.py. It reproduces the host
path (clustering/base.py AgglomerativeClustering, pyannote
Clustering.py:8-428):

  - the train-set cap: above ``train_cap`` valid rows, an evenly strided
    subsample (the host's own selection, ``filter_embeddings``) is clustered
    and every row is then assigned to the learned centroids;
  - L2-normalised rows, so Euclidean distance orders as cosine;
  - centroid linkage, global-minimum merge order, cut at the threshold by
    each subtree's maximum merge distance: each leaf's flat cluster is its
    topmost accepted merge, kept as a running label during the loop;
  - min_cluster_size = min(15, max(1, round(0.1 N_train))) large/small split,
    small clusters joined to the nearest large one by centroid cosine;
  - each row assigned to the cluster means of the raw train rows by cosine.

The merge loop is ops/linkage_cuda.py: one launch of ``csrc/linkage.cu`` on
a CUDA tensor, the plain loop on a CPU tensor. The three Gram products run
in full float32 (TF32 off), as the JAX package pins them to HIGHEST. The
per-cluster sums are one-hot products rather than scatter-adds, so that the
card sums in one fixed order and a request gives the same turns every time.

Cluster numbering is partition-equivalent to the host's, not identical
(here by merge-bin index); every consumer is numbering-invariant. The host
path stays the route for explicit speaker bounds, row counts above the
pipeline's cap, num_large == 0 and num_large > k_max.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch

from ..ops import linkage_cuda


class DeviceClusterResult(NamedTuple):
    hard: torch.Tensor  # (R,) int32: cluster id, or -2 for inactive rows
    num_large: torch.Tensor  # () int32: number of clusters (0 => host path)


@contextlib.contextmanager
def _full_float32():
    """Float32 matmuls without TF32 for the duration, flag restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _gram(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    with _full_float32():
        return a @ b.T


def _pairwise_sq_dists(x: torch.Tensor) -> torch.Tensor:
    """(T, d) -> (T, T) squared Euclidean distances from the Gram product."""
    sq = torch.sum(x * x, dim=1)
    return torch.clamp(sq[:, None] + sq[None, :] - 2.0 * _gram(x, x), min=0.0)


def initial_distances(embt: torch.Tensor, tvalid: torch.Tensor) -> torch.Tensor:
    """The merge loop's first (T, T) distance matrix: sqrt of the Gram-form
    squared distances, inf off the valid pairs and on the diagonal. Every
    later distance is direct (the JAX ``_dist_row``:
    ops/linkage_cuda.py ``centroid_distances``)."""
    T = embt.shape[0]
    D0 = torch.sqrt(_pairwise_sq_dists(embt))
    live = tvalid[:, None] & tvalid[None, :]
    live &= ~torch.eye(T, dtype=torch.bool, device=embt.device)
    return torch.where(live, D0, torch.full_like(D0, float("inf")))


def select_train_rows(valid: torch.Tensor, train_size: int, train_cap: int):
    """Evenly strided selection of up to ``train_cap`` valid rows, the host
    selection exactly (filter_embeddings: keep[k] = floor(k * N / K) over the
    valid rows in order). Returns (sel (train_size,) int64 row indices,
    tvalid (train_size,) bool, K () int64)."""
    R = valid.shape[0]
    dev = valid.device
    vi = valid.to(torch.int64)
    rank = torch.cumsum(vi, 0) - vi  # 0-based rank among valid rows
    n_valid = vi.sum()
    K = torch.clamp(n_valid, max=train_cap)
    # row index holding each rank; invalid rows land in the dropped slot R
    idx_of_rank = torch.zeros(R + 1, dtype=torch.int64, device=dev)
    idx_of_rank[torch.where(valid, rank, R)] = torch.arange(R, device=dev)
    k = torch.arange(train_size, device=dev)
    t = (k * n_valid) // torch.clamp(K, min=1)
    sel = idx_of_rank[torch.clamp(t, 0, R - 1)]
    return sel, k < K, K


def train_rows(
    emb: torch.Tensor,
    valid: torch.Tensor,
    train_cap: Optional[int] = 1000,
    train_size: Optional[int] = None,
):
    """(R, d) float32 rows -> the merge loop's inputs: (embt (T, d) the
    selected rows L2-normalised, zero where not valid; tvalid (T,) bool;
    sel (T,) their row indices; K () the train-set size). Invalid rows come
    out as zeros whatever they held, so they never carry NaN into the loop."""
    R = emb.shape[0]
    if train_cap is None:
        train_cap = R
    if train_size is None:
        train_size = min(R, -(-train_cap // 128) * 128)
    norms = torch.sqrt(torch.sum(emb * emb, dim=1, keepdim=True))
    embn = torch.where(valid[:, None], emb / torch.clamp(norms, min=1e-30), 0.0)
    sel, tvalid, K = select_train_rows(valid, train_size, train_cap)
    embt = torch.where(tvalid[:, None], embn[sel], 0.0)
    return embt, tvalid, sel, K


def _linkage_labels(embt: torch.Tensor, tvalid: torch.Tensor, threshold: float) -> torch.Tensor:
    """Centroid-linkage merge loop over (T, d) L2-normalised train rows ->
    rep (T,) int32, each row's topmost accepted merge bin in [0, 2T). One
    launch of the CUDA kernel on the card, the plain loop on the CPU."""
    return linkage_cuda.linkage_labels(
        initial_distances(embt, tvalid), embt.contiguous(), tvalid.contiguous(), threshold
    ).rep


def device_cluster(
    emb: torch.Tensor,
    valid: torch.Tensor,
    inactive: torch.Tensor,
    threshold: float,
    min_cluster_size: int,
    k_max: int,
    train_cap: Optional[int] = 1000,
    train_size: Optional[int] = None,
) -> DeviceClusterResult:
    """Cluster (R, d) embeddings on their device.

    valid: (R,) bool, rows that hold a real embedding. inactive: (R,) bool,
    rows whose local speaker is silent (hard := -2). Invalid but active rows
    get cluster 0, as on the host (argmax over an all-NaN row).

    train_cap: the pyannote train-set cap; None clusters every valid row.
    train_size: the merge loop's size T, by default min(R, the cap rounded
    up to a multiple of 128).
    """
    f32 = torch.float32
    dev = emb.device
    emb = emb.to(f32)
    embt, tvalid, sel, K = train_rows(emb, valid, train_cap, train_size)
    T = embt.shape[0]
    tvalidf = tvalid.to(f32)

    # ---- centroid-linkage merge loop + threshold cut ----
    rep = _linkage_labels(embt, tvalid, threshold).long()

    # ---- large/small split over the 2T label bins (train-set counts) ----
    nbins = 2 * T
    bins = torch.arange(nbins, device=dev)
    onehot = (rep[:, None] == bins).to(f32) * tvalidf[:, None]  # (T, 2T)
    counts = onehot.sum(dim=0)  # small integers: exact in any order
    mcs = torch.clamp(torch.round(0.1 * K.to(f32)), min=1.0).clamp(max=float(min_cluster_size))
    is_large = (counts >= mcs) & (counts > 0.0)
    num_large = is_large.to(torch.int32).sum().to(torch.int32)

    # per-bin centroids of the NORMALISED train rows (the host reassignment
    # uses the normalised matrix)
    with _full_float32():
        csum = onehot.T @ embt
    bin_cent = csum / torch.clamp(counts, min=1.0)[:, None]
    bn = torch.sqrt(torch.sum(bin_cent * bin_cent, dim=1))
    sim = _gram(bin_cent, bin_cent) / torch.clamp(bn[:, None] * bn[None, :], min=1e-30)
    cosd = 1.0 - sim
    nearest_large = torch.argmin(cosd.masked_fill(~is_large[None, :], float("inf")), dim=1)
    is_small = (counts > 0.0) & ~is_large
    final_bin = torch.where(is_small, nearest_large, bins)
    label_bin = final_bin[rep]  # (T,) each train row's bin, all bins large

    # consecutive ids in bin-index order (partition-equivalent numbering)
    bin_rank = torch.cumsum(is_large.to(torch.int64), 0) - 1
    label = torch.clamp(bin_rank[label_bin], 0, k_max - 1)

    # ---- centroid assignment of every row over the RAW embeddings ----
    embr = torch.where(tvalid[:, None], emb[sel], 0.0)
    k_idx = torch.arange(k_max, device=dev)
    onehot_k = (label[:, None] == k_idx).to(f32) * tvalidf[:, None]
    with _full_float32():
        asum = onehot_k.T @ embr
    acnt = onehot_k.sum(dim=0)
    acent = asum / torch.clamp(acnt, min=1.0)[:, None]
    an = torch.sqrt(torch.sum(acent * acent, dim=1))
    rsim = _gram(emb, acent) / torch.clamp(
        torch.sqrt(torch.sum(emb * emb, dim=1))[:, None] * an[None, :], min=1e-30
    )
    rsim = rsim.masked_fill(~((k_idx[None, :] < num_large) & (acnt[None, :] > 0)), float("-inf"))
    hard = torch.argmax(rsim, dim=1).to(torch.int32)

    hard = torch.where(valid, hard, 0)
    hard = torch.where(inactive, -2, hard).to(torch.int32)
    return DeviceClusterResult(hard=hard, num_large=num_large)
