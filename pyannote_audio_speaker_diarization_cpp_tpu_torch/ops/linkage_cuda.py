"""Centroid-linkage merge loop of the device AHC: CUDA kernel wrapper and
plain version.

Replaces the merge loop ``_linkage_labels`` of the JAX package
(clustering/device.py), a ``jax.lax.while_loop`` of up to T - 1 dependent
merges with an early exit that depends on the data. The JAX package wrote no
Pallas kernel for it; in eager PyTorch each iteration would be about a dozen
launches and a host read of ``done``, so on the card the whole loop is one
launch of ``csrc/linkage.cu`` (one thread-block cluster), whose header says
what bounds it and how it is laid out. The plain version is the same loop in
PyTorch, one iteration a Python step: the CPU path and the kernel's oracle.

Both take the initial (T, T) distance matrix D0 from the caller (a Gram
product, clustering/device.py ``initial_distances``) and compute every later
distance directly, in one fixed order that both repeat bit for bit: the
squared differences summed in 32 lanes of d/32 terms each, then the 32 lane
sums pairwise (16, 8, 4, 2, 1 apart), then the correctly rounded square
root. With the same
D0 the kernel and the plain version give the same ``rep`` and the same merge
log (each step's pair and distance), which a check can hold them to: ``rep``
alone keeps only each flat cluster's topmost merge, so a wrong merge order
can leave it unchanged.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _cuda_lib

MAX_ROWS = 1536  # the largest merge loop the pipeline sends to the card
MAX_DIM = 1024
# linkage_launch(D0, embt, tvalid, D, cent, rep, steps, merges, dists, T, d, thr, stream)
LAUNCH_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_int, ctypes.c_float] + [
    ctypes.c_void_p
]


class LinkagePlan(NamedTuple):
    """The kernel's launch for T rows of d values on the current card."""

    cluster: int  # blocks of the one thread-block cluster
    smem_bytes: int  # dynamic shared memory a block
    cent_shared: bool  # the centroids in shared memory (else global scratch)
    d_shared: bool  # the rows of D in shared memory (else global scratch)


def linkage_plan(T: int, d: int, lib=None) -> LinkagePlan:
    """How ``csrc/linkage.cu`` (or the built library ``lib`` of a variant
    of it) lays out T rows of d values on the current CUDA device; raises if
    it does not take them."""
    lib = lib or _cuda_lib.library("linkage")
    out = [ctypes.c_int(0) for _ in range(4)]
    fn = lib.linkage_plan
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 4
    _cuda_lib.check("linkage", fn(T, d, *(ctypes.byref(o) for o in out)))
    cluster, smem, cent_shared, d_shared = (o.value for o in out)
    return LinkagePlan(cluster, smem, bool(cent_shared), bool(d_shared))


def d_scratch(D0: torch.Tensor, lib=None) -> torch.Tensor:
    """Global scratch for the rows of D when they do not fit in shared
    memory: T rows of the kernel's row stride (T rounded up to whole float4s)."""
    lib = lib or _cuda_lib.library("linkage")
    fn = lib.linkage_row_stride
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int]
    return D0.new_empty(D0.shape[0] * fn(D0.shape[0]))


class LinkageResult(NamedTuple):
    """The merge loop's output, every tensor on the input's device."""

    rep: torch.Tensor  # (T,) int32: each row's topmost accepted merge bin, in [0, 2T)
    steps: torch.Tensor  # (1,) int32: steps run, the refused last one included
    merges: torch.Tensor  # (T - 1, 2) int32: (i, j) merged at each step; -1 if none
    dists: torch.Tensor  # (T - 1,) float32: each step's least distance; inf past the end


def centroid_distances(centroids: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(T, d) slots, (d,) centroid -> (T,) Euclidean distances, summed in the
    kernel's order: lane l of 32 adds the squares of elements l, l + 32, ...
    in turn, then the lane sums are added 16, 8, 4, 2 and 1 apart. The root
    is taken in float64 and rounded once to float32: correctly rounded on
    any device, as the kernel's (the CPU's float32 sqrt is not always)."""
    T, d = centroids.shape
    diff = centroids - c[None, :]
    sq = diff * diff
    pad = -d % 32
    if pad:
        sq = torch.cat([sq, sq.new_zeros((T, pad))], dim=1)
    sq = sq.view(T, -1, 32)
    acc = sq[:, 0]
    for m in range(1, sq.shape[1]):
        acc = acc + sq[:, m]
    for half in (16, 8, 4, 2, 1):
        acc = acc[:, :half] + acc[:, half : 2 * half]
    return torch.sqrt(acc[:, 0].double()).to(torch.float32)


def linkage_labels_plain(
    D0: torch.Tensor,
    embt: torch.Tensor,
    tvalid: torch.Tensor,
    threshold: float,
    early_exit: bool = True,
) -> LinkageResult:
    """Plain PyTorch version of the kernel, same contract as
    ``linkage_labels``: the JAX loop's state and body, one merge a step.
    ``early_exit=False`` runs all T - 1 steps (after the first refused merge
    a step changes nothing that decides ``rep``; the merge log ends there
    all the same)."""
    T, d = embt.shape
    dev = embt.device
    f32 = torch.float32
    inf = torch.tensor(float("inf"), dtype=f32, device=dev)
    D = D0.clone()
    rowmins = D.min(dim=1).values
    centroids = embt.clone()
    size = tvalid.to(f32)
    alive = tvalid.clone()
    leaf_slot = torch.arange(T, device=dev)
    maxd = torch.zeros(T, dtype=f32, device=dev)
    rep = torch.arange(T, dtype=torch.int32, device=dev)
    merges = torch.full((max(T - 1, 0), 2), -1, dtype=torch.int32)
    dists = torch.full((max(T - 1, 0),), float("inf"), dtype=f32)
    it, refused = 0, False
    while it < T - 1:
        i0 = int(torch.argmin(rowmins))
        j0 = int(torch.argmin(D[i0]))
        i, j = min(i0, j0), max(i0, j0)
        dmin = rowmins[i0]
        it += 1
        if not refused:
            dists[it - 1] = dmin.cpu()
        if not bool(dmin <= threshold):
            refused = True
            if early_exit:
                break
            # the masked body with ok false: only column i takes row i's values
            D[:, i] = D[i, :].clone()
            rowmins = D.min(dim=1).values
            continue
        merges[it - 1, 0], merges[it - 1, 1] = i, j
        ni, nj = size[i], size[j]
        den = torch.clamp(ni + nj, min=1.0).repeat(d)  # a true division, element by element
        newc = (ni * centroids[i] + nj * centroids[j]) / den
        newmax = torch.maximum(dmin, torch.maximum(maxd[i], maxd[j]))
        accepted = bool(newmax <= threshold)
        leaf_slot = torch.where(leaf_slot == j, i, leaf_slot)
        if accepted:
            rep = torch.where(leaf_slot == i, T + it - 1, rep).to(torch.int32)
        centroids[i] = newc
        size[i] = ni + nj
        size[j] = 0.0
        alive[j] = False
        maxd[i] = newmax
        row = torch.where(alive, centroid_distances(centroids, newc), inf)
        row[i] = inf
        D[i, :] = row
        D[:, i] = row
        D[j, :] = inf
        D[:, j] = inf
        rowmins = D.min(dim=1).values
    steps = torch.tensor([it], dtype=torch.int32, device=dev)
    return LinkageResult(rep, steps, merges.to(dev), dists.to(dev))


def linkage_labels(
    D0: torch.Tensor,
    embt: torch.Tensor,
    tvalid: torch.Tensor,
    threshold: float,
) -> LinkageResult:
    """Centroid-linkage merge loop over T L2-normalised train rows.

    D0 (T, T) float32: initial distances, inf off the valid pairs and on the
    diagonal; embt (T, d) float32 train rows; tvalid (T,) bool. Returns a
    ``LinkageResult`` on the input's device: ``rep``, and the steps run and
    merge log that diagnostics read (the pipeline reads ``rep`` alone and
    never waits on the others).

    On a CUDA tensor this launches ``csrc/linkage.cu`` once (the whole loop,
    early exit on the card) or raises; on a CPU tensor it runs
    ``linkage_labels_plain``. D0 is left as it is.
    """
    if embt.dim() != 2 or D0.shape != (embt.shape[0], embt.shape[0]) or tvalid.shape != (
        embt.shape[0],
    ):
        raise ValueError(
            f"linkage_labels wants D0 (T, T), embt (T, d), tvalid (T,), got "
            f"{tuple(D0.shape)}, {tuple(embt.shape)}, {tuple(tvalid.shape)}"
        )
    T, d = embt.shape
    if embt.device.type == "cpu":
        return linkage_labels_plain(D0, embt, tvalid, threshold)
    if embt.device.type != "cuda" or D0.device != embt.device or tvalid.device != embt.device:
        raise ValueError(
            f"linkage_labels: tensors on {D0.device}, {embt.device} and {tvalid.device}"
        )
    if D0.dtype != torch.float32 or embt.dtype != torch.float32 or tvalid.dtype != torch.bool:
        raise ValueError("linkage_labels: D0 and embt must be float32, tvalid bool")
    if not (D0.is_contiguous() and embt.is_contiguous() and tvalid.is_contiguous()):
        raise ValueError("linkage_labels: inputs must be contiguous")
    if not 0 < T <= MAX_ROWS or not 0 < d <= MAX_DIM:
        raise ValueError(
            f"linkage_labels: the kernel takes 1..{MAX_ROWS} rows of 1..{MAX_DIM} "
            f"values, got {T} x {d}"
        )
    dev = embt.device
    rep = torch.empty(T, dtype=torch.int32, device=dev)
    steps = torch.empty(1, dtype=torch.int32, device=dev)
    merges = torch.empty((T - 1, 2), dtype=torch.int32, device=dev)
    dists = torch.empty(T - 1, dtype=torch.float32, device=dev)
    lib = _cuda_lib.library("linkage")
    fn = lib.linkage_launch
    fn.restype = ctypes.c_int
    fn.argtypes = LAUNCH_ARGTYPES
    with torch.cuda.device(dev):
        plan = linkage_plan(T, d)
        # global scratch for what does not fit in the blocks' shared memory:
        # the rows of D (each padded to whole float4s), the slots' centroids
        D = None if plan.d_shared else d_scratch(D0, lib)
        centroids = None if plan.cent_shared else torch.empty_like(embt)
        err = fn(
            D0.data_ptr(),
            embt.data_ptr(),
            tvalid.view(torch.uint8).data_ptr(),
            None if D is None else D.data_ptr(),
            None if centroids is None else centroids.data_ptr(),
            rep.data_ptr(),
            steps.data_ptr(),
            merges.data_ptr(),
            dists.data_ptr(),
            T,
            d,
            float(threshold),
            _cuda_lib.stream_of(embt),
        )
    _cuda_lib.check("linkage", err)
    linkage_labels.launches += 1
    return LinkageResult(rep, steps, merges, dists)


linkage_labels.launches = 0
