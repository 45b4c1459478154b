"""The merge-loop kernel's schedule (csrc/linkage.cu), emulated on the CPU.

The kernel splits the slots among the C blocks of one thread-block cluster
(slot k to block k mod C) and never scans a whole matrix in a step: each row
keeps its minimum and the first column holding it incrementally, a row is
scanned again only if that column was merged away, each block offers its
least row minimum as a candidate (and its part of the new row's minimum),
the candidates are reduced in block order, and j0 is the winner's stored
first column. ``cluster_schedule`` repeats that bookkeeping step by step,
with the same arithmetic as the plain loop; it must give the plain loop's
``rep``, steps and merge log bit for bit, so a tie rule or an ownership
mistake shows here before the kernel runs on a card. The kernel's division
by a row count is checked against a true division in exact arithmetic.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

from pyannote_audio_speaker_diarization_cpp_tpu_torch.clustering.device import (
    initial_distances,
)
from pyannote_audio_speaker_diarization_cpp_tpu_torch.config import ClusteringConfig
from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops import linkage_cuda
from test_torch_cuda import _linkage_rows

THRESHOLD = ClusteringConfig().threshold
NONE = 2**31 - 1
INF = np.float32(np.inf)


def _less(a, b):
    """(value, index, ...) a before b: lower value, then lower index."""
    return a[0] < b[0] or (a[0] == b[0] and a[1] < b[1])


def _first_min(row):
    """(least value, first column holding it) of a row; (inf, NONE) if none
    is finite, as the kernel's scan gives."""
    c = int(np.argmin(row))
    return (row[c], c) if row[c] < INF else (INF, NONE)


def cluster_schedule(D0, embt, tvalid, thr, C):
    """The kernel's schedule with C blocks -> (rep, steps, merges, dists) as
    numpy arrays."""
    T = embt.shape[0]
    D = D0.numpy().copy()
    cent = embt.clone()
    alive = tvalid.numpy().copy()
    size = torch.tensor(alive, dtype=torch.float32)
    maxd = torch.zeros(T, dtype=torch.float32)
    leaf = np.arange(T)
    rep = np.arange(T, dtype=np.int32)
    merges = np.full((max(T - 1, 0), 2), -1, np.int32)
    dists = np.full(max(T - 1, 0), INF, np.float32)
    rowmin = np.empty(T, np.float32)
    rowarg = np.empty(T, np.int64)
    for k in range(T):
        rowmin[k], rowarg[k] = _first_min(D[k])
    owned = [range(b, T, C) for b in range(C)]

    def candidates(exclude, r=None):
        """Each block's (rowmin, row, rowarg) over its live rows but
        ``exclude``, and (r_k, k) over the same rows."""
        out = []
        for b in range(C):
            best, part = (INF, NONE, NONE), (INF, NONE)
            for k in owned[b]:
                if alive[k] and k != exclude:
                    if _less((rowmin[k], k, rowarg[k]), best):
                        best = (rowmin[k], k, rowarg[k])
                    if r is not None and _less((r[k], k), part):
                        part = (r[k], k)
            out.append((best, part))
        return out

    cands, iprev, step = candidates(-1), -1, 0
    while step < T - 1:
        # A: the blocks' candidates in block order, then row i' of the last merge
        best, part = (INF, NONE, NONE), (INF, NONE)
        for b_best, b_part in cands:
            if _less(b_best, best):
                best = b_best
            if _less(b_part, part):
                part = b_part
        if iprev >= 0:
            rowmin[iprev], rowarg[iprev] = part
            if _less((part[0], iprev, part[1]), best):
                best = (part[0], iprev, part[1])
        dmin, i0, j0 = best
        dists[step] = dmin
        step += 1
        if not dmin <= thr:
            break
        i, j = min(i0, j0), max(i0, j0)
        merges[step - 1] = i, j
        ni, nj = size[i], size[j]
        den = torch.clamp(ni + nj, min=1.0).repeat(cent.shape[1])
        newc = (ni * cent[i] + nj * cent[j]) / den
        newmax = torch.maximum(torch.tensor(dmin), torch.maximum(maxd[i], maxd[j]))
        cent[i], size[i], maxd[i] = newc, ni + nj, newmax
        alive[j] = False
        # B: every block's live rows but i: distance, columns i and j, minimum
        r = linkage_cuda.centroid_distances(cent, newc).numpy()
        D[i, j] = INF
        for b in range(C):
            for k in owned[b]:
                if not alive[k] or k == i:
                    continue
                D[k, i] = D[i, k] = r[k]
                D[k, j] = INF
                v, a = rowmin[k], rowarg[k]
                if v != INF and a in (i, j):
                    v, a = _first_min(D[k])
                elif r[k] < v or (r[k] == v and i < a):
                    v, a = r[k], i
                rowmin[k], rowarg[k] = v, a
        cands = candidates(i, r)
        leaf[leaf == j] = i
        if bool(newmax <= thr):
            rep[leaf == i] = T + step - 1
        iprev = i
    return rep, step, merges, dists


# (kind, T): ties everywhere (identical rows), ties in several columns
# (duplicated rows; motifs that tie a row's minimum at a lower column), one
# valid row, T that C does not divide (100), T below C (12), and the main
# path's size (384)
_CASES = [
    ("blobs", 48),
    ("blobs", 100),
    ("blobs", 384),
    ("chain", 48),
    ("chain", 100),
    ("chain", 384),
    ("identical", 48),
    ("identical", 100),
    ("dups", 48),
    ("dups", 100),
    ("dups", 384),
    ("ties", 48),
    ("ties", 100),
    ("ties", 384),
    ("one_valid", 12),
    ("one_valid", 100),
    ("blobs", 12),
]


@pytest.mark.parametrize("C", [8, 16])
@pytest.mark.parametrize("kind,T", _CASES)
def test_cluster_schedule_matches_plain(kind, T, C):
    embt, tvalid = _linkage_rows(kind, T, seed=T, d=32)
    D0 = initial_distances(embt, tvalid)
    want = linkage_cuda.linkage_labels_plain(D0, embt, tvalid, THRESHOLD)
    rep, steps, merges, dists = cluster_schedule(D0, embt, tvalid, THRESHOLD, C)
    assert steps == int(want.steps)
    assert np.array_equal(rep, want.rep.numpy())
    assert np.array_equal(merges, want.merges.numpy())
    assert np.array_equal(dists, want.dists.numpy())
    if kind == "identical":  # every distance ties: T - 1 merges, one cluster
        assert steps == T - 1 and len(set(rep.tolist())) == 1


def _rn32(fr):
    """The float32 nearest to the rational fr, ties to even."""
    c = np.float32(float(fr))
    best = None
    for cand in (np.nextafter(c, np.float32(-np.inf)), c, np.nextafter(c, np.float32(np.inf))):
        dist = abs(Fraction(float(cand)) - fr)
        if best is None or dist < best[0] or (dist == best[0] and cand.view(np.int32) % 2 == 0):
            best = (dist, cand)
    return best[1]


def test_division_by_row_count_is_correctly_rounded():
    """The kernel divides a merged centroid by its row count n as
    q = x * r, q' = fma(fma(-n, q, x), r, q) with r = 1 / n correctly
    rounded: that must be the correctly rounded x / n, as the plain loop's
    true division is. Exact rational arithmetic, every n up to MAX_ROWS."""
    rng = np.random.default_rng(0)
    for n in range(1, linkage_cuda.MAX_ROWS + 1):
        r = _rn32(Fraction(1, n))
        xs = (rng.standard_normal(3) * 10.0 ** rng.integers(-3, 4, 3)).astype(np.float32)
        for x in xs:
            fx, fr = Fraction(float(x)), Fraction(float(r))
            q = _rn32(fx * fr)
            e = _rn32(fx - n * Fraction(float(q)))
            assert Fraction(float(e)) == fx - n * Fraction(float(q))  # the FMA's residual is exact
            assert _rn32(Fraction(float(q)) + Fraction(float(e)) * fr) == _rn32(fx / n), (x, n)
