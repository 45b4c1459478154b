"""Frame bookkeeping and the timeline decode of the pyannote v2.1 recipe,
plain numpy: the overlap-add plan of windows onto the frame grid, the
per-cluster maximum and overlap-add, the top-count binarization and the
turns (hysteresis at 0.5, gaps shorter than ``min_duration_off`` filled).
Frozen from pyannote.core's SlidingWindow semantics (round-half-to-even
frame indices) as the reference C++ applies them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

Turn = Tuple[float, float, int]


@dataclasses.dataclass(frozen=True)
class SlidingWindow:
    start: float
    step: float
    duration: float

    def closest_frame(self, t: float) -> int:
        return int(np.rint(max((t - self.start - 0.5 * self.duration) / self.step, 0.0)))

    def crop_range(self, lo: float, hi: float) -> Tuple[int, int]:
        i = max(int(np.ceil((lo - self.duration - self.start) / self.step)), 0)
        return i, int(np.floor((hi - self.start) / self.step)) + 1

    def extent(self, n: int) -> Tuple[float, float]:
        first = self.start - 0.5 * self.step + 0.5 * self.duration
        return self.start, first + n * self.step


def plan(chunks: int, windows: SlidingWindow, frames: SlidingWindow):
    """(start frame of each window, output frames): windows of ``windows``
    onto a grid that starts where they start, with ``frames``' step."""
    grid = SlidingWindow(windows.start, frames.step, frames.duration)
    n_out = grid.closest_frame(windows.start + windows.duration + (chunks - 1) * windows.step) + 1
    starts = np.array([grid.closest_frame(windows.start + i * windows.step) for i in range(chunks)])
    return starts, n_out


def overlap_add(scores: np.ndarray, starts: np.ndarray, n_out: int, average: bool) -> np.ndarray:
    """(chunks, frames, K) with NaN for "no score" -> (n_out, K): the sum
    (or the mean) of the scores landing on each frame, 0 where none does."""
    chunks, frames, k = scores.shape
    ok = ~np.isnan(scores)
    idx = (starts[:, None] + np.arange(frames)[None, :]).reshape(-1)
    inside = idx < n_out
    total = np.zeros((n_out, k))
    hits = np.zeros((n_out, k))
    np.add.at(total, idx[inside], np.where(ok, scores, 0.0).reshape(-1, k)[inside])
    np.add.at(hits, idx[inside], ok.reshape(-1, k)[inside])
    if average:
        total = total / np.maximum(hits, np.finfo(np.float64).eps)
    return np.where(hits > 0, total, 0.0)


def grids(cfg: Dict, chunks: int):
    """(activation grid, its frames, count grid, its frames) of a recording
    of ``chunks`` windows."""
    seg = cfg["segmentation"]
    frame = SlidingWindow(0.0, seg["frame_step"], seg["frame_step"])
    windows = SlidingWindow(0.0, seg["step"], seg["duration"])
    trimmed = SlidingWindow(seg["warm_up"][0] * seg["duration"], seg["step"],
                            (1 - sum(seg["warm_up"])) * seg["duration"])
    _, n_act = plan(chunks, windows, frame)
    _, n_cnt = plan(chunks, trimmed, frame)
    return (SlidingWindow(0.0, frame.step, frame.duration), n_act,
            SlidingWindow(trimmed.start, frame.step, frame.duration), n_cnt)


def cluster_activations(scores: np.ndarray, hard: np.ndarray, k: int, cfg: Dict) -> np.ndarray:
    """(chunks, frames, S) scores, (chunks, S) labels (negative: none) ->
    (frames on the grid, k): each cluster's max over its local speakers in
    each window, summed over the windows."""
    seg = cfg["segmentation"]
    chunks = scores.shape[0]
    clustered = np.full(scores.shape[:2] + (k,), np.nan)
    for c in range(k):
        member = hard == c
        has = member.any(axis=1)
        best = np.where(member[:, None, :], scores, -np.inf).max(axis=2)
        clustered[has, :, c] = best[has]
    starts, n_out = plan(chunks, SlidingWindow(0.0, seg["step"], seg["duration"]),
                         SlidingWindow(0.0, seg["frame_step"], seg["frame_step"]))
    return overlap_add(clustered, starts, n_out, average=False)


def binarize_by_count(act: np.ndarray, act_grid: SlidingWindow, count: np.ndarray,
                      count_grid: SlidingWindow):
    """Keep the ``count`` most active clusters of each frame, over the
    frames both grids cover. Returns (binary (frames, K), its grid)."""
    k = act.shape[1]
    count = np.minimum(count, k)
    a0, a1 = act_grid.extent(act.shape[0])
    c0, c1 = count_grid.extent(len(count))
    lo, hi = max(a0, c0), min(a1, c1)
    i, j = act_grid.crop_range(lo, hi)
    act_c = act[max(i, 0) : min(j, act.shape[0])]
    out_grid = SlidingWindow(act_grid.start + i * act_grid.step, act_grid.step, act_grid.duration)
    i2, j2 = count_grid.crop_range(lo, hi)
    cnt_c = count[max(i2, 0) : min(j2, len(count))]
    order = np.argsort(-act_c, axis=-1, kind="stable")
    ranks = np.empty_like(order)
    np.put_along_axis(ranks, order, np.arange(k)[None, :], axis=-1)
    n = min(len(cnt_c), len(act_c))
    binary = np.zeros_like(act_c)
    binary[:n][ranks[:n] < cnt_c[:n, None]] = 1.0
    return binary, out_grid


def turns(binary: np.ndarray, grid: SlidingWindow, min_duration_off: float) -> List[Turn]:
    """Runs of each cluster's active frames (frame-middle timestamps, a run
    closed at the first inactive frame or the last timestamp), then
    same-cluster turns whose gap is under ``min_duration_off`` merged."""
    stamps = grid.start + np.arange(binary.shape[0]) * grid.step + 0.5 * grid.duration
    out: List[Turn] = []
    for k in range(binary.shape[1]):
        on = binary[:, k] > 0.5
        runs = []
        t = 0
        while t < len(on):
            if on[t]:
                e = t
                while e < len(on) and on[e]:
                    e += 1
                runs.append([stamps[t], stamps[e] if e < len(on) else stamps[-1]])
                t = e
            else:
                t += 1
        merged = []
        for r in runs:
            if merged and r[0] - merged[-1][1] < min_duration_off:
                merged[-1][1] = max(merged[-1][1], r[1])
            else:
                merged.append(r)
        out += [(s, e, k) for s, e in merged]
    return sorted(out, key=lambda t: (t[0], t[1], t[2]))


def decode(scores: np.ndarray, hard: np.ndarray, k: int, count_raw: np.ndarray, cfg: Dict,
           half_activations: bool) -> List[Turn]:
    """Turns of one recording from its window scores, labels and raw count.
    ``half_activations``: the activations are rounded to float16 before the
    decode (the device route hands them to the host so)."""
    act_grid, n_act, count_grid, n_cnt = grids(cfg, scores.shape[0])
    act = cluster_activations(scores.astype(np.float64), hard, k, cfg)[:n_act]
    if half_activations:
        act = act.astype(np.float32).astype(np.float16).astype(np.float64)
    count = np.rint(np.asarray(count_raw, np.float64)[:n_cnt]).astype(np.int64)
    binary, grid = binarize_by_count(act, act_grid, count, count_grid)
    return turns(binary, grid, cfg["segmentation"]["min_duration_off"])


def turn_difference_s(a: List[Turn], b: List[Turn], resolution: float = 1e-3) -> float:
    """Seconds of speech where the two turn lists disagree, after matching
    their labels one to one to the largest overlap: for each label pair the
    length of the symmetric difference, plus every turn of an unmatched
    label, on a grid of ``resolution`` seconds."""
    from scipy.optimize import linear_sum_assignment

    end = max([t[1] for t in a + b], default=0.0)
    n = int(np.ceil(end / resolution)) + 2

    def masks(ts):
        labels = sorted({t[2] for t in ts})
        m = np.zeros((len(labels), n), dtype=bool)
        for s, e, k in ts:
            m[labels.index(k), int(round(s / resolution)) : int(round(e / resolution))] = True
        return m

    ma, mb = masks(a), masks(b)
    if not len(ma) or not len(mb):
        return float(ma.sum() + mb.sum()) * resolution
    overlap = (ma[:, None, :] & mb[None, :, :]).sum(axis=2)
    ia, ib = linear_sum_assignment(-overlap)
    diff = sum(int((ma[i] ^ mb[j]).sum()) for i, j in zip(ia, ib))
    diff += sum(int(ma[i].sum()) for i in set(range(len(ma))) - set(ia))
    diff += sum(int(mb[j].sum()) for j in set(range(len(mb))) - set(ib))
    return diff * resolution
