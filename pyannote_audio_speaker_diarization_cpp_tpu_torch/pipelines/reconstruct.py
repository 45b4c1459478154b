"""Diarization reconstruction: clustered activations -> discrete timeline ->
final annotation.

Re-design of the reference's reconstruction layer
(pipeline/src/speakerDiarizer.cpp): speaker_count :1665, trim :1742,
reconstruct :2789, max_segmentation_cluster :2766, to_diarization :2638,
crop_segment :2567, to_annotation :2852. Aggregations run as the same
overlap-add used in stage 1 (ops/aggregate.py, here on host tensors); the
final decode is tiny host numpy.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from ..core.annotation import Annotation
from ..core.segment import Segment
from ..core.sliding_window import SlidingWindow
from ..ops.aggregate import aggregate, plan_aggregation


def trim(
    binarized: np.ndarray,
    chunk_frames: SlidingWindow,
    left: float = 0.1,
    right: float = 0.1,
) -> Tuple[np.ndarray, SlidingWindow]:
    """Drop the warm-up fraction from both edges of every chunk
    (speakerDiarizer.cpp:1742-1782)."""
    num_frames = binarized.shape[1]
    n_left = math.floor(num_frames * left)
    n_right = math.floor(num_frames * right)
    trimmed = binarized[:, n_left : num_frames - n_right, :]
    frames = SlidingWindow(
        start=chunk_frames.start + left * chunk_frames.duration,
        step=chunk_frames.step,
        duration=(1 - left - right) * chunk_frames.duration,
        num_samples=num_frames - n_left - n_right,
    )
    return trimmed, frames


def speaker_count(
    binarized: np.ndarray,
    chunk_frames: SlidingWindow,
    frame_grid: SlidingWindow,
    num_samples: int,
    warm_up: Tuple[float, float] = (0.1, 0.1),
) -> Tuple[np.ndarray, SlidingWindow]:
    """Per-frame instantaneous speaker count (speakerDiarizer.cpp:1665-1738).

    trim -> sum over speakers -> overlap-add average -> banker's rint.
    """
    trimmed, trimmed_frames = trim(binarized, chunk_frames, *warm_up)
    summed = trimmed.sum(axis=-1, keepdims=True)
    plan = plan_aggregation(
        summed.shape[0], trimmed_frames, frame_grid, num_samples=num_samples
    )
    count = aggregate_host(summed, plan, skip_average=False)
    count = np.rint(count[:, 0]).astype(np.int64)
    return count, plan.frames


def reconstruct(
    segmentations: np.ndarray,
    chunk_frames: SlidingWindow,
    hard_clusters: np.ndarray,
    count: np.ndarray,
    count_frames: SlidingWindow,
    dump=None,
) -> Tuple[np.ndarray, SlidingWindow]:
    """Stitch local speaker activations into per-cluster activations and
    binarize by per-frame speaker count (speakerDiarizer.cpp:2789-2848).
    ``dump``: an optional utils.debug_dump.DumpSession that records the
    reference's intermediates of this step and the next ones.

    Returns (discrete_diarization (frames, num_clusters), frame grid).
    """
    num_chunks, num_frames, local_speakers = segmentations.shape
    num_clusters = int(np.max(hard_clusters)) + 1

    # clustered[i, f, k] = max over local speakers assigned to cluster k,
    # NaN where a cluster has no speaker in the chunk (:2816-2838).
    # K-iteration masked max keeps host memory at O(chunks*frames*speakers)
    # instead of a dense 4-D (chunks, frames, speakers, K) temporary.
    clustered = np.full((num_chunks, num_frames, num_clusters), np.nan)
    for k in range(num_clusters):
        member_k = hard_clusters == k  # (chunks, speakers)
        has_k = member_k.any(axis=1)
        masked = np.where(member_k[:, None, :], segmentations, -np.inf)
        clustered[has_k, :, k] = masked.max(axis=2)[has_k]
    if dump is not None:
        dump.dump("clustered_segmentations", clustered)
    return to_diarization(clustered, chunk_frames, count, count_frames, dump=dump)


def crop_segment(
    data: np.ndarray, src: SlidingWindow, focus: Segment
) -> Tuple[np.ndarray, SlidingWindow]:
    """Crop frame rows intersecting ``focus`` (mode 'loose'),
    speakerDiarizer.cpp:2567-2635."""
    n_samples = data.shape[0]
    i, j = src.crop_range(focus)
    start = src[i].start
    frames = SlidingWindow(start, src.step, src.duration, n_samples)
    lo, hi = max(i, 0), min(j, n_samples)
    return data[lo:hi], frames


def aggregate_host(scores: np.ndarray, plan, skip_average: bool) -> np.ndarray:
    """ops.aggregate on host arrays (missing frames -> 0)."""
    out = aggregate(
        torch.from_numpy(np.ascontiguousarray(scores)),
        torch.from_numpy(plan.start_frames),
        plan.num_frames,
        missing=0.0,
        skip_average=skip_average,
    )
    return out.numpy()


def to_diarization(
    clustered: np.ndarray,
    chunk_frames: SlidingWindow,
    count: np.ndarray,
    count_frames: SlidingWindow,
    dump=None,
) -> Tuple[np.ndarray, SlidingWindow]:
    """(chunks, frames, K) NaN-masked activations + per-frame count ->
    (frames, K) binary matrix (speakerDiarizer.cpp:2638-2764)."""
    plan = plan_aggregation(clustered.shape[0], chunk_frames, count_frames)
    scores32 = clustered.astype(np.float32)
    activations = aggregate_host(scores32, plan, skip_average=True)
    if dump is not None:
        # the aggregate() internals the reference dumps from
        # PipelineHelper::aggregate (speakerDiarizer.cpp:1161-1313)
        masks_agg = (~np.isnan(scores32)).astype(np.float32)
        idx = plan.start_frames[:, None] + np.arange(scores32.shape[1])[None, :]
        overlap = np.zeros((plan.num_frames, scores32.shape[2]), np.float32)
        np.add.at(overlap, idx.reshape(-1), masks_agg.reshape(-1, scores32.shape[2]))
        dump.dump("scores_in_aggregate", np.nan_to_num(scores32))
        dump.dump("masks_in_aggregate", masks_agg)
        dump.dump("aggregated_output", activations)
        dump.dump("aggregated_mask", (overlap > 0).astype(np.float32))
        dump.dump("overlapping_chunk_count", overlap)
        dump.dump("to_diarization_activations", activations)
    return binarize_by_count(activations, plan.frames, count, count_frames, dump=dump)


def binarize_by_count(
    activations: np.ndarray,
    activations_frames: SlidingWindow,
    count: np.ndarray,
    count_frames: SlidingWindow,
    dump=None,
) -> Tuple[np.ndarray, SlidingWindow]:
    """Aggregated per-cluster activations + per-frame count -> binary
    (frames, K) matrix: crop to the activations∩count extent, keep the
    top-count clusters per frame (speakerDiarizer.cpp:2700-2764). Split out
    of to_diarization so the pipeline's on-device post-clustering
    aggregation can reuse the identical decode."""
    num_speakers = activations.shape[1]
    count = np.minimum(count, num_speakers)

    focus = activations_frames.extent(activations.shape[0]) & count_frames.extent(
        len(count)
    )
    cropped_activations, cropped_frames = crop_segment(
        activations, activations_frames, focus
    )
    cropped_count, _ = crop_segment(count[:, None], count_frames, focus)

    # top-count speakers per frame (stable ordering like the C++ argsort)
    order = np.argsort(-cropped_activations, axis=-1, kind="stable")
    ranks = np.empty_like(order)
    np.put_along_axis(ranks, order, np.arange(num_speakers)[None, :], axis=-1)
    n = min(len(cropped_count), len(cropped_activations))
    binary = np.zeros_like(cropped_activations)
    binary[:n][ranks[:n] < cropped_count[:n]] = 1.0
    if dump is not None:
        dump.dump("cropped_activations", cropped_activations)
        dump.dump("cropped_count", cropped_count)
        dump.dump("sorted_speakers", order)
    return binary, cropped_frames


def to_annotation(
    scores: np.ndarray,
    frames: SlidingWindow,
    onset: float = 0.5,
    offset: float = 0.5,
    min_duration_on: float = 0.0,
    min_duration_off: float = 0.0,
) -> Annotation:
    """(frames, K) discrete diarization -> speech-turn annotation
    (speakerDiarizer.cpp:2852-2935): per-class hysteresis over frame-middle
    timestamps, gap filling, short-turn removal."""
    num_frames, num_classes = scores.shape
    starts = frames.start + np.arange(num_frames) * frames.step
    timestamps = starts + 0.5 * frames.duration

    active = Annotation()
    for k in range(num_classes):
        line = scores[:, k]
        if onset == offset and not (line == onset).any():
            # the production decode: binary scores at a single threshold
            # (values exactly ON the threshold would keep the loop's state,
            # so they exclude the fast path). The hysteresis state machine
            # reduces to runs of line > onset — vectorized edge detection
            # instead of a Python per-frame loop (an hour of audio is
            # ~213k frames x K).
            on = line > onset
            edges = np.flatnonzero(np.diff(on.astype(np.int8)))
            run_starts = edges[on[edges + 1]] + 1
            run_ends = edges[~on[edges + 1]] + 1  # exclusive (first off frame)
            if on[0]:
                run_starts = np.concatenate([[0], run_starts])
            for s_i, e_i in zip(run_starts, run_ends):
                active.add(timestamps[s_i], timestamps[e_i], k)
            if on[-1]:
                # still active at the end: close at the last timestamp
                active.add(timestamps[run_starts[len(run_ends)]], timestamps[-1], k)
            continue
        start = timestamps[0]
        is_active = line[0] > onset
        for t in range(1, num_frames):
            if is_active:
                if line[t] < offset:
                    active.add(start, timestamps[t], k)
                    start = timestamps[t]
                    is_active = False
            else:
                if line[t] > onset:
                    start = timestamps[t]
                    is_active = True
        if is_active:
            active.add(start, timestamps[-1], k)

    if min_duration_off > 0.0:
        active = active.support(min_duration_off)
    if min_duration_on > 0.0:
        active = active.remove_short(min_duration_on)
    return active
