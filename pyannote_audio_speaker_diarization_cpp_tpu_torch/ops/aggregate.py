"""Overlap-add aggregation of chunked scores onto the global frame grid.

Re-design of pyannote ``Inference.aggregate`` (reference C++ port at
pipeline/src/speakerDiarizer.cpp:1161-1313). The reference accumulates with a
triple scalar loop; frame offsets are data-independent, so here it is one
``index_add_`` over a precomputed index grid.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.sliding_window import SlidingWindow


@dataclasses.dataclass(frozen=True)
class AggregationPlan:
    """Host-side static plan: where each chunk lands on the output grid."""

    start_frames: np.ndarray  # (num_chunks,) int32
    num_frames: int
    frames: SlidingWindow  # output frame grid


def plan_aggregation(
    num_chunks: int,
    scores_frames: SlidingWindow,
    frame_grid: SlidingWindow,
    num_samples: int = 0,
) -> AggregationPlan:
    """Compute the output grid and per-chunk start frames.

    Mirrors speakerDiarizer.cpp:1230-1253: the output grid starts where the
    chunk grid starts and uses the model frame step/duration; the number of
    output frames reaches the end of the last chunk.
    """
    frames = SlidingWindow(
        start=scores_frames.start,
        step=frame_grid.step,
        duration=frame_grid.duration,
        num_samples=num_samples,
    )
    frame_target = (
        scores_frames.start
        + scores_frames.duration
        + (num_chunks - 1) * scores_frames.step
    )
    num_frames = frames.closest_frame(frame_target) + 1
    chunk_starts = scores_frames.start + np.arange(num_chunks) * scores_frames.step
    start_frames = np.array(
        [frames.closest_frame(t) for t in chunk_starts], dtype=np.int32
    )
    return AggregationPlan(start_frames=start_frames, num_frames=num_frames, frames=frames)


def aggregate(
    scores: torch.Tensor,
    start_frames: torch.Tensor,
    num_frames: int,
    missing: float = float("nan"),
    skip_average: bool = False,
    epsilon: float = float(np.finfo(np.float64).eps),
) -> torch.Tensor:
    """(num_chunks, chunk_frames, K) -> (num_frames, K) overlap-add.

    NaN scores contribute nothing (mask=0); output frames that received no
    valid contribution are set to ``missing``. With ``skip_average`` the raw
    sum is returned (used by to_diarization, speakerDiarizer.cpp:2647-2651).
    Contributions that land outside [0, num_frames) are dropped.

    On CUDA ``index_add_`` accumulates with atomics, so the order of a
    frame's (at most ceil(duration/step)) addends changes from run to run:
    sums agree with the sequential order to float32 rounding (~1e-7
    relative); 0/1 and small-integer scores sum exactly.
    """
    num_chunks, chunk_frames, num_classes = scores.shape
    masks = (~torch.isnan(scores)).to(scores.dtype)
    clean = torch.nan_to_num(scores) * masks

    idx = start_frames.to(scores.device, torch.long)[:, None] + torch.arange(
        chunk_frames, device=scores.device
    )[None, :]
    idx = idx.reshape(-1)
    inside = (idx >= 0) & (idx < num_frames)
    idx = torch.where(inside, idx, 0)
    keep = inside.to(scores.dtype)[:, None]
    clean = clean.reshape(-1, num_classes) * keep
    masks = masks.reshape(-1, num_classes) * keep

    agg = scores.new_zeros((num_frames, num_classes)).index_add_(0, idx, clean)
    count = scores.new_zeros((num_frames, num_classes)).index_add_(0, idx, masks)
    seen = scores.new_zeros((num_frames, num_classes)).scatter_reduce_(
        0, idx[:, None].expand(-1, num_classes), masks, reduce="amax"
    )
    if not skip_average:
        agg = agg / torch.clamp(count, min=epsilon)
    return torch.where(seen == 0.0, torch.full_like(agg, missing), agg)


def aggregate_numpy(
    scores: np.ndarray,
    start_frames: np.ndarray,
    num_frames: int,
    missing: float = np.nan,
    skip_average: bool = False,
    epsilon: float = float(np.finfo(np.float64).eps),
) -> np.ndarray:
    """Numpy mirror of ``aggregate`` for host arrays, in the scores' own
    dtype and sequential order (the JAX package's ``aggregate_numpy``; the
    differential dumps recompute the speaker count with it)."""
    scores = np.asarray(scores)
    num_chunks, chunk_frames, num_classes = scores.shape
    masks = (~np.isnan(scores)).astype(scores.dtype)
    clean = np.nan_to_num(scores)
    idx = (np.asarray(start_frames)[:, None] + np.arange(chunk_frames)[None, :]).reshape(-1)
    # contributions outside [0, num_frames) are dropped (np.add.at would
    # raise past the end and wrap negatives)
    oob = (idx < 0) | (idx >= num_frames)
    if oob.any():
        masks = masks.reshape(-1, num_classes).copy()
        masks[oob] = 0
        masks = masks.reshape(num_chunks, chunk_frames, num_classes)
        idx = np.where(oob, 0, idx)

    agg = np.zeros((num_frames, num_classes), scores.dtype)
    count = np.zeros((num_frames, num_classes), scores.dtype)
    seen = np.zeros((num_frames, num_classes), scores.dtype)
    np.add.at(agg, idx, (clean * masks).reshape(-1, num_classes))
    np.add.at(count, idx, masks.reshape(-1, num_classes))
    np.maximum.at(seen, idx, masks.reshape(-1, num_classes))

    if not skip_average:
        agg = agg / np.maximum(count, epsilon)
    return np.where(seen == 0.0, scores.dtype.type(missing), agg)
