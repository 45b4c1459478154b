"""Fully-instrumented pipeline run: dump every reference checklist tensor.

The reference's main test strategy is differential verification of ~40 named
intermediates (reference pipeline/script/verifyEveryStepResult.py:5-17; C++
dump sites under #ifdef WRITE_DATA throughout speakerDiarizer.cpp, e.g.
:2443, :3031, :3149). ``run_with_dumps`` runs the production stages for the
neural forwards (``run_chunks``, ``stage2_internals``: on the card, the
pack, log-mel and ASP kernels), then recomputes every host-side
intermediate eagerly on the host, dumping each under the reference's name, and
holds the eager binarization and left-pack against the production ones as
it goes. The port of the JAX package's utils/instrumented.py; the
sample-level upsampling and left-pack it transcribes in numpy are kept
here (production packs whole frame runs).

Checklist coverage (verifyEveryStepResult.py:5-17):
  stage 1: segmentations, binarize_score, on, same_as, samples,
           well_defined_idx, initial_state, binary_ndarray,
           binarized_segmentations, clean_segmentations, batch_masks,
           trimmed, sum_trimmed, count_data, count
  stage 2: masks, imasks, signals, wav_lens, final_wav_lens, embeddings
  stage 3: filtered_embeddings, norm_embeddings, dist, clusterRes, clusters,
           soft_clusters, hard_clusters (clustering/base.py dump hooks);
           clustered_segmentations, scores_in_aggregate, masks_in_aggregate,
           aggregated_output, aggregated_mask, overlapping_chunk_count,
           to_diarization_activations, cropped_activations, cropped_count,
           sorted_speakers, discrete_diarization (pipelines/reconstruct.py
           dump hooks)
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Optional, Union

import numpy as np
import torch

from ..core.annotation import Annotation
from ..core.sliding_window import SlidingWindow
from ..models.pyannet import pyannet_num_frames
from ..ops import masks as mk
from ..ops import windows as win
from ..ops.aggregate import aggregate_numpy, plan_aggregation
from ..pipelines import reconstruct as rec


def binarize_instrumented(scores_rows: np.ndarray, onset: float, offset: float, dump):
    """pyannote binarize_ndarray transcription with every intermediate dumped
    (reference segment/segment.py:419-482; C++ helpers wellDefinedIndex /
    cumulativeSum / numpy_where at speakerDiarizer.cpp:623-709)."""
    scores = np.nan_to_num(np.asarray(scores_rows, dtype=np.float64))
    batch_size, num_frames = scores.shape
    dump.dump("binarize_score", scores)

    initial_state = scores[:, 0] >= 0.5 * (onset + offset)
    initial_state = np.tile(initial_state, (num_frames, 1)).T
    dump.dump("initial_state", initial_state)

    on = scores > onset
    off_or_on = (scores < offset) | on
    dump.dump("on", on)

    well_defined_idx = np.array(
        list(
            itertools.zip_longest(
                *[np.nonzero(oon)[0] for oon in off_or_on], fillvalue=-1
            )
        )
    ).T
    dump.dump("well_defined_idx", well_defined_idx)

    same_as = np.cumsum(off_or_on, axis=1)
    dump.dump("same_as", same_as)

    samples = np.tile(np.arange(batch_size), (num_frames, 1)).T
    dump.dump("samples", samples)

    if not well_defined_idx.size:
        binary = np.zeros_like(scores, dtype=bool) | initial_state
    else:
        binary = np.where(
            same_as, on[samples, well_defined_idx[samples, same_as - 1]], initial_state
        )
    dump.dump("binary_ndarray", binary)
    return binary


def interpolate_nearest(masks: np.ndarray, num_samples: int) -> np.ndarray:
    """(batch, frames) -> (batch, num_samples): out[i] = in[floor(i * F / n)],
    torch F.interpolate(mode="nearest") (segment/segment.py:283-287)."""
    src = (np.arange(num_samples) * masks.shape[-1]) // num_samples
    return masks[..., src]


def left_pack(waveforms: np.ndarray, keep: np.ndarray) -> np.ndarray:
    """Each row's kept samples moved to the front in order, zeros after
    (pad_sequence of the masked rows padded to the window,
    segment/segment.py:289-292)."""
    out = np.zeros_like(waveforms)
    for row, (w, k) in enumerate(zip(waveforms, keep)):
        kept = w[k]
        out[row, : kept.shape[0]] = kept
    return out


def run_with_dumps(
    pipeline,
    audio: Union[str, np.ndarray],
    dump,
    sample_rate: Optional[int] = None,
    num_speakers: Optional[int] = None,
    min_speakers: Optional[int] = None,
    max_speakers: Optional[int] = None,
) -> Annotation:
    """Diarize ``audio`` while dumping the full reference tensor checklist
    into ``dump`` (a utils.debug_dump.DumpSession). Returns the final
    annotation (the neural forwards run through the production stages;
    stage 3 through the host twin ``finalize``)."""
    from ..pipelines.diarization import load_waveform

    cfg = pipeline.config
    seg_cfg = cfg.segmentation
    waveform = load_waveform(audio, sample_rate, seg_cfg.sample_rate)
    num_samples = waveform.shape[0]

    num_chunks = win.chunk_count(num_samples, seg_cfg.window_size, seg_cfg.step_size)
    orphan_samples = num_samples - (num_chunks - 1) * seg_cfg.step_size
    orphan_frames = None
    if orphan_samples < seg_cfg.window_size:
        orphan_frames = max(pyannet_num_frames(orphan_samples, pipeline.pyannet_cfg), 0)

    # ---------- production stages 1+2 ----------
    segs, binarized, embeddings = pipeline.run_chunks(
        waveform, num_chunks, orphan_frames, orphan_samples
    )
    dump.dump("segmentations", segs)
    dump.dump("embeddings", embeddings)

    # ---------- stage-1 internals, eager ----------
    c, F, S = segs.shape
    rows = np.transpose(segs, (0, 2, 1)).reshape(c * S, F)
    binary_rows = binarize_instrumented(rows, seg_cfg.onset, seg_cfg.offset, dump)
    binarized_eager = np.transpose(binary_rows.reshape(c, S, F), (0, 2, 1)).astype(np.float32)
    np.testing.assert_array_equal(
        binarized_eager,
        binarized,
        err_msg="eager binarize diverged from the production binarization",
    )
    dump.dump("binarized_segmentations", binarized)

    cleaned = mk.clean_segmentations(torch.from_numpy(binarized))
    dump.dump("clean_segmentations", cleaned.numpy())
    min_num_frames = float(math.ceil(F * cfg.embedding.min_num_samples / seg_cfg.window_size))
    chosen = mk.choose_masks(torch.from_numpy(binarized), cleaned, min_num_frames).numpy()
    dump.dump("batch_masks", chosen.reshape(c * S, F))

    chunk_frames = SlidingWindow(0.0, seg_cfg.step, seg_cfg.duration, num_samples=num_samples)
    frame_grid = SlidingWindow(seg_cfg.frame_start, seg_cfg.frame_step, seg_cfg.frame_duration)
    trimmed, trimmed_frames = rec.trim(binarized, chunk_frames, *seg_cfg.warm_up)
    dump.dump("trimmed", trimmed)
    summed = trimmed.sum(axis=-1, keepdims=True)
    dump.dump("sum_trimmed", summed[:, :, 0])
    plan = plan_aggregation(c, trimmed_frames, frame_grid, num_samples=num_samples)
    count_data = aggregate_numpy(
        summed.astype(np.float64),
        plan.start_frames,
        plan.num_frames,
        missing=0.0,
        skip_average=False,
    )[:, 0]
    dump.dump("count_data", count_data)
    count = np.rint(count_data).astype(np.int64)
    dump.dump("count", count)
    count_frames = dataclasses.replace(plan.frames, num_samples=num_samples)

    # ---------- stage-2 internals, eager ----------
    window = seg_cfg.window_size
    padded_len = (c - 1) * seg_cfg.step_size + window
    wav_padded = np.zeros(padded_len, dtype=np.float32)
    wav_padded[:num_samples] = waveform
    starts = np.arange(c) * seg_cfg.step_size
    chunks = np.stack([wav_padded[s : s + window] for s in starts])
    mask_rows = chosen.reshape(c * S, F)
    dump.dump("masks", mask_rows)
    imasks = interpolate_nearest(mask_rows, window) > cfg.embedding.mask_threshold
    dump.dump("imasks", imasks)
    signals = left_pack(np.repeat(chunks, S, axis=0), imasks)
    lens = imasks.sum(axis=-1)
    too_short = lens < cfg.embedding.min_num_samples
    final_wav_lens = np.where(too_short, 1.0, lens / window)

    # ---------- production stage-2 provenance ----------
    # the signals and wav_lens the production stage 2 computed (the pack
    # kernel on the card), held against the eager transcription, then
    # dumped: the reference dumps what production computed
    # (speakerDiarizer.cpp:2443; verifyEveryStepResult.py:161-178)
    prod_signals, prod_wav_lens = pipeline.stage2_internals(
        waveform, num_chunks, orphan_frames, orphan_samples
    )
    np.testing.assert_array_equal(
        prod_signals,
        signals.astype(prod_signals.dtype),
        err_msg="eager left-pack diverged from the production stage-2 pack",
    )
    np.testing.assert_allclose(
        prod_wav_lens,
        final_wav_lens.astype(prod_wav_lens.dtype),
        rtol=1e-6,
        atol=0,
        err_msg="eager wav_lens diverged from the production stage-2 lengths",
    )
    dump.dump("signals", prod_signals)
    dump.dump("wav_lens", lens)
    dump.dump("final_wav_lens", prod_wav_lens)

    # ---------- stage 3 (dump hooks inside finalize) ----------
    return pipeline.finalize(
        segs,
        binarized,
        embeddings,
        count,
        count_frames,
        chunk_frames,
        num_speakers=num_speakers,
        min_speakers=min_speakers,
        max_speakers=max_speakers,
        dump=dump,
    )
