"""Streaming (online) speaker diarization, ported from the JAX package's
pipelines/streaming.py: the host logic is the same numpy, and the device
work is the port's ``run_chunks`` on the pipeline's device (the CUDA card
unless the pipeline was built for the CPU).

The reference is strictly offline — the whole WAV is read up front and the
sliding-window loop runs to completion (reference
pipeline/src/speakerDiarizer.cpp:2937-3234; its only streaming primitive is
a WAV *writer*, frontend/wav.h:193). This module adds the online mode a
serving deployment needs: feed audio as it arrives, get an evolving
diarization, and a final flush that is **string-identical to the offline
pipeline's HOST-clustering decode** (``device_clustering=False``; tested).
Against the default offline path (stage 3 on the device) the flush is
partition-equivalent — same turn boundaries, cluster labels renamed — per
the documented device-clustering numbering deviation (docs/PARITY.md).

Design: audio accumulates in a bounded buffer; whenever ``emit_every``
new 5 s / 0.5 s chunks are fully covered by buffered samples, stages 1+2 run
on exactly those chunks (``SpeakerDiarizationPipeline.run_chunks`` — the
same stage-1 and stage-2 dispatch as offline, its kernels included, on a
chunk range padded to the pipeline's chunk lattice), and
their per-chunk outputs append to consolidated growable stores (amortized
O(1) per chunk — nothing is ever re-concatenated).

Emissions are INCREMENTAL — O(new chunks + active suffix), not O(stream):

  - The speaker-count overlap-add is maintained as running numerator /
    denominator grids, extended per batch. ``np.add.at`` applies additions
    sequentially in index order and batches arrive in chunk order, so the
    running grids are BITWISE identical to the one-shot aggregation
    (pipelines/reconstruct.py speaker_count) at every emission.
  - Between reclusters, NEW chunks are assigned to the stored centroids
    (pyannote's own assign path, clustering/base.py assign_embeddings) and
    their per-cluster max activations are folded into a running
    skip-average diarization grid — already-folded chunks are never
    touched (fold-once). A full AHC recluster (every
    ``recluster_every``-th emission, and always at flush) re-labels
    everything so label drift cannot accumulate; when its labels match the
    folded prefix (the steady state) the grid is kept as-is.
  - The timeline decode is FROZEN-PREFIX incremental: turns that ended
    before a qualifying silence in the FINAL region of the stream are
    frozen and never re-decoded. The seam sits
    inside a count==0 span of at least ``min_duration_off`` (plus margin),
    strictly behind any frame a future chunk can still touch, so: (a) the
    frozen frames' binary values can never change between reclusters
    (count==0 forces all-zero rows pointwise, and top-count binarization
    is pointwise), and (b) ``support(min_duration_off)`` can never merge a
    turn across the seam (the gap is >= the collar by construction). Each
    emission therefore decodes only the grids' ACTIVE SUFFIX — rint,
    argsort, hysteresis and support all run on the suffix — and returns
    frozen turns + suffix turns. The freeze is invalidated (full decode
    once, then re-freezes) only when a recluster changes folded labels or
    the cluster count changes — the binary at frozen frames depends on
    min(count, K).

Memory: O(processed chunks) for the tiny per-chunk outputs (293x3 scores +
3x192 embeddings — retained for flush's exact full recluster) plus at most
``window + emit_every*step`` buffered samples — an hour-long stream never
holds the waveform.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np

from ..core.annotation import Annotation
from ..core.sliding_window import SlidingWindow
from ..models import pyannet as pyannet_mod
from . import reconstruct as rec
from .diarization import SpeakerDiarizationPipeline


def _assign_to_centroids(embeddings: np.ndarray, centroids: np.ndarray):
    """pyannote's centroid assignment (soft = 2 - cosine distance, hard =
    argmax; clustering/base.py assign_embeddings / reference
    Clustering.py:97-164) against FIXED centroids."""
    from ..clustering.base import cosine_cdist

    c, s, d = embeddings.shape
    with np.errstate(invalid="ignore", divide="ignore"):
        e2k = cosine_cdist(embeddings.reshape(-1, d), centroids).reshape(c, s, -1)
    soft = 2.0 - e2k
    hard = np.argmax(np.nan_to_num(soft, nan=-np.inf), axis=2)
    return hard, soft


class _GrowArray:
    """Amortized-O(1) append-only store of (n, ...) rows (doubling
    capacity); ``view()`` is a zero-copy slice of the filled prefix."""

    def __init__(self, row_shape: Tuple[int, ...], dtype):
        self._data = np.zeros((0,) + row_shape, dtype)
        self.n = 0

    def append(self, rows: np.ndarray) -> None:
        need = self.n + rows.shape[0]
        if need > self._data.shape[0]:
            cap = max(need, 2 * self._data.shape[0], 64)
            grown = np.zeros((cap,) + self._data.shape[1:], self._data.dtype)
            grown[: self.n] = self._data[: self.n]
            self._data = grown
        self._data[self.n : need] = rows
        self.n = need

    def view(self) -> np.ndarray:
        return self._data[: self.n]


class _GrowGrid:
    """Append-only overlap-add grid, bitwise-equal to the one-shot
    ``aggregate_numpy``: np.add.at applies additions sequentially in the
    given index order, and batches arrive in global chunk order, so the
    partial sums associate exactly like a single pass. Contributions beyond
    the current one-shot length are RETAINED (capacity has headroom); the
    ``view()`` crop reproduces the one-shot's out-of-bounds drop, and a
    later, longer grid legitimately exposes them."""

    def __init__(self, num_classes: int, dtype=np.float32):
        self.length = 0  # current one-shot num_frames
        self._num = np.zeros((0, num_classes), dtype)

    def _ensure(self, n: int) -> None:
        if n > self._num.shape[0]:
            grow = max(n - self._num.shape[0], self._num.shape[0], 1024)
            self._num = np.vstack(
                [self._num, np.zeros((grow, self._num.shape[1]), self._num.dtype)]
            )

    def add(self, scores: np.ndarray, start_frames: np.ndarray, num_frames: int):
        """scores: (batch_chunks, F, K), NaN = no contribution."""
        nb, F, K = scores.shape
        self._ensure(num_frames + F)
        masks = ~np.isnan(scores)
        clean = np.nan_to_num(scores).astype(self._num.dtype)
        idx = (np.asarray(start_frames)[:, None] + np.arange(F)[None, :]).reshape(-1)
        np.add.at(self._num, idx, (clean * masks).reshape(-1, K))
        self.length = max(self.length, num_frames)

    def view(self) -> np.ndarray:
        return self._num[: self.length]


def _plan_rows(scores_frames: SlidingWindow, frame_grid: SlidingWindow, lo: int, hi: int):
    """Per-chunk start frames for chunks [lo, hi) plus the one-shot grid
    length for hi chunks — the exact formulas of ops/aggregate.py
    plan_aggregation, computed only for the new range."""
    frames = SlidingWindow(
        start=scores_frames.start,
        step=frame_grid.step,
        duration=frame_grid.duration,
    )
    frame_target = (
        scores_frames.start + scores_frames.duration + (hi - 1) * scores_frames.step
    )
    num_frames = frames.closest_frame(frame_target) + 1
    chunk_starts = scores_frames.start + np.arange(lo, hi) * scores_frames.step
    start_frames = np.array(
        [frames.closest_frame(t) for t in chunk_starts], dtype=np.int32
    )
    return start_frames, num_frames, frames


class StreamingDiarizer:
    """Incremental wrapper around a SpeakerDiarizationPipeline.

    Usage::

        stream = StreamingDiarizer(pipeline, emit_every=8)
        for block in audio_blocks:          # arbitrary block sizes, 16 kHz
            ann = stream.feed(block)        # None until enough new chunks
            if ann is not None: ...         # diarization of audio so far
        final = stream.flush()              # == offline pipeline(audio)
    """

    def __init__(
        self,
        pipeline: SpeakerDiarizationPipeline,
        emit_every: int = 8,
        num_speakers: Optional[int] = None,
        min_speakers: Optional[int] = None,
        max_speakers: Optional[int] = None,
        recluster_every: int = 4,
        recluster_schedule: str = "fixed",
        recluster_max_interval: int = 128,
    ):
        self.pipeline = pipeline
        self.emit_every = max(1, emit_every)
        # Full AHC runs on every `recluster_every`-th emission (and always at
        # flush, keeping flush == offline exact); in between, new embeddings
        # are assigned to the stored centroids and folded into the running
        # grids — per-emit cost is O(new chunks + active-suffix decode).
        #
        # A full recluster re-assigns EVERY embedding to the fresh
        # centroids, so its cost necessarily grows with the stream (the
        # labels of old chunks can legitimately change, and then the grid
        # rebuild + full decode run). For multi-hour
        # always-on streams, recluster_schedule="doubling" keeps per-emit
        # latency flat: full reclusters run at exponentially growing
        # intervals (1, 2, 4, ... emissions, capped at
        # recluster_max_interval), amortizing the O(stream) rebuild to
        # O(1) per emission while new audio still folds incrementally via
        # centroid assignment; the card's numbers are in PERF.md.
        self.recluster_every = max(1, recluster_every)
        if recluster_schedule not in ("fixed", "doubling"):
            raise ValueError(
                f"recluster_schedule must be 'fixed' or 'doubling', got "
                f"{recluster_schedule!r}"
            )
        self.recluster_schedule = recluster_schedule
        self.recluster_max_interval = max(1, recluster_max_interval)
        self._speaker_bounds = (num_speakers, min_speakers, max_speakers)
        seg = pipeline.config.segmentation
        self._window = seg.window_size
        self._step = seg.step_size
        # static frame grids (emission-independent)
        self._chunk_grid = SlidingWindow(0.0, seg.step, seg.duration)
        self._frame_grid = SlidingWindow(
            seg.frame_start, seg.frame_step, seg.frame_duration
        )
        wl, wr = seg.warm_up
        self._trimmed_grid = SlidingWindow(
            start=wl * seg.duration,
            step=seg.step,
            duration=(1 - wl - wr) * seg.duration,
        )
        self.reset()

    def reset(self) -> None:
        seg = self.pipeline.config.segmentation
        F, S = seg.num_frames, seg.num_speakers
        D = self.pipeline.ecapa_cfg.emb_dim
        self._buffer = np.zeros(0, dtype=np.float32)
        self._offset = 0  # absolute sample index of buffer[0]
        self._done_chunks = 0
        # consolidated per-chunk stores (append-only; retained for flush)
        self._segs = _GrowArray((F, S), np.float32)
        self._binarized = _GrowArray((F, S), np.float32)
        self._embeddings = _GrowArray((S, D), np.float64)
        self._inactive = _GrowArray((S,), bool)
        self._batch_bounds: list = []  # [(lo, hi)] chunk range per batch
        self._flushed = False
        self._emit_count = 0
        self._centroids: Optional[np.ndarray] = None
        # running speaker-count grids (numerator / overlap denominator)
        self._count_num = _GrowGrid(1)
        self._count_den = _GrowGrid(1)
        # running diarization grid (skip-average sums per cluster) + fold
        # state: number of batches folded, max cluster id seen
        self._dia: Optional[_GrowGrid] = None
        self._dia_folded_batches = 0
        self._k_used = 1
        # labels each folded chunk was folded under ((chunks, S) int array);
        # lets a recluster whose labels match the folded prefix skip the
        # grid rebuild entirely (the grid was built in the same addition
        # order a rebuild would use, so keeping it is bitwise-identical)
        self._folded_hard: Optional[np.ndarray] = None
        # frozen-prefix decode state (module docstring): turns frozen so
        # far, the seam indices into the count/dia grids, and the cluster
        # count the freeze is valid for
        self._frozen_turns: List[Tuple[float, float, int]] = []
        self._seam_cidx = 0  # count-grid frame index of the decode start
        self._seam_aidx = 0  # dia-grid frame index of the decode start
        self._frozen_k: Optional[int] = None
        # doubling-schedule state (recluster_schedule="doubling")
        self._next_full_at = 0
        self._full_gap = 1
        #: wall-clock seconds of each feed() that produced an emission
        self.feed_latencies: List[float] = []
        #: emission indices where a FULL recluster ran (for latency
        #: attribution in benches/tests)
        self.recluster_emissions: List[int] = []

    # ------------------------------------------------------------------

    @property
    def total_samples(self) -> int:
        return self._offset + self._buffer.shape[0]

    def _complete_chunks(self) -> int:
        """Chunks fully covered by the samples received so far."""
        if self.total_samples < self._window:
            return 0
        return (self.total_samples - self._window) // self._step + 1

    def _process_range(
        self, lo: int, hi: int, orphan_frames=None, orphan_samples=None
    ) -> None:
        start = lo * self._step
        end = (hi - 1) * self._step + self._window
        piece = self._buffer[start - self._offset : end - self._offset]
        if piece.shape[0] < end - start:  # flush tail: zero-pad
            piece = np.pad(piece, (0, end - start - piece.shape[0]))
        segs, binz, emb = self.pipeline.run_chunks(
            piece, hi - lo, orphan_frames, orphan_samples
        )
        self._segs.append(segs)
        self._binarized.append(binz)
        self._embeddings.append(emb)
        self._inactive.append(binz.sum(axis=1) == 0)
        self._batch_bounds.append((lo, hi))
        self._done_chunks = hi
        # running speaker count: trim + per-frame speaker sum for the NEW
        # chunks only (label-independent, never rebuilt)
        trimmed, _ = rec.trim(
            binz, self._chunk_grid, *self.pipeline.config.segmentation.warm_up
        )
        summed = trimmed.sum(axis=-1, keepdims=True).astype(np.float32)
        rows, nf, _ = _plan_rows(self._trimmed_grid, self._frame_grid, lo, hi)
        self._count_num.add(summed, rows, nf)
        self._count_den.add(np.ones_like(summed), rows, nf)
        # drop samples no future chunk needs
        keep_from = hi * self._step
        if keep_from > self._offset:
            self._buffer = self._buffer[keep_from - self._offset :]
            self._offset = keep_from

    # ------------------------------------------------------------------
    # emission machinery
    # ------------------------------------------------------------------

    def _clustered_batch(self, segs: np.ndarray, hard: np.ndarray, K: int):
        """Per-cluster max over member local speakers, NaN where the chunk
        has no member — the reconstruct formula
        (pipelines/reconstruct.py reconstruct / speakerDiarizer.cpp:
        2766-2787), f32 like to_diarization's aggregation input.

        Loops over the S (= 3) local speakers, not the K clusters: max is
        order-free, so the result is identical to the per-cluster
        formulation, and the full-stream recluster rebuild drops from
        O(K * chunks) full-array passes to O(S) fancy-indexed updates."""
        nb, F, S = segs.shape
        clustered = np.full((nb, F, K), -np.inf, np.float32)
        has = np.zeros((nb, K), bool)
        rows = np.arange(nb)
        for s in range(S):
            k = hard[:, s]
            valid = k >= 0
            if not valid.any():
                continue
            r, kk = rows[valid], k[valid]
            cur = clustered[r, :, kk]  # (n_valid, F)
            clustered[r, :, kk] = np.maximum(cur, segs[valid, :, s])
            has[r, kk] = True
        clustered[~has[:, None, :].repeat(F, axis=1)] = np.nan
        return clustered

    def _invalidate_freeze(self) -> None:
        self._frozen_turns = []
        self._seam_cidx = 0
        self._seam_aidx = 0
        self._frozen_k = None

    def _fold_batch(self, idx: int, hard: np.ndarray) -> None:
        """Fold batch ``idx``'s clustered activations into the running
        diarization grid under labels ``hard`` ((nb, S), -2 for inactive)."""
        lo, hi = self._batch_bounds[idx]
        K = self._dia._num.shape[1]
        clustered = self._clustered_batch(
            self._segs.view()[lo:hi], hard, K
        )
        rows, nf, _ = _plan_rows(self._chunk_grid, self._frame_grid, lo, hi)
        self._dia.add(clustered, rows, nf)

    def _recluster(self) -> None:
        """Full AHC over every embedding so far; store centroids; rebuild
        the diarization grid under the fresh labels (kept as-is when the
        labels of every already-folded chunk are unchanged)."""
        p = self.pipeline
        ns, mins, maxs = self._speaker_bounds
        embs = self._embeddings.view()
        hard, _soft = p.clusterer(
            embs,
            num_clusters=ns or p.config.num_speakers,
            min_clusters=mins or p.config.min_speakers,
            max_clusters=maxs or p.config.max_speakers,
        )
        hard = np.asarray(hard)
        hard[self._inactive.view()] = -2  # speakerDiarizer.cpp:3166-3191
        k_count = max(int(hard.max()) + 1, 1)
        # centroids for the incremental emissions that follow (one-pass
        # scatter-add; per-cluster boolean-mask means would re-read the
        # whole store K times)
        flat = embs.reshape(-1, embs.shape[-1])
        hf = hard.reshape(-1)
        valid = ~np.isnan(flat).any(axis=1)
        sel = valid & (hf >= 0)
        cents = np.zeros((k_count, flat.shape[-1]), np.float64)
        counts = np.bincount(hf[sel], minlength=k_count).astype(np.float64)
        np.add.at(cents, hf[sel], flat[sel])
        cents /= np.maximum(counts, 1.0)[:, None]
        self._centroids = cents
        if k_count != self._k_used or self._frozen_k != k_count:
            # the frozen binary depends on min(count, K): any K change
            # invalidates it (rare — a speaker appeared or disappeared)
            self._invalidate_freeze()
        self._k_used = k_count

        folded_chunks = (
            self._batch_bounds[self._dia_folded_batches - 1][1]
            if self._dia_folded_batches
            else 0
        )
        prefix_ok = (
            self._dia is not None
            and self._dia._num.shape[1] == k_count
            and self._folded_hard is not None
            and self._folded_hard.shape[0] == folded_chunks
            and np.array_equal(self._folded_hard, hard[:folded_chunks])
        )
        if prefix_ok:
            # the recluster did not change any folded chunk's labels (the
            # common steady-state case): keep the grid, fold only the new
            # batches under their fresh labels
            pos = folded_chunks
            for idx in range(self._dia_folded_batches, len(self._batch_bounds)):
                lo, hi = self._batch_bounds[idx]
                self._fold_batch(idx, hard[pos : pos + hi - lo])
                pos += hi - lo
        else:
            # labels of folded chunks changed: rebuild the grid in one
            # vectorized fold over the consolidated store, and drop the
            # frozen prefix (its activations just changed)
            self._invalidate_freeze()
            self._batch_bounds = [(0, self._done_chunks)]
            self._dia = _GrowGrid(k_count)
            self._fold_batch(0, hard)
        self._dia_folded_batches = len(self._batch_bounds)
        self._folded_hard = hard
        self._frozen_k = k_count

    def _fold_new_batches(self) -> None:
        """Assign each not-yet-folded batch to the stored centroids and fold
        it (fold-once; O(new chunks))."""
        for idx in range(self._dia_folded_batches, len(self._batch_bounds)):
            lo, hi = self._batch_bounds[idx]
            hard, _ = _assign_to_centroids(
                self._embeddings.view()[lo:hi], self._centroids
            )
            hard = np.asarray(hard)
            hard[self._inactive.view()[lo:hi]] = -2
            # labels are argmaxes over the stored centroid rows, so
            # hard.max() < _k_used (= the centroid count) always — K can
            # only change at a full recluster
            self._fold_batch(idx, hard)
            self._folded_hard = (
                hard
                if self._folded_hard is None
                else np.concatenate([self._folded_hard, hard], axis=0)
            )
        self._dia_folded_batches = len(self._batch_bounds)

    # ------------------------------------------------------------------
    # frozen-prefix decode
    # ------------------------------------------------------------------

    def _advance_seam(self, count_suffix: np.ndarray, suffix_turns) -> None:
        """Find the latest qualifying silence span in the FINAL region and
        freeze every turn that ended before it (module docstring).

        count_suffix: per-frame speaker count for count-grid indices
        [seam_cidx, seam_cidx + len) — silence (count == 0) is exactly
        where the binary is all-zero. suffix_turns: the turns just decoded
        from the active suffix."""
        seg = self.pipeline.config.segmentation
        fstep = self._frame_grid.step
        mdo = seg.min_duration_off
        # frames a future chunk can still touch start at done_chunks*step;
        # stay strictly behind, with one frame of slack
        t_final = self._done_chunks * seg.step
        c_start = self._trimmed_grid.start
        final_n = int((t_final - c_start) / fstep) - int(self._frame_grid.duration / fstep) - 2
        final_n = min(final_n - self._seam_cidx, len(count_suffix))
        if final_n <= 0:
            return
        # spans of count==0 of at least min_duration_off + 2 frames
        need = int(np.ceil(mdo / fstep)) + 2
        zero = count_suffix[:final_n] == 0
        if not zero.any():
            return
        # run-length scan (vectorized) for the LAST qualifying run
        z = zero.astype(np.int8)
        edges = np.flatnonzero(np.diff(z))
        starts = list(edges[z[edges + 1] == 1] + 1)
        ends = list(edges[z[edges + 1] == 0] + 1)
        if z[0]:
            starts = [0] + starts
        if z[-1]:
            ends = ends + [final_n]
        best = None
        for s_i, e_i in zip(starts, ends):
            if e_i - s_i >= need:
                best = (s_i, e_i)
        if best is None:
            return
        s_i, e_i = best
        # seam lands mid-silence
        new_cidx = self._seam_cidx + s_i + (e_i - s_i) // 2
        if new_cidx <= self._seam_cidx:
            return
        # freeze turns ending before the SEAM TIME (mid-silence): the
        # qualifying span is >= min_duration_off + 2 frames, so the seam
        # sits >= mdo/2 (~0.3 s) past the last pre-silence turn end and
        # before the first post-silence turn start for ANY act/count grid
        # phase — comparing against the silence-START time instead broke
        # for configs where turn-end timestamps (frame middles) land just
        # after the count frame boundary
        t_seam = c_start + new_cidx * fstep
        for t in suffix_turns:
            if t.end <= t_seam:
                self._frozen_turns.append((t.start, t.end, t.label))
        self._seam_cidx = new_cidx
        # the dia-grid seam index must PRESERVE the full decode's act<->count
        # row pairing: binarize_by_count pairs the two cropped grids
        # POSITIONALLY, and the grids are out of phase (count starts at the
        # warm-up offset), so the suffix must start (aidx - cidx) at exactly
        # the full crop's index offset — a time-rounded aidx can land one
        # frame off and shift every suffix timestamp by a frame
        self._seam_aidx = new_cidx + self._pair_offset()
        self._frozen_k = self._k_used

    def _pair_offset(self) -> int:
        """Index offset between the dia row and count row that the full
        decode's crop pairs together (see _advance_seam)."""
        from ..core.segment import Segment

        fstep, fdur = self._frame_grid.step, self._frame_grid.duration
        act = SlidingWindow(self._chunk_grid.start, fstep, fdur)
        cnt = SlidingWindow(self._trimmed_grid.start, fstep, fdur)
        focus_start = max(act.extent(1).start, cnt.extent(1).start)
        focus = Segment(focus_start, focus_start + 1.0)
        a0 = max(act.crop_range(focus)[0], 0)
        c0 = max(cnt.crop_range(focus)[0], 0)
        return a0 - c0

    def _decode(self, num_samples: int) -> Annotation:
        """Timeline decode from the running grids — identical formulas to
        reconstruct.speaker_count + to_diarization tails, evaluated on the
        ACTIVE SUFFIX only (frozen turns are prepended verbatim)."""
        p = self.pipeline
        seg_cfg = p.config.segmentation
        eps = float(np.finfo(np.float64).eps)
        ci = self._seam_cidx
        ai = self._seam_aidx
        num = self._count_num.view()[ci:, 0]
        den = self._count_den.view()[ci:, 0]
        avg = num / np.maximum(den, eps)
        count = np.rint(np.where(den == 0.0, 0.0, avg)).astype(np.int64)
        fstep, fdur = self._frame_grid.step, self._frame_grid.duration
        count_frames = SlidingWindow(
            self._trimmed_grid.start + ci * fstep,
            fstep,
            fdur,
            num_samples=num_samples,
        )
        activations = self._dia.view()[ai:, : self._k_used]
        dia_frames = SlidingWindow(
            self._chunk_grid.start + ai * fstep, fstep, fdur
        )
        binary, binary_frames = rec.binarize_by_count(
            activations, dia_frames, count, count_frames
        )
        suffix_ann = rec.to_annotation(
            binary,
            binary_frames,
            onset=p.config.clustering.binarize_onset,
            offset=p.config.clustering.binarize_offset,
            min_duration_on=seg_cfg.min_duration_on,
            min_duration_off=seg_cfg.min_duration_off,
        )
        suffix_turns = suffix_ann.turns()
        n_frozen_before = len(self._frozen_turns)
        self._advance_seam(count, suffix_turns)
        if not self._frozen_turns:
            return suffix_ann
        # _advance_seam may have moved a prefix of suffix_turns into
        # _frozen_turns on THIS call — emit frozen turns plus the remainder
        newly_frozen = len(self._frozen_turns) - n_frozen_before
        frozen_now = {
            (s, e, k) for s, e, k in self._frozen_turns[n_frozen_before:]
        } if newly_frozen else ()
        out = Annotation()
        for s, e, k in self._frozen_turns:
            out.add(s, e, k)
        for t in suffix_turns:
            if (t.start, t.end, t.label) not in frozen_now:
                out.add(t.start, t.end, t.label)
        return out

    def _due_full_recluster(self) -> bool:
        if self.recluster_schedule == "doubling":
            return self._emit_count >= self._next_full_at
        return self._emit_count % self.recluster_every == 0

    def _emit(self, num_samples: int, force_full: bool = False) -> Annotation:
        if self._done_chunks == 0:
            return Annotation()
        full = (
            force_full
            or self._centroids is None
            or self._due_full_recluster()
        )
        if full:
            self.recluster_emissions.append(self._emit_count)
            self._full_gap = min(2 * self._full_gap, self.recluster_max_interval)
            self._next_full_at = self._emit_count + self._full_gap
        self._emit_count += 1
        if full:
            self._recluster()
        else:
            self._fold_new_batches()
        return self._decode(num_samples)

    # ------------------------------------------------------------------

    def feed(self, samples: np.ndarray) -> Optional[Annotation]:
        """Append a block of 16 kHz mono samples; returns the diarization of
        the audio processed so far when >= emit_every new chunks completed,
        else None."""
        if self._flushed:
            raise RuntimeError("stream already flushed; call reset()")
        t0 = time.perf_counter()
        samples = np.asarray(samples, dtype=np.float32).reshape(-1)
        self._buffer = np.concatenate([self._buffer, samples])
        complete = self._complete_chunks()
        if complete - self._done_chunks < self.emit_every:
            return None
        self._process_range(self._done_chunks, complete)
        covered = (self._done_chunks - 1) * self._step + self._window
        annotation = self._emit(min(self.total_samples, covered))
        self.feed_latencies.append(time.perf_counter() - t0)
        return annotation

    def flush(self) -> Annotation:
        """Process the tail (including the short orphan chunk, zero-padded
        exactly like the offline pipeline) and return the final annotation."""
        if self._flushed:
            raise RuntimeError("stream already flushed; call reset()")
        self._flushed = True
        p = self.pipeline
        num_samples = self.total_samples
        if num_samples == 0:
            return Annotation()
        from ..ops import windows as win

        num_chunks = win.chunk_count(num_samples, self._window, self._step)
        if num_chunks > self._done_chunks:
            orphan_samples = num_samples - (num_chunks - 1) * self._step
            orphan_frames = None
            if orphan_samples < self._window:
                orphan_frames = max(
                    pyannet_mod.pyannet_num_frames(orphan_samples, p.pyannet_cfg), 0
                )
            self._process_range(
                self._done_chunks, num_chunks, orphan_frames, orphan_samples
            )
        # always a FULL recluster: flush == offline pipeline, exactly
        return self._emit(num_samples, force_full=True)
