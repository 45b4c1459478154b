"""Segmentation-only pipeline: VAD + per-speaker activity timeline.

The reference exposes this implicitly (stage 1 of speakerDiarization,
reference pipeline/src/speakerDiarizer.cpp:2953-3028; Python original
segment/segment.py:148-167); here it is a pipeline of its own: sliding
PyanNet inference, overlap-add aggregation onto the global frame grid, and
hysteresis decoding into speech turns per local-speaker class or merged VAD.
The port of the JAX package's pipelines/segmentation.py. Unlike the
diarization pipeline's stage 1, the orphan last chunk is scored zero-padded
and its frames past the audio are zeroed, as the JAX module does.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, DiarizationConfig
from ..core.annotation import Annotation
from ..core.sliding_window import SlidingWindow, SlidingWindowFeature
from ..models import convert
from ..models import layers as L
from ..models.pyannet import PyanNetConfig, pyannet_num_frames
from ..ops import windows as win
from ..ops.aggregate import plan_aggregation
from . import reconstruct as rec
from .diarization import PRECISIONS, load_waveform, precision_scope, resolve_device, to_host


class SegmentationPipeline:
    """wav -> (aggregated activations, VAD annotation).

    ``params``: ``{"segmentation": tree}`` in the JAX package's layout, or
    None for seeded random weights. ``device``: None runs on the CUDA card
    and raises without one; ``"cpu"`` runs on the CPU. ``precision``:
    "default" or "highest" (TF32 off)."""

    def __init__(
        self,
        config: DiarizationConfig = DEFAULT_CONFIG,
        params: Optional[Dict] = None,
        seed: int = 0,
        seg_batch: Optional[int] = None,
        precision: str = "default",
        pyannet_cfg: Optional[PyanNetConfig] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.config = config
        self.pyannet_cfg = pyannet_cfg or PyanNetConfig(
            sample_rate=config.segmentation.sample_rate,
            num_classes=config.segmentation.num_speakers,
        )
        model = convert.build_pyannet(
            None if params is None else params["segmentation"],
            self.pyannet_cfg,
            torch.Generator().manual_seed(seed),
        )
        self.model = model.to(self.device).eval()
        self.seg_batch = seg_batch or config.segmentation.batch_size
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
        self.precision = precision

    @torch.inference_mode()
    def slide(self, waveform: np.ndarray) -> SlidingWindowFeature:
        """Sliding-window inference -> (num_chunks, frames, speakers)."""
        seg_cfg = self.config.segmentation
        num_samples = waveform.shape[0]
        num_chunks = win.chunk_count(num_samples, seg_cfg.window_size, seg_cfg.step_size)
        needed = (num_chunks - 1) * seg_cfg.step_size + seg_cfg.window_size
        wav_padded = np.zeros(needed, dtype=np.float32)
        wav_padded[:num_samples] = waveform
        chunks = win.device_chunks(
            L.host_to_device(torch.from_numpy(wav_padded), self.device),
            num_chunks,
            seg_cfg.window_size,
            seg_cfg.step_size,
        )
        with precision_scope(self.precision):
            scores = torch.cat(
                [
                    self.model(chunks[i : i + self.seg_batch])
                    for i in range(0, num_chunks, self.seg_batch)
                ]
            )
        orphan = num_samples - (num_chunks - 1) * seg_cfg.step_size
        if orphan < seg_cfg.window_size:
            valid = max(pyannet_num_frames(orphan, self.pyannet_cfg), 0)
            scores[-1, valid:] = 0.0
        (scores_h,) = to_host(scores)
        frames = SlidingWindow(0.0, seg_cfg.step, seg_cfg.duration, num_samples=num_samples)
        return SlidingWindowFeature(scores_h, frames)

    def __call__(
        self,
        audio: Union[str, np.ndarray],
        sample_rate: Optional[int] = None,
        merge_speakers: bool = True,
    ) -> Annotation:
        """VAD / speaker-activity decode of the aggregated activations.

        merge_speakers=True collapses classes to one voice-activity class.
        """
        seg_cfg = self.config.segmentation
        waveform = load_waveform(audio, sample_rate, seg_cfg.sample_rate)
        swf = self.slide(waveform)
        frame_grid = SlidingWindow(seg_cfg.frame_start, seg_cfg.frame_step, seg_cfg.frame_duration)
        plan = plan_aggregation(len(swf), swf.sliding_window, frame_grid, waveform.shape[0])
        activations = rec.aggregate_host(swf.data.astype(np.float32), plan, skip_average=False)
        if merge_speakers:
            activations = activations.max(axis=1, keepdims=True)
        return rec.to_annotation(
            activations,
            plan.frames,
            onset=seg_cfg.onset,
            offset=seg_cfg.offset,
            min_duration_on=seg_cfg.min_duration_on,
            min_duration_off=seg_cfg.min_duration_off,
        )
