"""Embedding-only pipeline: batch speaker-embedding extraction + scoring.

Stage 2 of the reference as a pipeline of its own (getEmbedding,
pipeline/src/speakerDiarizer.cpp:2436-2561; speechbrain encode_batch path in
embeddings/threeModel.py): masked or unmasked 5 s windows -> 192-d
embeddings, plus cosine-similarity scoring for verification workflows. The
port of the JAX package's pipelines/embedding.py: with masks a batch runs
the pack, log-mel and ECAPA/ASP kernels of the diarization pipeline's stage
2; without, log-mel and ECAPA/ASP over the whole windows (unit lengths).
The ECAPA trunk runs in float32, as the JAX module runs it.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, DiarizationConfig
from ..models import convert
from ..models import layers as L
from ..models.ecapa import EcapaConfig, EcapaTDNN
from ..ops import frontend as fe
from ..ops import masks as mk
from .diarization import PRECISIONS, precision_scope, prepare_device, resolve_device, to_host


class EmbeddingPipeline:
    """(batch, num_samples) waveforms [+ frame masks] -> (batch, emb_dim).

    ``params``: ``{"embedding": tree}`` in the JAX package's layout, or None
    for seeded random weights. ``device``: None runs on the CUDA card and
    raises without one; ``"cpu"`` runs on the CPU. ``precision``: "default"
    or "highest" (TF32 off). ``ecapa_layout``: "nch", "nhc" or "gemm", as
    the diarization pipeline takes it."""

    def __init__(
        self,
        config: DiarizationConfig = DEFAULT_CONFIG,
        params: Optional[Dict] = None,
        seed: int = 0,
        batch_size: Optional[int] = None,
        precision: str = "default",
        ecapa_cfg: Optional[EcapaConfig] = None,
        device=None,
        ecapa_layout: str = "nch",
    ):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
        self.device = resolve_device(device)
        self.config = config
        self.ecapa_cfg = ecapa_cfg or EcapaConfig(in_channels=config.frontend.n_mels)
        model = EcapaTDNN(
            self.ecapa_cfg, generator=torch.Generator().manual_seed(seed), layout=ecapa_layout
        )
        if params is not None:
            model.load_state_dict(convert.ecapa_state_from_tree(params["embedding"]))
        self.model = model.to(self.device).eval()
        self.batch_size = batch_size or config.embedding.batch_size
        self.precision = precision
        prepare_device(self.device, config.frontend)

    def _embed(self, waveforms: torch.Tensor, masks: Optional[torch.Tensor]):
        """One batch on the device -> (embeddings (B, D) float32, too_short
        (B,) bool or None)."""
        cfg = self.config
        if masks is None:
            lens = torch.ones((waveforms.shape[0],), dtype=torch.float32, device=self.device)
            feats = fe.compute_features(waveforms, lens, cfg.frontend)
            return self.model(feats, lens), None
        signals, wav_lens, too_short = mk.pack_and_lengths(
            waveforms, masks, cfg.embedding.mask_threshold, cfg.embedding.min_num_samples
        )
        feats = fe.compute_features(signals, wav_lens, cfg.frontend)
        return self.model(feats, wav_lens), too_short

    @torch.inference_mode()
    def __call__(
        self,
        waveforms: np.ndarray,
        masks: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Extract embeddings, float64; rows whose mask keeps fewer than
        min_num_samples samples come back NaN (reference semantics,
        segment/segment.py:298-303)."""
        wav = L.host_to_device(
            torch.from_numpy(np.ascontiguousarray(waveforms, dtype=np.float32)), self.device
        )
        mask_dev = None
        if masks is not None:
            mask_dev = L.host_to_device(
                torch.from_numpy(np.ascontiguousarray(masks, dtype=np.float32)), self.device
            )
        embs, shorts = [], []
        with precision_scope(self.precision):
            for i in range(0, wav.shape[0], self.batch_size):
                emb, too_short = self._embed(
                    wav[i : i + self.batch_size],
                    None if mask_dev is None else mask_dev[i : i + self.batch_size],
                )
                embs.append(emb)
                shorts.append(too_short)
        if masks is None:
            (emb_h,) = to_host(torch.cat(embs))
            return emb_h.astype(np.float64)
        emb_h, too_short_h = to_host(torch.cat(embs), torch.cat(shorts))
        emb_h = emb_h.astype(np.float64)
        emb_h[too_short_h] = np.nan
        return emb_h

    @staticmethod
    def cosine_similarity(a: np.ndarray, b: np.ndarray) -> np.ndarray:
        """Pairwise cosine similarity between two embedding sets."""
        an = a / np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), 1e-12)
        bn = b / np.maximum(np.linalg.norm(b, axis=-1, keepdims=True), 1e-12)
        return an @ bn.T
