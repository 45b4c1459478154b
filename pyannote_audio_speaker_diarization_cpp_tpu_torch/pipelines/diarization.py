"""The three-stage speaker-diarization pipeline, in PyTorch on a CUDA card.

Re-design of the reference orchestrator ``speakerDiarization`` (reference
pipeline/src/speakerDiarizer.cpp:2937-3234; Python original
segment/segment.py:148-245), ported from the JAX package's
pipelines/diarization.py:

  - stage 1 runs PyanNet over every 5 s window of the padded chunk lattice
    (the orphan last chunk scored at its true length), then binarizes,
    chooses the embedding masks and overlap-adds the speaker count on the
    device;
  - stage 2 packs each (chunk, local speaker) row's speech samples
    (ops/pack_cuda.py), computes log-mel features (ops/frontend_cuda.py) and
    ECAPA-TDNN embeddings (models/ecapa.py, attentive pooling tail in
    ops/asp_cuda.py), in batches of ``emb_batch`` rows;
  - stage 3 clusters the embeddings on the host (clustering/base.py), then
    the per-cluster max and overlap-add run on the device and the host
    decodes the timeline (pipelines/reconstruct.py).

The device work of a request is launched asynchronously on the current
stream; the host waits once for the clustering inputs and once for the
final activations.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Dict, Optional, Union

import numpy as np
import torch

from ..clustering.base import AgglomerativeClustering
from ..config import DEFAULT_CONFIG, DiarizationConfig
from ..core.annotation import Annotation
from ..core.sliding_window import SlidingWindow
from ..io import resample as rs
from ..io import wav as wavio
from ..models import convert
from ..models.ecapa import EcapaConfig, EcapaTDNN
from ..models.pyannet import PyanNet, PyanNetConfig, pyannet_num_frames, pyannet_valid_chain
from ..ops import binarize as bz
from ..ops import frontend as fe
from ..ops import masks as mk
from ..ops import windows as win
from ..ops.aggregate import aggregate, plan_aggregation
from . import reconstruct as rec

PRECISIONS = ("default", "highest")


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; without one, only an explicit CPU
    request runs."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available: pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device


@contextlib.contextmanager
def precision_scope(precision: str):
    """``"highest"``: float32 matmuls and cuDNN convolutions/RNNs in full
    float32 (TF32 off) for the duration, flags restored afterwards.
    ``"default"``: PyTorch's own settings (cuDNN uses TF32 for float32)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    if precision == "default":
        yield
        return
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def post_cluster(
    segs: torch.Tensor,
    membership: torch.Tensor,
    start_frames: torch.Tensor,
    num_frames: int,
) -> torch.Tensor:
    """Per-cluster max over member local speakers (the reference's
    max_segmentation_cluster, speakerDiarizer.cpp:2766-2787) + skip-average
    overlap-add (to_diarization's aggregate, :2647-2651), on the resident
    stage-1 scores: only the (frames, K) activations travel to the host.

    segs: (num_padded, F, S) f32; membership: (num_padded, S, K) bool
    one-hot of the host hard clusters (all False for padding chunks and
    inactive speakers).
    """
    masked = torch.where(
        membership[:, None, :, :], segs[..., None], torch.tensor(float("-inf"), device=segs.device)
    )
    clustered = masked.amax(dim=2)  # (n, F, K)
    has = membership.any(dim=1)[:, None, :]
    clustered = torch.where(has, clustered, torch.tensor(float("nan"), device=segs.device))
    return aggregate(clustered, start_frames, num_frames, missing=0.0, skip_average=True)


def finalize_embeddings(
    emb_h: np.ndarray, too_short_h: np.ndarray, num_chunks: int, num_speakers: int
) -> np.ndarray:
    """Fetched embedding rows -> (num_chunks, S, D) float64 with NaN rows
    for too-short masks."""
    rows = num_chunks * num_speakers
    embeddings = np.asarray(emb_h[:rows], dtype=np.float64)
    embeddings[np.asarray(too_short_h[:rows])] = np.nan
    return embeddings.reshape(num_chunks, num_speakers, -1)


def load_waveform(
    audio: Union[str, np.ndarray],
    sample_rate: Optional[int],
    target_rate: int,
) -> np.ndarray:
    """Path or array -> float32 mono waveform at ``target_rate``."""
    if isinstance(audio, str):
        data = wavio.read_wav(audio)
        waveform = data.normalized_mono()
        if data.sample_rate != target_rate:
            waveform = rs.resample(waveform, data.sample_rate, target_rate).astype(
                np.float32
            )
        return waveform
    waveform = np.asarray(audio, dtype=np.float32)
    if waveform.ndim == 2:
        waveform = rs.downmix(waveform)
    if sample_rate is not None and sample_rate != target_rate:
        waveform = rs.resample(waveform, sample_rate, target_rate)
    return waveform


@dataclasses.dataclass
class StageTimings:
    """Where one request's time went.

    Host wall seconds: ``segmentation`` (host prep + launching both device
    stages; stage 2 is launched asynchronously, so its host time is in
    here), ``fetch`` (waiting for the device and copying the clustering
    inputs), ``clustering`` (host clustering + the device post-step + the
    decode).

    Device milliseconds from CUDA events (0 on the CPU): ``stage1_ms``,
    ``stage2_ms`` and ``post_ms`` (the post-clustering aggregation).
    """

    segmentation: float = 0.0
    fetch: float = 0.0
    clustering: float = 0.0
    stage1_ms: float = 0.0
    stage2_ms: float = 0.0
    post_ms: float = 0.0


class SpeakerDiarizationPipeline:
    """wav -> speech turns, pyannote speaker-diarization v2.x recipe.

    ``params``: ``{"segmentation": tree, "embedding": tree}`` in the JAX
    package's pytree layout (models/convert.py load_checkpoint), or None for
    seeded random weights. ``device``: None runs on the CUDA card and raises
    without one; pass ``"cpu"`` to run on the CPU (every kernel then runs
    its plain PyTorch version). ``precision``: "default" or "highest" (TF32
    off for float32 matmuls, convolutions and the LSTM).
    """

    def __init__(
        self,
        config: DiarizationConfig = DEFAULT_CONFIG,
        params: Optional[Dict] = None,
        seed: int = 0,
        seg_batch: Optional[int] = None,
        emb_batch: Optional[int] = None,
        precision: str = "default",
        clusterer: Union[str, object] = "ahc",
        exact_orphan: bool = True,
        pyannet_cfg: Optional[PyanNetConfig] = None,
        ecapa_cfg: Optional[EcapaConfig] = None,
        device=None,
    ):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
        if config.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unsupported compute_dtype {config.compute_dtype!r}")
        self.device = resolve_device(device)
        self.config = config
        self.pyannet_cfg = pyannet_cfg or PyanNetConfig(
            sample_rate=config.segmentation.sample_rate,
            num_classes=config.segmentation.num_speakers,
        )
        self.ecapa_cfg = ecapa_cfg or EcapaConfig(in_channels=config.frontend.n_mels)
        generator = torch.Generator().manual_seed(seed)
        seg_model = PyanNet(self.pyannet_cfg, generator=generator)
        emb_model = EcapaTDNN(self.ecapa_cfg, generator=generator)
        if params is not None:
            seg_state, emb_state = convert.params_from_jax(params)
            seg_model.load_state_dict(seg_state)
            emb_model.load_state_dict(emb_state)
        # compute_dtype="bfloat16": the ECAPA trunk runs with bf16 weights
        # and activations (cast once, here); the front-end and the returned
        # embeddings stay float32
        self.emb_dtype = getattr(torch, config.compute_dtype)
        self.segmentation_model = seg_model.to(self.device).eval()
        self.embedding_model = emb_model.to(self.device, self.emb_dtype).eval()
        self.seg_batch = seg_batch or config.segmentation.batch_size
        self.emb_batch = emb_batch or config.embedding.batch_size
        self.precision = precision
        if isinstance(clusterer, str):
            if clusterer != "ahc":
                raise ValueError(f"unknown clusterer: {clusterer!r}")
            clusterer = AgglomerativeClustering(config.clustering)
        self.clusterer = clusterer
        # exact_orphan=True (default): every chunk is scored with its TRUE
        # sample count (masked instance norms + packed reverse LSTM), so the
        # short orphan chunk matches the reference's true-length inference
        # (segment/segment.py:103-108). False lets the zero padding reach
        # the norms (up to ~0.008 sigmoid deviation on the orphan's frames).
        self.exact_orphan = exact_orphan
        self.timings = StageTimings()
        self._plans: Dict = {}  # aggregation plans by (kind, chunk count)
        seg_cfg = config.segmentation
        self._min_num_frames = float(
            math.ceil(
                seg_cfg.num_frames * config.embedding.min_num_samples / seg_cfg.window_size
            )
        )

    # ------------------------------------------------------------------
    # plans
    # ------------------------------------------------------------------

    def chunk_lattice(self, num_chunks: int) -> int:
        """Padded chunk count: a multiple of both batch sizes and of
        config.chunk_bucket, so the model batches see few shapes."""
        bucket = math.lcm(
            self.seg_batch, self.emb_batch, max(self.config.chunk_bucket, 1)
        )
        return _ceil_to(num_chunks, bucket)

    def _diarization_plan(self, num_chunks):
        """Aggregation plan for the post-clustering overlap-add: untrimmed
        chunk grid onto the model frame grid."""
        key = ("diarization", num_chunks)
        if key in self._plans:
            return self._plans[key]
        seg_cfg = self.config.segmentation
        chunk_grid = SlidingWindow(0.0, seg_cfg.step, seg_cfg.duration)
        frame_grid = SlidingWindow(
            seg_cfg.frame_start, seg_cfg.frame_step, seg_cfg.frame_duration
        )
        return self._plans.setdefault(
            key, plan_aggregation(num_chunks, chunk_grid, frame_grid)
        )

    def _count_plan(self, num_chunks):
        """Aggregation plan for the speaker-count grid (exact f64 host frame
        arithmetic)."""
        key = ("count", num_chunks)
        if key in self._plans:
            return self._plans[key]
        seg_cfg = self.config.segmentation
        trimmed_frames = SlidingWindow(
            start=seg_cfg.warm_up[0] * seg_cfg.duration,
            step=seg_cfg.step,
            duration=(1 - seg_cfg.warm_up[0] - seg_cfg.warm_up[1]) * seg_cfg.duration,
        )
        frame_grid = SlidingWindow(
            seg_cfg.frame_start, seg_cfg.frame_step, seg_cfg.frame_duration
        )
        return self._plans.setdefault(
            key, plan_aggregation(num_chunks, trimmed_frames, frame_grid)
        )

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(array)).to(self.device)

    # ------------------------------------------------------------------
    # device stages
    # ------------------------------------------------------------------

    def _post_process(self, segs: torch.Tensor, valid_frames: torch.Tensor):
        """Binarize -> mask choice -> speaker-count aggregation from the
        (padding-masked) scores. Returns (binarized, chosen, count_raw,
        inactive)."""
        seg_cfg = self.config.segmentation
        binarized = bz.binarize_swf(segs, seg_cfg.onset, seg_cfg.offset)
        cleaned = mk.clean_segmentations(binarized)
        chosen = mk.choose_masks(binarized, cleaned, self._min_num_frames)
        # speaker count: trim warm-up, sum speakers, overlap-add average;
        # bucket-padding chunks go to NaN so the aggregation ignores them
        # (the real orphan chunk keeps its zeros, like the reference)
        left = math.floor(seg_cfg.num_frames * seg_cfg.warm_up[0])
        right = math.floor(seg_cfg.num_frames * seg_cfg.warm_up[1])
        summed = binarized[:, left : seg_cfg.num_frames - right, :].sum(
            dim=-1, keepdim=True
        )
        summed = torch.where(
            (valid_frames > 0)[:, None, None], summed, torch.full_like(summed, float("nan"))
        )
        plan = self._count_plan(valid_frames.shape[0])
        count_raw = aggregate(
            summed,
            self._to_device(plan.start_frames),
            plan.num_frames,
            missing=0.0,
            skip_average=False,
        )[:, 0]
        inactive = binarized.sum(dim=1) == 0
        return binarized, chosen, count_raw, inactive

    def _stage1(
        self, chunks: torch.Tensor, valid_frames: np.ndarray, valid_samples: np.ndarray
    ):
        """chunks (num_padded, window) -> PyanNet (SincNet in batches of
        seg_batch, the LSTM head over every chunk) -> orphan/pad masking ->
        post-processing. ``valid_frames``/``valid_samples`` are host arrays:
        the model output frames backed by real audio (0 for padding chunks)
        and each chunk's true sample count. Returns (segs, binarized,
        chosen, count_raw, inactive)."""
        model = self.segmentation_model
        num_chunks = chunks.shape[0]
        vs_host = torch.from_numpy(valid_samples.astype(np.int64))
        vs_dev = vs_host.to(self.device) if self.exact_orphan else None
        feats = torch.cat(
            [
                model.sincnet(
                    chunks[i : i + self.seg_batch],
                    None if vs_dev is None else vs_dev[i : i + self.seg_batch],
                )
                for i in range(0, num_chunks, self.seg_batch)
            ]
        )
        valid_head = (
            pyannet_valid_chain(vs_host, self.pyannet_cfg)[5] if self.exact_orphan else None
        )
        segs = model.head_forward(feats, valid_head)
        vf_dev = self._to_device(valid_frames)
        frame_idx = torch.arange(segs.shape[1], device=self.device)
        segs = torch.where(
            (frame_idx[None, :] < vf_dev[:, None])[..., None], segs, torch.zeros_like(segs)
        )
        return (segs,) + self._post_process(segs, vf_dev)

    def _stage2(self, chunks: torch.Tensor, chosen: torch.Tensor):
        """chunks (num_padded, window), chosen (num_padded, S, F) -> batches
        of (gather windows + left-pack + log-mel features + ECAPA). Returns
        (embeddings (rows, D) in transfer_dtype, too_short (rows,) bool)."""
        cfg = self.config
        S = cfg.segmentation.num_speakers
        rows = chosen.reshape(chosen.shape[0] * S, -1)
        chunk_of_row = torch.arange(rows.shape[0], device=self.device) // S
        embs, shorts = [], []
        for i in range(0, rows.shape[0], self.emb_batch):
            windows = chunks[chunk_of_row[i : i + self.emb_batch]]
            signals, wav_lens, too_short = mk.pack_and_lengths(
                windows,
                rows[i : i + self.emb_batch],
                cfg.embedding.mask_threshold,
                cfg.embedding.min_num_samples,
            )
            feats = fe.compute_features(signals, wav_lens, cfg.frontend)
            emb = self.embedding_model(feats.to(self.emb_dtype), wav_lens)
            embs.append(emb.to(torch.float32))
            shorts.append(too_short)
        emb = torch.cat(embs).to(getattr(torch, cfg.transfer_dtype))
        return emb, torch.cat(shorts)

    # ------------------------------------------------------------------
    # the pipeline
    # ------------------------------------------------------------------

    def __call__(
        self,
        audio: Union[str, np.ndarray],
        sample_rate: Optional[int] = None,
        num_speakers: Optional[int] = None,
        min_speakers: Optional[int] = None,
        max_speakers: Optional[int] = None,
    ) -> Annotation:
        with precision_scope(self.precision):
            pending = self._dispatch(audio, sample_rate)
            return self._collect(
                pending,
                num_speakers=num_speakers,
                min_speakers=min_speakers,
                max_speakers=max_speakers,
            )

    def _events(self):
        if self.device.type != "cuda":
            return None
        return [torch.cuda.Event(enable_timing=True) for _ in range(3)]

    def _prepare(self, waveform: np.ndarray):
        """Host prep of one waveform: (num_chunks, num_padded, wav_padded,
        valid_frames, valid_samples). The chunk axis is padded to the batch
        lattice (padding chunks get valid_frames 0); the orphan last chunk
        gets its true frame and sample counts."""
        seg_cfg = self.config.segmentation
        num_samples = waveform.shape[0]
        num_chunks = win.chunk_count(num_samples, seg_cfg.window_size, seg_cfg.step_size)
        num_padded = self.chunk_lattice(num_chunks)
        needed = (num_padded - 1) * seg_cfg.step_size + seg_cfg.window_size
        wav_padded = np.zeros(needed, dtype=np.float32)
        wav_padded[:num_samples] = waveform
        # 16-bit-quantized audio (an int16 WAV, no resample) travels as raw
        # int16, half the bytes; the device rescales exactly. Only taken
        # when waveform*32768 is integral and in int16 range.
        scaled = wav_padded * 32768.0
        if float(np.max(np.abs(scaled), initial=0.0)) <= 32767.0:
            quant = scaled.astype(np.int16)
            if np.array_equal(quant.astype(np.float32), scaled):
                wav_padded = quant
        valid_frames = np.zeros(num_padded, dtype=np.int32)
        valid_frames[:num_chunks] = seg_cfg.num_frames
        valid_samples = np.zeros(num_padded, dtype=np.int32)
        valid_samples[:num_chunks] = seg_cfg.window_size
        orphan_samples = num_samples - (num_chunks - 1) * seg_cfg.step_size
        if orphan_samples < seg_cfg.window_size:
            valid_frames[num_chunks - 1] = max(
                pyannet_num_frames(orphan_samples, self.pyannet_cfg), 0
            )
            valid_samples[num_chunks - 1] = orphan_samples
        return num_chunks, num_padded, wav_padded, valid_frames, valid_samples

    @torch.inference_mode()
    def _dispatch(self, audio, sample_rate=None, timings: Optional[StageTimings] = None):
        """Host prep + both device stages, launched without waiting;
        returns the pending state _collect needs."""
        timings = timings if timings is not None else self.timings
        seg_cfg = self.config.segmentation
        waveform = load_waveform(audio, sample_rate, seg_cfg.sample_rate)
        num_samples = waveform.shape[0]

        t0 = time.perf_counter()
        num_chunks, num_padded, wav_padded, valid_frames, valid_samples = self._prepare(
            waveform
        )
        events = self._events()
        if events:
            events[0].record()
        chunks = win.device_chunks(
            self._to_device(wav_padded), num_padded, seg_cfg.window_size, seg_cfg.step_size
        )
        segmentations, binarized, chosen, count_raw, inactive = self._stage1(
            chunks, valid_frames, valid_samples
        )
        if events:
            events[1].record()
        emb, too_short = self._stage2(chunks, chosen)
        if events:
            events[2].record()

        real_plan = self._count_plan(num_chunks)
        timings.segmentation = time.perf_counter() - t0
        return {
            "num_samples": num_samples,
            "num_chunks": num_chunks,
            "num_padded": num_padded,
            "segmentations": segmentations,
            "binarized": binarized,
            "count_raw": count_raw,
            "inactive": inactive,
            "emb": emb,
            "too_short": too_short,
            "chunk_frames": SlidingWindow(
                0.0, seg_cfg.step, seg_cfg.duration, num_samples=num_samples
            ),
            "real_plan": real_plan,
            "count_frames": dataclasses.replace(real_plan.frames, num_samples=num_samples),
            "events": events,
        }

    @torch.inference_mode()
    def _collect(
        self,
        pending,
        num_speakers=None,
        min_speakers=None,
        max_speakers=None,
        timings: Optional[StageTimings] = None,
    ) -> Annotation:
        """Fetch one pending request's clustering inputs, cluster on host,
        run the device post-step, decode the timeline."""
        timings = timings if timings is not None else self.timings
        cfg = self.config
        seg_cfg = cfg.segmentation
        num_chunks = pending["num_chunks"]
        num_padded = pending["num_padded"]
        real_plan = pending["real_plan"]

        t0 = time.perf_counter()
        rows = num_chunks * seg_cfg.num_speakers
        emb_h = pending["emb"].cpu().numpy()
        too_short_h = pending["too_short"].cpu().numpy()
        inactive_h = pending["inactive"].cpu().numpy()[:num_chunks]
        embeddings = finalize_embeddings(
            emb_h[:rows], too_short_h[:rows], num_chunks, seg_cfg.num_speakers
        )
        timings.fetch = time.perf_counter() - t0
        events = pending.get("events")
        if events:
            timings.stage1_ms = events[0].elapsed_time(events[1])
            timings.stage2_ms = events[1].elapsed_time(events[2])

        t0 = time.perf_counter()
        hard, _soft = self.clusterer(
            embeddings,
            num_clusters=num_speakers or cfg.num_speakers,
            min_clusters=min_speakers or cfg.min_speakers,
            max_clusters=max_speakers or cfg.max_speakers,
        )
        hard = np.asarray(hard)
        hard[inactive_h] = -2  # speakerDiarizer.cpp:3166-3191
        num_clusters = max(int(hard.max()) + 1, 1)
        membership = np.zeros((num_padded, seg_cfg.num_speakers, num_clusters), dtype=bool)
        ci, si = np.nonzero(hard >= 0)
        membership[ci, si, hard[ci, si]] = True

        post_events = self._events()
        if post_events:
            post_events[0].record()
        dia_plan = self._diarization_plan(num_padded)
        activations_dev = post_cluster(
            pending["segmentations"],
            self._to_device(membership),
            self._to_device(dia_plan.start_frames),
            dia_plan.num_frames,
        )
        if post_events:
            post_events[1].record()
        real_dia_plan = self._diarization_plan(num_chunks)
        activations = activations_dev.cpu().numpy()[: real_dia_plan.num_frames, :num_clusters]
        count_h = pending["count_raw"].cpu().numpy()
        if post_events:
            timings.post_ms = post_events[0].elapsed_time(post_events[1])
        count = np.rint(count_h[: real_plan.num_frames]).astype(np.int64)
        binary, binary_frames = rec.binarize_by_count(
            activations, real_dia_plan.frames, count, pending["count_frames"]
        )
        annotation = rec.to_annotation(
            binary,
            binary_frames,
            onset=cfg.clustering.binarize_onset,
            offset=cfg.clustering.binarize_offset,
            min_duration_on=seg_cfg.min_duration_on,
            min_duration_off=seg_cfg.min_duration_off,
        )
        timings.clustering = time.perf_counter() - t0
        return annotation

    def finalize(
        self,
        segmentations: np.ndarray,
        binarized: np.ndarray,
        embeddings: np.ndarray,
        count: np.ndarray,
        count_frames: SlidingWindow,
        chunk_frames: SlidingWindow,
        num_speakers: Optional[int] = None,
        min_speakers: Optional[int] = None,
        max_speakers: Optional[int] = None,
        inactive: Optional[np.ndarray] = None,
        clusterer=None,
    ) -> Annotation:
        """Stage 3 on host arrays: cluster embeddings, reconstruct the
        global timeline, decode turns. ``inactive`` (chunks, speakers) bool
        marks locally-silent speakers; derived from ``binarized`` when not
        given. ``clusterer`` overrides self.clusterer for one call."""
        cfg = self.config
        seg_cfg = cfg.segmentation
        hard, _soft = (clusterer or self.clusterer)(
            embeddings,
            num_clusters=num_speakers or cfg.num_speakers,
            min_clusters=min_speakers or cfg.min_speakers,
            max_clusters=max_speakers or cfg.max_speakers,
        )
        if inactive is None:
            inactive = binarized.sum(axis=1) == 0
        hard = np.asarray(hard)
        hard[inactive] = -2
        discrete, discrete_frames = rec.reconstruct(
            segmentations, chunk_frames, hard, count, count_frames
        )
        return rec.to_annotation(
            discrete,
            discrete_frames,
            onset=cfg.clustering.binarize_onset,
            offset=cfg.clustering.binarize_offset,
            min_duration_on=seg_cfg.min_duration_on,
            min_duration_off=seg_cfg.min_duration_off,
        )
