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
  - stage 3, for an eligible request (``device_clustering="auto"``, no
    speaker bounds, at most ``device_cluster_rows`` rows), runs on the device
    right after stage 2: clustering (clustering/device.py, its merge loop one
    launch of ``csrc/linkage.cu``), the per-cluster max and the overlap-add,
    giving float16 activations; the host fetches those once and decodes the
    timeline (pipelines/reconstruct.py). Otherwise the host fetches the
    embeddings, clusters them (clustering/base.py) and the per-cluster max
    and overlap-add run on the device before the decode.

The device work of a request is launched asynchronously on the current
stream, and the host never waits for the card while it launches it
(``_dispatch``): every host array reaches the card from pinned memory
behind the queued work, and the one-time set-up (the kernels' build, the
front-end's tables) happens in ``__init__``; only ``profile=True`` makes it
wait, at the ends of stages 1 and 2. On the device route the host
waits once, for the activations; on the host route once for the
clustering inputs and once for the activations. ``map`` launches every
request before it collects the first, so the card runs them back to back
while the host decodes.

Besides ``__call__`` and ``map``: ``warmup``; ``run_chunks``,
``run_chunks_device`` and ``stage2_internals`` (stages 1 and 2 on a chunk
range, the building blocks of long-form and streaming and of the
differential dumps, utils/instrumented.py); and ``finalize``, stage 3 on
host arrays. ``dump=`` records the reference's named intermediates.
``mesh=`` runs every entry point data-parallel over the ranks of a
``torch.distributed`` group (parallel/mesh.py); ``count_parts`` and
``post_cluster_from_hard`` are long-form's per-shard device steps
(parallel/longform.py).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import time
from typing import Dict, Optional, Union

import numpy as np
import torch

from ..clustering import device as devclu
from ..clustering.base import AgglomerativeClustering
from ..config import DEFAULT_CONFIG, DiarizationConfig
from ..core.annotation import Annotation
from ..core.sliding_window import SlidingWindow
from ..io import resample as rs
from ..io import wav as wavio
from ..models import convert
from ..models import layers as L
from ..models.ecapa import EcapaConfig, EcapaTDNN
from ..models.pyannet import PyanNetConfig, pyannet_num_frames, pyannet_valid_chain
from ..ops import _cuda_lib
from ..ops import binarize as bz
from ..ops import frontend as fe
from ..ops import masks as mk
from ..ops import windows as win
from ..ops.aggregate import aggregate, plan_aggregation
from ..parallel.mesh import batch_counts, batch_spec, replicated
from . import reconstruct as rec

PRECISIONS = ("default", "highest")


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; without one, only an explicit CPU
    request runs. A CUDA device comes back with its index, as the tensors on
    it report their device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available: pass device='cpu' to run on the CPU"
            )
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is not available")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


# the TF32 flags are process-global: threads inside a "highest" scope share
# one entry count, the first in saves and clears the flags, the last out
# restores them
_TF32_LOCK = threading.Lock()
_tf32_scope = {"depth": 0, "saved": None}


@contextlib.contextmanager
def precision_scope(precision: str):
    """``"highest"``: float32 matmuls and cuDNN convolutions/RNNs in full
    float32 (TF32 off) for the duration, flags restored afterwards.
    ``"default"``: PyTorch's own settings (cuDNN uses TF32 for float32).

    Threads may hold "highest" scopes at once (the server runs requests on
    threads): the flags stay off until the last of them leaves."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    if precision == "default":
        yield
        return
    with _TF32_LOCK:
        if _tf32_scope["depth"] == 0:
            _tf32_scope["saved"] = (
                torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32,
            )
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        _tf32_scope["depth"] += 1
    try:
        yield
    finally:
        with _TF32_LOCK:
            _tf32_scope["depth"] -= 1
            if _tf32_scope["depth"] == 0:
                (
                    torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32,
                ) = _tf32_scope["saved"]


def prepare_device(device: torch.device, frontend_cfg) -> None:
    """One-time set-up that waits (for nvcc, for the card), done when a
    pipeline is built so that no dispatch waits for it: on a CUDA device the
    kernels' libraries are built and loaded and the log-mel kernel's tables
    made."""
    if device.type == "cuda":
        for name in _cuda_lib.KERNELS:
            _cuda_lib.library(name)
    fe.prepare(frontend_cfg, device)


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
    masked = torch.where(membership[:, None, :, :], segs[..., None], float("-inf"))
    clustered = masked.amax(dim=2)  # (n, F, K)
    has = membership.any(dim=1)[:, None, :]
    clustered = torch.where(has, clustered, float("nan"))
    return aggregate(clustered, start_frames, num_frames, missing=0.0, skip_average=True)


def membership_from_hard(hard: torch.Tensor, k_max: int) -> torch.Tensor:
    """(n, S) cluster labels (negative: in no cluster) -> (n, S, k_max)
    bool one-hot membership."""
    clusters = torch.arange(k_max, device=hard.device)
    return (hard[:, :, None] == clusters) & (hard >= 0)[:, :, None]


def post_cluster_from_hard(
    segs: torch.Tensor,
    hard_all: torch.Tensor,
    ofs: int,
    start_frames: torch.Tensor,
    num_frames: int,
    k_max: int,
) -> torch.Tensor:
    """``post_cluster`` driven by a device-resident hard-label vector (the
    long-form fused stage 3, parallel/longform.py): this range's padded
    block of rows sits at ``ofs`` in ``hard_all``, and the membership is
    derived on the device, so neither it nor the embeddings reach the
    host."""
    n, _, S = segs.shape
    hard = hard_all[ofs : ofs + n * S].reshape(n, S)
    return post_cluster(segs, membership_from_hard(hard, k_max), start_frames, num_frames)


def count_parts(
    binarized: torch.Tensor,
    valid_frames: torch.Tensor,
    start_frames: torch.Tensor,
    num_frames: int,
    left: int,
    right: int,
):
    """Numerator and denominator of the speaker-count overlap-add of a
    chunk range on the given (globally consistent) frame grid: the summed
    trimmed speaker counts and the overlap counts. Both are linear in the
    chunks, so a sharded long-form run adds the per-shard parts and divides
    once on the host, equal to the single-shot count (reference
    speaker_count, speakerDiarizer.cpp:1665-1738). Padding chunks
    (valid_frames 0) add nothing."""
    F = binarized.shape[1]
    summed = binarized[:, left : F - right, :].sum(dim=-1, keepdim=True)
    ok = (valid_frames > 0)[:, None, None]
    nan = torch.full_like(summed, float("nan"))
    num = aggregate(
        torch.where(ok, summed, nan), start_frames, num_frames, missing=0.0, skip_average=True
    )
    den = aggregate(
        torch.where(ok, torch.ones_like(summed), nan),
        start_frames,
        num_frames,
        missing=0.0,
        skip_average=True,
    )
    return num[:, 0], den[:, 0]


def stage3(
    segs: torch.Tensor,
    emb: torch.Tensor,
    too_short: torch.Tensor,
    inactive: torch.Tensor,
    start_frames: torch.Tensor,
    num_frames: int,
    clu_key: tuple,
):
    """Stage 3 on the device: clustering (clustering/device.py), the one-hot
    membership of each (chunk, local speaker) row, the per-cluster max and
    the skip-average overlap-add. ``clu_key``: (threshold, min_cluster_size,
    k_max, train_cap). Returns (activations (num_frames, k_max) float16,
    hard (rows,) int32, num_large () int32)."""
    threshold, mcs, k_max, cap = clu_key
    n, _, S = segs.shape
    res = devclu.device_cluster(
        emb.to(torch.float32),
        ~too_short,
        inactive.reshape(-1),
        threshold,
        mcs,
        k_max,
        train_cap=cap,
    )
    membership = membership_from_hard(res.hard.reshape(n, S), k_max)
    activations = post_cluster(segs, membership, start_frames, num_frames)
    return activations.to(torch.float16), res.hard, res.num_large


def to_host(*tensors: torch.Tensor):
    """Device tensors -> numpy arrays, with one wait for all of them."""
    if any(t.device.type == "cuda" for t in tensors):
        tensors = [t.to("cpu", non_blocking=True) for t in tensors]
        torch.cuda.current_stream().synchronize()
    return [t.numpy() for t in tensors]


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

    Host wall seconds, in the JAX package's fields. Default
    (``pipeline.profile`` False: the dispatch makes no host wait):
    ``segmentation`` is the host prep and the launch of every device stage
    (they run asynchronously, so their host time is in here);
    ``embedding`` is 0 (not measured apart); ``fetch`` is the wait for the
    device and the copy of what the host needs (the activations on the
    device route, the clustering inputs on the host route);
    ``clustering`` is the decode (on the host route also host clustering
    and the device post-step).

    With ``pipeline.profile`` True the dispatch waits for the card at the
    stage boundaries: ``segmentation`` ends when stage 1 has run on the
    device, ``embedding`` spans from there until stage 2 has run, and
    stage 3 is launched after that, so ``fetch`` holds what is left of it
    besides the copy (as in the JAX package, where ``fetch`` holds what is
    left of the device work). On the CPU, where the stages run inside their
    launch, each span is the host time of its stage. The host's launch of
    device stage 3 falls in no span.

    ``total`` is the sum of the four host spans.

    Device milliseconds from CUDA events (0 on the CPU, and 0 for a stage
    the request did not run): ``stage1_ms``, ``stage2_ms``, ``stage3_ms``
    (device stage 3) and ``post_ms`` (the host route's post-clustering
    aggregation). With ``profile`` True, ``stage2_ms`` and ``stage3_ms``
    also hold the card's idle time while the host, back from its wait,
    launches the stage.
    """

    segmentation: float = 0.0
    embedding: float = 0.0
    fetch: float = 0.0
    clustering: float = 0.0
    stage1_ms: float = 0.0
    stage2_ms: float = 0.0
    stage3_ms: float = 0.0
    post_ms: float = 0.0

    @property
    def total(self) -> float:
        return self.segmentation + self.embedding + self.fetch + self.clustering


class SpeakerDiarizationPipeline:
    """wav -> speech turns, pyannote speaker-diarization v2.x recipe.

    ``params``: ``{"segmentation": tree, "embedding": tree}`` in the JAX
    package's pytree layout (models/convert.py load_checkpoint), or None for
    seeded random weights (a part missing from it keeps them too).
    ``device``: None runs on the CUDA card and raises without one; pass
    ``"cpu"`` to run on the CPU (every kernel then runs its plain PyTorch
    version). ``precision``: "default" or "highest" (TF32
    off for float32 matmuls, convolutions and the LSTM).

    ``device_clustering``: "auto" (the default) runs stage 3 on the device
    for every eligible request: the default agglomerative clusterer
    (centroid linkage, cosine, unconstrained), no speaker bounds, at most
    ``device_cluster_rows`` embedding rows, and a merge loop of at most
    ``_UNCAPPED_DEVICE_ROWS`` train rows; every other request, and one whose
    device result has no cluster or more than ``k_max``, takes the host
    clusterer. False always takes the host clusterer; True raises on an
    incompatible clusterer.

    ``clusterer``: "ahc" (clustering/base.py, the default), "spectral"
    (clustering/spectral.py; stage 3 then always takes the host route), or
    any object with the same call signature.

    ``ecapa_layout``: how the ECAPA trunk holds its activations in every
    stage-2 entry point — "nch" (the default, as in the JAX package), "nhc"
    or "gemm" (models/ecapa.py); same weights, same state dict.

    ``profile``: True makes ``timings.segmentation`` and
    ``timings.embedding`` per-stage spans (StageTimings), at the cost of
    two host waits for the card in every dispatch; callers may flip the
    attribute between requests.

    ``mesh``: a parallel.mesh.DataMesh; every rank of its group then calls
    the pipeline on the same request (SPMD), and the pipeline runs on the
    mesh's device. Each rank runs a contiguous block of whole SincNet
    batches and of whole stage-2 batches (``batch_spec``), with its own
    kernels on its own card, and the blocks are gathered to every rank
    (``replicated``): the SincNet features before the LSTM head, the
    embeddings and too-short flags after stage 2. The LSTM head, the
    post-processing, stage 3 and the decode run on every rank over the
    whole request. A batch keeps the shape it has on one card and the head
    sees every chunk, as on one card, so the libraries are given the same
    calls and a rank's result equals the single-card run's; the head is
    launch-bound (one step a frame and layer), so splitting it would save
    little. ``seg_batch`` and ``emb_batch`` must divide by the world size
    (the JAX package's rule).
    """

    # the largest merge loop (train rows T) the device stage 3 takes: T is
    # the clusterer's train cap rounded up to 128, or the row count when the
    # clusterer has no cap
    _UNCAPPED_DEVICE_ROWS = 1536

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
        device_clustering: Union[str, bool] = "auto",
        device_cluster_rows: int = 6144,
        k_max: int = 8,
        ecapa_layout: str = "nch",
        mesh=None,
        profile: bool = False,
    ):
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
        if config.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unsupported compute_dtype {config.compute_dtype!r}")
        if mesh is not None:
            if device is not None and resolve_device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh's {mesh.device}")
            device = mesh.device
        self.device = resolve_device(device)
        self.mesh = mesh
        self.config = config
        self.pyannet_cfg = pyannet_cfg or PyanNetConfig(
            sample_rate=config.segmentation.sample_rate,
            num_classes=config.segmentation.num_speakers,
        )
        self.ecapa_cfg = ecapa_cfg or EcapaConfig(in_channels=config.frontend.n_mels)
        generator = torch.Generator().manual_seed(seed)
        # a part missing from ``params`` keeps its seeded random weights
        seg_model = convert.build_pyannet(
            (params or {}).get("segmentation"), self.pyannet_cfg, generator
        )
        emb_model = EcapaTDNN(self.ecapa_cfg, generator=generator, layout=ecapa_layout)
        self.ecapa_layout = ecapa_layout
        if params is not None and "embedding" in params:
            emb_model.load_state_dict(convert.ecapa_state_from_tree(params["embedding"]))
        # compute_dtype="bfloat16": the ECAPA trunk runs with bf16 weights
        # and activations (cast once, here); the front-end and the returned
        # embeddings stay float32
        self.emb_dtype = getattr(torch, config.compute_dtype)
        self.segmentation_model = seg_model.to(self.device).eval()
        self.embedding_model = emb_model.to(self.device, self.emb_dtype).eval()
        self.seg_batch = seg_batch or config.segmentation.batch_size
        self.emb_batch = emb_batch or config.embedding.batch_size
        if mesh is not None and (
            self.seg_batch % mesh.world_size or self.emb_batch % mesh.world_size
        ):
            raise ValueError(
                f"seg_batch={self.seg_batch} and emb_batch={self.emb_batch} "
                f"must be divisible by the mesh size ({mesh.world_size})"
            )
        self.precision = precision
        if isinstance(clusterer, str):
            if clusterer == "ahc":
                clusterer = AgglomerativeClustering(config.clustering)
            elif clusterer == "spectral":
                from ..clustering.spectral import SpectralClustering

                clusterer = SpectralClustering()
            else:
                raise ValueError(f"unknown clusterer: {clusterer!r}")
        self.clusterer = clusterer
        self.k_max = k_max
        self.device_cluster_rows = device_cluster_rows
        compatible = (
            isinstance(clusterer, AgglomerativeClustering)
            and clusterer.config.method == "centroid"
            and clusterer.config.metric == "cosine"
            and not clusterer.constrained_assignment
        )
        if device_clustering is True and not compatible:
            raise ValueError(
                "device_clustering=True requires the default agglomerative "
                "clusterer (centroid linkage, cosine metric, unconstrained)"
            )
        self._device_clu_enabled = bool(device_clustering) and compatible
        # exact_orphan=True (default): every chunk is scored with its TRUE
        # sample count (masked instance norms + packed reverse LSTM), so the
        # short orphan chunk matches the reference's true-length inference
        # (segment/segment.py:103-108). False lets the zero padding reach
        # the norms (up to ~0.008 sigmoid deviation on the orphan's frames).
        self.exact_orphan = exact_orphan
        self.profile = profile
        self.timings = StageTimings()
        self._plans: Dict = {}  # aggregation plans by (kind, chunk count)
        seg_cfg = config.segmentation
        self._min_num_frames = float(
            math.ceil(
                seg_cfg.num_frames * config.embedding.min_num_samples / seg_cfg.window_size
            )
        )
        prepare_device(self.device, config.frontend)

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

    def _device_train_size(self, rows: int, cap) -> int:
        """The merge-loop size device_cluster would use."""
        if cap is None:
            return rows
        return min(rows, -(-cap // 128) * 128)

    def _no_speaker_bounds(self, num_speakers, min_speakers, max_speakers) -> bool:
        """True when neither the call nor the config pins speaker counts
        (explicit bounds need the host dendrogram search)."""
        cfg = self.config
        return all(
            b is None
            for b in (
                num_speakers,
                min_speakers,
                max_speakers,
                cfg.num_speakers,
                cfg.min_speakers,
                cfg.max_speakers,
            )
        )

    def _device_clu_key(self):
        """(threshold, min_cluster_size, k_max, train_cap) when device
        clustering is enabled and the clusterer is compatible, else None."""
        if not self._device_clu_enabled:
            return None
        c = self.clusterer.config
        cap = self.clusterer.max_num_embeddings
        # "no cap" spellings (None, inf) -> None
        cap = None if cap is None or cap == float("inf") else int(cap)
        return (c.threshold, c.min_cluster_size, self.k_max, cap)

    def _device_clu_eligible(self, rows: int, num_speakers, min_speakers, max_speakers) -> bool:
        """Whether a request of ``rows`` embedding rows runs stage 3 on the
        device: enabled, at most ``device_cluster_rows`` rows, a merge loop
        of at most ``_UNCAPPED_DEVICE_ROWS`` train rows (a clusterer without a
        cap, or with a large one, sizes the loop past it), and no speaker
        bounds."""
        if not self._device_clu_enabled or rows > self.device_cluster_rows:
            return False
        cap = self._device_clu_key()[3]
        if self._device_train_size(rows, cap) > self._UNCAPPED_DEVICE_ROWS:
            return False
        return self._no_speaker_bounds(num_speakers, min_speakers, max_speakers)

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

    def _to_device(self, array) -> torch.Tensor:
        """A host array (numpy or a CPU tensor) on the pipeline's device,
        copied to the card from pinned memory behind the work already
        queued: the host does not wait."""
        return L.host_to_device(torch.as_tensor(np.ascontiguousarray(array)), self.device)

    # ------------------------------------------------------------------
    # device stages
    # ------------------------------------------------------------------

    def _batch_starts(self, rows: int, batch: int):
        """First rows of the batches of ``batch`` rows this rank runs: every
        batch without a mesh, else the rank's block (mesh.batch_spec)."""
        if self.mesh is None:
            return range(0, rows, batch)
        return [b * batch for b in batch_spec(self.mesh, rows // batch)]

    def _joined(
        self, parts, empty: torch.Tensor, rows: int, batch: int, dtype=None
    ) -> torch.Tensor:
        """This rank's outputs of its batches, concatenated (and cast to
        ``dtype``) -> the whole request's, on every rank of the mesh
        (mesh.replicated); ``empty`` is a (0, ...) block of the result's
        shape and dtype, for a rank with no batch. Every rank's block must
        have that dtype and row shape: the gather reads the blocks' bytes by
        the receiving rank's."""
        local = torch.cat(parts) if parts else empty
        if dtype is not None:
            local = local.to(dtype)
        if self.mesh is None:
            return local
        if (local.dtype, local.shape[1:]) != (empty.dtype, empty.shape[1:]):
            raise TypeError(
                f"rank {self.mesh.rank}'s block is {local.dtype} {tuple(local.shape[1:])}, "
                f"a rank with no batch sends {empty.dtype} {tuple(empty.shape[1:])}"
            )
        counts = [n * batch for n in batch_counts(self.mesh, rows // batch)]
        return replicated(self.mesh, local, counts)

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
        seg_batch, a mesh rank's block of them gathered; the LSTM head over
        every chunk) -> orphan/pad masking ->
        post-processing. ``valid_frames``/``valid_samples`` are host arrays:
        the model output frames backed by real audio (0 for padding chunks)
        and each chunk's true sample count. Returns (segs, binarized,
        chosen, count_raw, inactive)."""
        model = self.segmentation_model
        num_chunks = chunks.shape[0]
        vs_host = torch.from_numpy(valid_samples.astype(np.int64))
        vs_dev = self._to_device(vs_host) if self.exact_orphan else None
        sb = self.seg_batch
        cfg = self.pyannet_cfg
        feats = self._joined(
            [
                model.sincnet(chunks[i : i + sb], None if vs_dev is None else vs_dev[i : i + sb])
                for i in self._batch_starts(num_chunks, sb)
            ],
            chunks.new_empty((0, cfg.conv_channels, pyannet_num_frames(chunks.shape[1], cfg))),
            num_chunks,
            sb,
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

    def _stage2(self, chunks: torch.Tensor, chosen: torch.Tensor, with_internals: bool = False):
        """chunks (num_padded, window), chosen (num_padded, S, F) -> batches
        of (gather windows + left-pack + log-mel features + ECAPA). Returns
        (embeddings (rows, D) in transfer_dtype, too_short (rows,) bool);
        ``with_internals`` adds the packed signals (rows, window) and the
        normalized wav_lens (rows,) as the pack kernel and its length step
        computed them (the JAX package's ``stage2_debug``)."""
        cfg = self.config
        S = cfg.segmentation.num_speakers
        rows = chosen.reshape(chosen.shape[0] * S, -1)
        chunk_of_row = torch.arange(rows.shape[0], device=self.device) // S
        embs, shorts, packed, lens = [], [], [], []
        for i in self._batch_starts(rows.shape[0], self.emb_batch):
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
            if with_internals:
                packed.append(signals)
                lens.append(wav_lens)
        n, eb = rows.shape[0], self.emb_batch
        transfer = getattr(torch, cfg.transfer_dtype)
        new = chunks.new_empty
        emb = self._joined(
            embs, new((0, self.ecapa_cfg.emb_dim), dtype=transfer), n, eb, transfer
        )
        too_short = self._joined(shorts, new((0,), dtype=torch.bool), n, eb)
        if with_internals:
            window = chunks.shape[1]
            return (
                emb,
                too_short,
                self._joined(packed, new((0, window)), n, eb),
                self._joined(lens, new((0,)), n, eb),
            )
        return emb, too_short

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
        dump=None,
    ) -> Annotation:
        """``dump``: an optional utils.debug_dump.DumpSession that records the
        pipeline's intermediates under the reference's names; the request
        then fetches every stage output and runs stage 3 on the host
        (``finalize``)."""
        with precision_scope(self.precision):
            pending = self._dispatch(
                audio,
                sample_rate,
                num_speakers=num_speakers,
                min_speakers=min_speakers,
                max_speakers=max_speakers,
            )
            return self._collect(
                pending,
                num_speakers=num_speakers,
                min_speakers=min_speakers,
                max_speakers=max_speakers,
                dump=dump,
            )

    def map(
        self,
        audios,
        sample_rate: Optional[int] = None,
        num_speakers: Optional[int] = None,
        min_speakers: Optional[int] = None,
        max_speakers: Optional[int] = None,
    ):
        """Diarize several recordings: launch every request's device work,
        then collect them in order, so request i's fetch and decode overlap
        the card's work on the requests after it. Returns one Annotation per
        input, equal to ``self(audio)`` of each."""
        with precision_scope(self.precision):
            bounds = dict(
                num_speakers=num_speakers, min_speakers=min_speakers, max_speakers=max_speakers
            )
            pendings = [self._dispatch(a, sample_rate, **bounds) for a in audios]
            return [self._collect(p, **bounds) for p in pendings]

    def warmup(self, max_audio_seconds: float = 60.0, num_clusters: int = 4):
        """Run one request for every chunk bucket up to ``max_audio_seconds``
        (silence whose last chunk is an orphan, so the packed LSTM runs as
        a request with padding chunks runs it), plus the host route's post
        step at the K lattice of ``num_clusters``, then wait for the card. It
        pays what a first request would: cuDNN's plan choice for each shape
        and the allocator's first growth (the kernels are built in
        ``__init__``). Returns the padded chunk counts warmed, as the JAX
        package's ``warmup`` does for the same configuration."""
        seg_cfg = self.config.segmentation
        step, window = seg_cfg.step_size, seg_cfg.window_size
        max_samples = int(max_audio_seconds * seg_cfg.sample_rate)
        max_chunks = max(win.chunk_count(max_samples, window, step), 1)
        buckets = sorted({self.chunk_lattice(n) for n in range(1, max_chunks + 1)})
        k_pad = _ceil_to(num_clusters, 4)
        with precision_scope(self.precision), torch.inference_mode():
            for npad in buckets:
                audio = np.zeros((npad - 1) * step + window - step // 2, np.float32)
                pending = self._dispatch(audio)
                membership = np.zeros((npad, seg_cfg.num_speakers, k_pad), dtype=bool)
                plan = self._diarization_plan(npad)
                post_cluster(
                    pending["segmentations"],
                    self._to_device(membership),
                    self._to_device(plan.start_frames),
                    plan.num_frames,
                )
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return buckets

    def _events(self, n: int):
        if self.device.type != "cuda":
            return None
        return [torch.cuda.Event(enable_timing=True) for _ in range(n)]

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
    def _dispatch(
        self,
        audio,
        sample_rate=None,
        timings: Optional[StageTimings] = None,
        num_speakers=None,
        min_speakers=None,
        max_speakers=None,
    ):
        """Host prep + the device stages (stage 3 too for an eligible
        request), launched without waiting (with ``self.profile``, waiting
        for stage 1 and then stage 2 to run, StageTimings); returns the
        pending state _collect needs."""
        timings = timings if timings is not None else self.timings
        seg_cfg = self.config.segmentation
        waveform = load_waveform(audio, sample_rate, seg_cfg.sample_rate)
        num_samples = waveform.shape[0]

        t0 = time.perf_counter()
        num_chunks, num_padded, wav_padded, valid_frames, valid_samples = self._prepare(
            waveform
        )
        events = self._events(4)
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
        if self.profile:
            self._wait(events, 1)
            timings.segmentation = time.perf_counter() - t0
            t0 = time.perf_counter()
        emb, too_short = self._stage2(chunks, chosen)
        if events:
            events[2].record()
        if self.profile:
            self._wait(events, 2)
            timings.embedding = time.perf_counter() - t0
        else:
            timings.embedding = 0.0

        # stage 3 on the device, right behind stage 2: the host then fetches
        # only the activations
        device_clu = None
        rows = num_padded * seg_cfg.num_speakers
        if self._device_clu_eligible(rows, num_speakers, min_speakers, max_speakers):
            dia_plan = self._diarization_plan(num_padded)
            activations, hard, num_large = stage3(
                segmentations,
                emb,
                too_short,
                inactive,
                self._to_device(dia_plan.start_frames),
                dia_plan.num_frames,
                self._device_clu_key(),
            )
            device_clu = {"activations": activations, "hard": hard, "num_large": num_large}
        if events:
            events[3].record()

        real_plan = self._count_plan(num_chunks)
        if not self.profile:
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
            "device_clu": device_clu,
        }

    @torch.inference_mode()
    def _collect(
        self,
        pending,
        num_speakers=None,
        min_speakers=None,
        max_speakers=None,
        dump=None,
        timings: Optional[StageTimings] = None,
    ) -> Annotation:
        """Decode one pending request: from the device stage 3's activations
        (one fetch), or else fetch the clustering inputs, cluster on the
        host, run the device post-step and decode. With ``dump`` every stage
        output is fetched and the host twin ``finalize`` runs stage 3."""
        timings = timings if timings is not None else self.timings
        cfg = self.config
        seg_cfg = cfg.segmentation
        num_chunks = pending["num_chunks"]
        num_padded = pending["num_padded"]
        timings.post_ms = 0.0

        dc = pending.get("device_clu")
        bounds_given = any(b is not None for b in (num_speakers, min_speakers, max_speakers))
        if dc is not None and dump is None and not bounds_given:
            t0 = time.perf_counter()
            act_h, num_large_h, count_h = to_host(
                dc["activations"], dc["num_large"], pending["count_raw"]
            )
            timings.fetch = time.perf_counter() - t0
            self._read_events(pending, timings)
            num_clusters = int(num_large_h)
            if 1 <= num_clusters <= self.k_max:
                t0 = time.perf_counter()
                annotation = self._decode(pending, act_h.astype(np.float32), num_clusters, count_h)
                timings.clustering = time.perf_counter() - t0
                return annotation
            # no cluster (the host's dendrogram search must run) or more than
            # k_max: the host route below, from the still resident embeddings

        t0 = time.perf_counter()
        rows = num_chunks * seg_cfg.num_speakers
        to_fetch = [pending["emb"], pending["too_short"], pending["inactive"]]
        if dump is not None:
            to_fetch += [
                pending["count_raw"],
                pending["segmentations"][:num_chunks],
                pending["binarized"][:num_chunks],
            ]
        fetched = to_host(*to_fetch)
        inactive_h = fetched[2][:num_chunks]
        embeddings = finalize_embeddings(
            fetched[0][:rows], fetched[1][:rows], num_chunks, seg_cfg.num_speakers
        )
        timings.fetch = time.perf_counter() - t0
        self._read_events(pending, timings)

        if dump is not None:
            count = np.rint(fetched[3][: pending["real_plan"].num_frames]).astype(np.int64)
            dump.dump("embeddings", embeddings)
            dump.dump("segmentations", fetched[4])
            dump.dump("binarized_segmentations", fetched[5])
            dump.dump("count", count)
            t0 = time.perf_counter()
            annotation = self.finalize(
                fetched[4],
                fetched[5],
                embeddings,
                count,
                pending["count_frames"],
                pending["chunk_frames"],
                num_speakers=num_speakers,
                min_speakers=min_speakers,
                max_speakers=max_speakers,
                dump=dump,
                inactive=inactive_h,
            )
            timings.clustering = time.perf_counter() - t0
            return annotation

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

        post_events = self._events(2)
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
        activations, count_h = to_host(activations_dev, pending["count_raw"])
        if post_events:
            timings.post_ms = post_events[0].elapsed_time(post_events[1])
        annotation = self._decode(pending, activations, num_clusters, count_h)
        timings.clustering = time.perf_counter() - t0
        return annotation

    @staticmethod
    def _wait(events, i: int) -> None:
        """Wait for the card to pass ``events[i]`` (a profiled dispatch's
        stage boundary; nothing on the CPU). These are the only host waits
        a dispatch makes by design, so a sync debug mode set around the
        dispatch is lifted for them alone."""
        if not events:
            return
        previous = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            events[i].synchronize()
        finally:
            torch.cuda.set_sync_debug_mode(previous)

    @staticmethod
    def _read_events(pending, timings: StageTimings) -> None:
        """Device ms of the request's stages, once the card has run them
        (stage3_ms is about 0 when stage 3 took the host route)."""
        events = pending.get("events")
        if events:
            timings.stage1_ms = events[0].elapsed_time(events[1])
            timings.stage2_ms = events[1].elapsed_time(events[2])
            timings.stage3_ms = events[2].elapsed_time(events[3])

    def _decode(self, pending, activations: np.ndarray, num_clusters: int, count_h: np.ndarray):
        """Host (frames, K) activations and the raw speaker count -> turns."""
        cfg = self.config
        seg_cfg = cfg.segmentation
        real_dia_plan = self._diarization_plan(pending["num_chunks"])
        activations = activations[: real_dia_plan.num_frames, :num_clusters]
        count = np.rint(count_h[: pending["real_plan"].num_frames]).astype(np.int64)
        binary, binary_frames = rec.binarize_by_count(
            activations, real_dia_plan.frames, count, pending["count_frames"]
        )
        return rec.to_annotation(
            binary,
            binary_frames,
            onset=cfg.clustering.binarize_onset,
            offset=cfg.clustering.binarize_offset,
            min_duration_on=seg_cfg.min_duration_on,
            min_duration_off=seg_cfg.min_duration_off,
        )

    # ------------------------------------------------------------------
    # stages 1 and 2 on a chunk range
    # ------------------------------------------------------------------

    def _range_inputs(self, waveform_slice, num_chunks, orphan_frames, orphan_samples):
        """Host inputs of a chunk range: (num_padded, wav_padded,
        valid_frames, valid_samples); chunk i is samples [i * step, i * step
        + window) of ``waveform_slice``."""
        seg_cfg = self.config.segmentation
        num_padded = self.chunk_lattice(num_chunks)
        needed = (num_padded - 1) * seg_cfg.step_size + seg_cfg.window_size
        wav_padded = np.zeros(needed, dtype=np.float32)
        wav_padded[: waveform_slice.shape[0]] = waveform_slice
        valid_frames = np.zeros(num_padded, dtype=np.int32)
        valid_frames[:num_chunks] = seg_cfg.num_frames
        valid_samples = np.zeros(num_padded, dtype=np.int32)
        valid_samples[:num_chunks] = seg_cfg.window_size
        if orphan_frames is not None:
            valid_frames[num_chunks - 1] = orphan_frames
        if orphan_samples is not None and orphan_samples < seg_cfg.window_size:
            valid_samples[num_chunks - 1] = orphan_samples
        return num_padded, wav_padded, valid_frames, valid_samples

    @torch.inference_mode()
    def _run_range(
        self, waveform_slice, num_chunks, orphan_frames, orphan_samples, with_internals=False
    ):
        """Stages 1 and 2 of a chunk range, launched without waiting:
        (segs, binarized, inactive, valid_frames (host), stage-2 outputs)."""
        seg_cfg = self.config.segmentation
        num_padded, wav_padded, valid_frames, valid_samples = self._range_inputs(
            waveform_slice, num_chunks, orphan_frames, orphan_samples
        )
        with precision_scope(self.precision):
            chunks = win.device_chunks(
                self._to_device(wav_padded), num_padded, seg_cfg.window_size, seg_cfg.step_size
            )
            segs, binarized, chosen, _, inactive = self._stage1(
                chunks, valid_frames, valid_samples
            )
            return segs, binarized, inactive, valid_frames, self._stage2(
                chunks, chosen, with_internals
            )

    def run_chunks(
        self,
        waveform_slice: np.ndarray,
        num_chunks: int,
        orphan_frames: Optional[int] = None,
        orphan_samples: Optional[int] = None,
    ):
        """Stages 1 and 2 on a contiguous chunk range.

        ``waveform_slice`` holds the samples of chunks [0, num_chunks) of the
        range; ``orphan_frames`` gives the last chunk's valid model frames
        when it is the recording's short tail, and ``orphan_samples`` its
        true sample count. Returns host arrays: segs (n, F, S), binarized
        (n, F, S) and embeddings (n, S, D) float64 with NaN rows for
        too-short masks. The building block of long-form and streaming, and
        of the differential dumps."""
        seg_cfg = self.config.segmentation
        S = seg_cfg.num_speakers
        if num_chunks == 0:
            F = seg_cfg.num_frames
            return (
                np.zeros((0, F, S), np.float32),
                np.zeros((0, F, S), np.float32),
                np.zeros((0, S, self.ecapa_cfg.emb_dim), np.float64),
            )
        segs, binarized, _, _, (emb, too_short) = self._run_range(
            waveform_slice, num_chunks, orphan_frames, orphan_samples
        )
        rows = num_chunks * S
        segs_h, bin_h, emb_h, too_short_h = to_host(
            segs[:num_chunks], binarized[:num_chunks], emb[:rows], too_short[:rows]
        )
        return segs_h, bin_h, finalize_embeddings(emb_h, too_short_h, num_chunks, S)

    def run_chunks_device(
        self,
        waveform_slice: np.ndarray,
        num_chunks: int,
        orphan_frames: Optional[int] = None,
        orphan_samples: Optional[int] = None,
        fetch: bool = True,
    ):
        """Like ``run_chunks``, but the score tensors stay on the device.
        Returns (segs (padded, F, S), binarized (padded, F, S) on the device,
        valid_frames (padded,) host, embeddings (n, S, D) float64 host with
        NaN rows, inactive (n, S) bool host). ``fetch=False`` waits for
        nothing and returns (segs, binarized, valid_frames, emb (rows, D),
        too_short (rows,), inactive (padded, S)), all but valid_frames on
        the device, so a caller can launch more ranges before it fetches."""
        segs, binarized, inactive, valid_frames, (emb, too_short) = self._run_range(
            waveform_slice, num_chunks, orphan_frames, orphan_samples
        )
        if not fetch:
            return segs, binarized, valid_frames, emb, too_short, inactive
        emb_h, too_short_h, inactive_h = to_host(emb, too_short, inactive)
        embeddings = finalize_embeddings(
            emb_h, too_short_h, num_chunks, self.config.segmentation.num_speakers
        )
        return segs, binarized, valid_frames, embeddings, inactive_h[:num_chunks]

    def stage2_internals(
        self,
        waveform: np.ndarray,
        num_chunks: int,
        orphan_frames: Optional[int] = None,
        orphan_samples: Optional[int] = None,
    ):
        """(signals (rows, window), wav_lens (rows,)) of the real rows, as
        the production stage 2 computed them (pack kernel, length step, same
        orphan handling as ``run_chunks``), fetched to the host: the
        provenance of the differential dumps' stage-2 tensors."""
        _, _, _, _, (_, _, signals, wav_lens) = self._run_range(
            waveform, num_chunks, orphan_frames, orphan_samples, with_internals=True
        )
        rows = num_chunks * self.config.segmentation.num_speakers
        return tuple(to_host(signals[:rows], wav_lens[:rows]))

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
        dump=None,
        inactive: Optional[np.ndarray] = None,
        clusterer=None,
    ) -> Annotation:
        """Stage 3 on host arrays: cluster embeddings, reconstruct the
        global timeline, decode turns. ``dump``: an optional DumpSession for
        the clustering and reconstruction intermediates. ``inactive``
        (chunks, speakers) bool marks locally-silent speakers; derived from
        ``binarized`` when not given. ``clusterer`` overrides self.clusterer
        for one call."""
        cfg = self.config
        seg_cfg = cfg.segmentation
        clusterer = clusterer or self.clusterer
        cluster_kwargs = {}
        if dump is not None and isinstance(clusterer, AgglomerativeClustering):
            cluster_kwargs["dump"] = dump
        hard, soft = clusterer(
            embeddings,
            num_clusters=num_speakers or cfg.num_speakers,
            min_clusters=min_speakers or cfg.min_speakers,
            max_clusters=max_speakers or cfg.max_speakers,
            **cluster_kwargs,
        )
        if inactive is None:
            inactive = binarized.sum(axis=1) == 0
        hard = np.asarray(hard)
        hard[inactive] = -2
        if dump is not None:
            dump.dump("hard_clusters", hard)
            dump.dump("soft_clusters", soft)
        discrete, discrete_frames = rec.reconstruct(
            segmentations, chunk_frames, hard, count, count_frames, dump=dump
        )
        if dump is not None:
            dump.dump("discrete_diarization", discrete)
        return rec.to_annotation(
            discrete,
            discrete_frames,
            onset=cfg.clustering.binarize_onset,
            offset=cfg.clustering.binarize_offset,
            min_duration_on=seg_cfg.min_duration_on,
            min_duration_off=seg_cfg.min_duration_off,
        )
