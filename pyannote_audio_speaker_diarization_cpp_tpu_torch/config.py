"""Typed configuration for the PyTorch/CUDA speaker-diarization pipeline.

The reference hard-codes every hyper-parameter as scattered C++ globals/locals
(see reference pipeline/src/speakerDiarizer.cpp:39-45, :1335-1340, :2044-2050,
:2429-2432). Here they live in one frozen dataclass whose defaults reproduce the
pyannote/speaker-diarization v2.x recipe exactly (SURVEY.md section 2.4).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """STFT + mel filterbank + per-sentence normalization settings.

    Matches the speechbrain feature extraction re-implemented by the reference
    (reference embeddings/threeModel.py:7-76, :292-396): 16 kHz, 25 ms hamming
    window, 10 ms hop, n_fft 400, onesided, centered with constant (zero)
    padding, power spectrum, 80 triangular mel filters, log-mel in dB with
    top_db clamping, then per-sentence mean subtraction (std untouched).
    """

    sample_rate: int = 16000
    win_length_ms: float = 25.0
    hop_length_ms: float = 10.0
    n_fft: int = 400
    n_mels: int = 80
    f_min: float = 0.0
    f_max: float = 8000.0
    power_spectrogram: float = 2.0
    amin: float = 1e-10
    ref_value: float = 1.0
    top_db: float = 80.0
    norm_eps: float = 1e-10

    @property
    def win_length(self) -> int:
        return int(round(self.sample_rate / 1000.0 * self.win_length_ms))

    @property
    def hop_length(self) -> int:
        return int(round(self.sample_rate / 1000.0 * self.hop_length_ms))

    @property
    def num_freqs(self) -> int:
        return self.n_fft // 2 + 1


@dataclasses.dataclass(frozen=True)
class SegmentationConfig:
    """Sliding-window segmentation settings.

    Reference: pipeline/src/speakerDiarizer.cpp:1335-1340 and
    segment/segment.py:23-48.
    """

    duration: float = 5.0  # seconds per window
    step: float = 0.5  # window hop in seconds
    batch_size: int = 32
    sample_rate: int = 16000
    num_frames: int = 293  # PyanNet output frames for a 5 s window
    num_speakers: int = 3  # local speakers per chunk
    # pyannote/speaker-diarization config.yaml value, copied verbatim by the
    # reference (speakerDiarizer.cpp:1339).
    onset: float = 0.4442333667381752
    offset: float = 0.4442333667381752
    min_duration_off: float = 0.5817029604921046
    min_duration_on: float = 0.0
    # Warm-up trim fraction used by speaker_count (speakerDiarizer.cpp:1693).
    warm_up: Tuple[float, float] = (0.1, 0.1)
    # Output frame grid of PyanNet: 270 samples per frame
    # (speakerDiarizer.cpp:2430-2432).
    frame_step: float = 0.016875
    frame_duration: float = 0.016875
    frame_start: float = 0.0

    @property
    def window_size(self) -> int:
        return round(self.duration * self.sample_rate)

    @property
    def step_size(self) -> int:
        return round(self.step * self.sample_rate)


@dataclasses.dataclass(frozen=True)
class EmbeddingConfig:
    """Speaker-embedding stage settings.

    Reference: pipeline/src/speakerDiarizer.cpp:44, :2429, segment/segment.py:31.
    """

    batch_size: int = 32
    dimension: int = 192
    # minimum number of samples required to extract an embedding
    min_num_samples: int = 640
    sample_rate: int = 16000
    # mask binarization threshold after nearest-neighbor interpolation
    # (speakerDiarizer.cpp:2451, segment/segment.py:287)
    mask_threshold: float = 0.5


@dataclasses.dataclass(frozen=True)
class ClusteringConfig:
    """Agglomerative clustering settings.

    Reference: pipeline/src/speakerDiarizer.cpp:2044-2050 and
    clustering/Clustering.py:270-311.
    """

    method: str = "centroid"
    metric: str = "cosine"
    threshold: float = 0.7153814381597874
    min_cluster_size: int = 15
    # pyannote BaseClustering caps the AHC train set at 1000 embeddings and
    # assigns the rest to the learned centroids (Clustering.py:12-18, 69-76);
    # hour-scale audio follows pyannote semantics with this default. None
    # disables the cap (cluster on every embedding).
    max_num_embeddings: "int | None" = 1000
    # Final hysteresis decode thresholds (speakerDiarizer.cpp:3228-3229).
    binarize_onset: float = 0.5
    binarize_offset: float = 0.5


@dataclasses.dataclass(frozen=True)
class DiarizationConfig:
    """Full pipeline configuration with pyannote v2.x recipe defaults."""

    frontend: FrontendConfig = dataclasses.field(default_factory=FrontendConfig)
    segmentation: SegmentationConfig = dataclasses.field(
        default_factory=SegmentationConfig
    )
    embedding: EmbeddingConfig = dataclasses.field(default_factory=EmbeddingConfig)
    clustering: ClusteringConfig = dataclasses.field(default_factory=ClusteringConfig)
    # Optional caps on the number of speakers (reference supports min/max via
    # set_num_clusters, clustering/Clustering.py:21-43).
    num_speakers: Optional[int] = None
    min_speakers: Optional[int] = None
    max_speakers: Optional[int] = None
    # Numerics: compute dtype for the ECAPA trunk. bfloat16 (default) runs
    # the trunk's convolutions on the bf16 tensor cores and halves its
    # activation traffic; the reference's own accepted C++-vs-Python
    # embedding envelope is abs 0.02 (reference README.md:99-101). The
    # STFT/mel front-end and the returned embeddings always stay f32. Set
    # "float32" for bit-conservative runs.
    compute_dtype: str = "bfloat16"
    # Dtype of the embeddings device->host transfer. float16 (default)
    # halves the fetch; its 4.9e-4 relative rounding is 40x inside the
    # reference's own accepted embedding envelope (abs 0.02,
    # README.md:99-101). Host clustering still runs in float64 either way.
    # Set "float32" for bit-conservative runs.
    transfer_dtype: str = "float16"
    # Pad the chunk axis up to a multiple of this, so the model batches see
    # a small set of shapes across different audio lengths.
    chunk_bucket: int = 32


DEFAULT_CONFIG = DiarizationConfig()
