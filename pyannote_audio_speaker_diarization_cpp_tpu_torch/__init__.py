"""Speaker diarization in PyTorch, with hand-written CUDA kernels for Hopper.

The pyannote speaker-diarization v2.x recipe (PyanNet segmentation over 5 s
sliding windows, ECAPA-TDNN embeddings, centroid-linkage AHC and the timeline
decode), ported from the JAX package ``pyannote_audio_speaker_diarization_cpp_tpu``
module by module. The stage-2 hot spots (speech-sample packing, the log-mel
front-end and the attentive-statistics pooling tail) run as CUDA C++ kernels
under ``csrc/``; every other tensor op is plain PyTorch.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; on a
CPU tensor each kernel wrapper runs its plain PyTorch version instead.
"""

__version__ = "0.1.0"

from .config import (
    ClusteringConfig,
    DEFAULT_CONFIG,
    DiarizationConfig,
    EmbeddingConfig,
    FrontendConfig,
    SegmentationConfig,
)
from .core.annotation import Annotation, Turn
from .core.segment import Segment
from .core.sliding_window import SlidingWindow, SlidingWindowFeature

__all__ = [
    "Annotation",
    "ClusteringConfig",
    "DEFAULT_CONFIG",
    "DiarizationConfig",
    "EmbeddingConfig",
    "FrontendConfig",
    "Segment",
    "SegmentationConfig",
    "SlidingWindow",
    "SlidingWindowFeature",
    "Turn",
]


def __getattr__(name):
    # the pipeline pulls in torch; keep `import` of the package light
    if name == "SpeakerDiarizationPipeline":
        from .pipelines.diarization import SpeakerDiarizationPipeline

        return SpeakerDiarizationPipeline
    raise AttributeError(name)
