"""The shared test configurations of tests/_cfg.py in the port's own
classes (the same field values), for code that must run without JAX: the
accuracy loop that chip_smoke.py runs on the card imports these."""

from pyannote_audio_speaker_diarization_cpp_tpu_torch.config import (
    DiarizationConfig,
    SegmentationConfig,
)
from pyannote_audio_speaker_diarization_cpp_tpu_torch.models.ecapa import EcapaConfig
from pyannote_audio_speaker_diarization_cpp_tpu_torch.models.pyannet import (
    PyanNetConfig,
    pyannet_num_frames,
)

SMALL_PYANNET = PyanNetConfig(
    num_filters=32, conv_channels=16, lstm_hidden=16, lstm_layers=2, linear_hidden=16
)
SMALL_ECAPA = EcapaConfig(
    in_channels=80,
    channels=(64, 64, 64, 64, 128),
    attention_channels=16,
    se_channels=16,
    emb_dim=32,
)

# 1 s / 0.5 s windows
TINY1S_CFG = DiarizationConfig(
    segmentation=SegmentationConfig(
        duration=1.0, step=0.5, batch_size=8, num_frames=pyannet_num_frames(16000)
    ),
    chunk_bucket=8,
)


def make_tiny1s_pipeline(seed: int = 0, **kwargs):
    """The port's tiny1s pipeline (SMALL widths, batches of 8); pass
    ``device="cpu"`` to run it on the CPU."""
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.pipelines.diarization import (
        SpeakerDiarizationPipeline,
    )

    kwargs.setdefault("seg_batch", 8)
    kwargs.setdefault("emb_batch", 8)
    return SpeakerDiarizationPipeline(
        TINY1S_CFG,
        seed=seed,
        pyannet_cfg=SMALL_PYANNET,
        ecapa_cfg=SMALL_ECAPA,
        **kwargs,
    )
