"""The port's pipeline against the JAX pipeline on the small5s configuration
(the real 5 s / 0.5 s recipe and frame grid, small model widths) with the
in-repo gate checkpoint's weights. Same checks as test_torch_pipeline.py
(stage-isolated, then end to end)."""

import dataclasses
import os

import pytest

from pyannote_audio_speaker_diarization_cpp_tpu.config import DEFAULT_CONFIG
from pyannote_audio_speaker_diarization_cpp_tpu.models.convert import load_checkpoint
from test_torch_pipeline import (
    build_pair,
    check_collect,
    check_end_to_end,
    check_finalize,
    check_post_process,
    check_stage1,
    check_stage2,
    run_stages,
    synth_audio,
)

GATE_CKPT = os.path.join(os.path.dirname(__file__), "goldens", "gate_ckpt")
SMALL5S_CFG = dataclasses.replace(DEFAULT_CONFIG, chunk_bucket=4)
ONSET = SMALL5S_CFG.segmentation.onset


@pytest.fixture(scope="module")
def small5s():
    jp, tp = build_pair(SMALL5S_CFG, batch=4, params=load_checkpoint(GATE_CKPT))
    audio = synth_audio(12.3)  # 15 complete windows + a short orphan
    return jp, tp, audio, run_stages(jp, tp, audio)


def test_small5s_stage1_close(small5s):
    check_stage1(small5s[3], ONSET)


def test_small5s_post_process_exact(small5s):
    check_post_process(small5s[1], small5s[3])


def test_small5s_stage2_from_jax_masks(small5s):
    check_stage2(small5s[1], small5s[3])


def test_small5s_collect_from_jax_outputs(small5s):
    check_collect(*small5s[:3])


def test_small5s_finalize_from_jax_outputs(small5s):
    check_finalize(*small5s[:3])


def test_small5s_end_to_end_turns(small5s):
    check_end_to_end(*small5s[:3], ONSET)
