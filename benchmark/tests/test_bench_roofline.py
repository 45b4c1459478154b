"""The yardstick's arithmetic against hand counts at the cells' shapes."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from benchmark import roofline

ROOT = Path(__file__).resolve().parents[2]
CFG = json.loads((ROOT / "benchmark" / "configs" / "pyannote-v2.1.json").read_text())


def test_bench_pyannet_flops_by_hand():
    # 80000 samples: sinc conv to 7975, pools and 5-tap convs to 2654 and
    # 880, 293 frames; 4 BiLSTM layers of 128 (inputs 60, then 256)
    hand = (
        2 * 7975 * 1 * 80 * 251
        + 2 * 2654 * 80 * 60 * 5
        + 2 * 880 * 60 * 60 * 5
        + 2 * 293 * 2 * (60 + 128) * 4 * 128
        + 3 * 2 * 293 * 2 * (256 + 128) * 4 * 128
        + 2 * 293 * 256 * 128
        + 2 * 293 * 128 * 128
        + 2 * 293 * 128 * 3
    )
    assert roofline.pyannet_flops(80000, CFG["pyannet"]) == hand


def test_bench_ecapa_flops_by_hand():
    T = 501  # 80000 samples at a 160-sample hop, centred
    hand = 2 * T * 80 * 1024 * 5
    for _ in range(3):
        hand += 2 * T * 1024 * 1024  # tdnn1
        hand += 7 * 2 * T * 128 * 128 * 3  # res2net, 8 splits of 128
        hand += 2 * T * 1024 * 1024  # tdnn2
        hand += 2 * 1024 * 128 * 2  # SE on the pooled vector
    hand += 2 * T * 3072 * 3072  # MFA
    hand += 2 * T * 3072 * 128 + 2 * 2 * 3072 * 128  # attention TDNN, context parts
    hand += 2 * T * 128 * 3072  # attention expansion
    hand += 2 * 6144 * 192  # fc
    assert roofline.ecapa_flops(T, CFG["ecapa"]) == hand


def test_bench_flops_match_the_programs_count():
    """The frozen copy counts what the program's utils/flops.py counts."""
    pytest.importorskip("torch")
    from pyannote_audio_speaker_diarization_cpp_tpu_torch.utils import flops

    assert roofline.pyannet_flops(80000, CFG["pyannet"]) == flops.pyannet_flops(80000)
    assert roofline.ecapa_flops(501, CFG["ecapa"]) == flops.ecapa_flops(501)


def test_bench_log_mel_bound_by_hand():
    # 32 rows of 80000 samples, 501 frames: the DFT product (400 x 402) as
    # three TF32 products and the mel projection over its nonzeros; bound
    # by the operations (0.03145 ms in the program's kernel table)
    from benchmark.reference.stages import mel_filterbank

    nnz = int((mel_filterbank(CFG["frontend"], 16000) != 0).sum())
    ops = 3 * 2.0 * 32 * 501 * 400 * 402 / 494.7e12 + 2.0 * 32 * 501 * nnz / 67e12
    got = roofline.log_mel_bound_s(32, 80000, 501, 400, 80, nnz)
    assert got == pytest.approx(ops, rel=1e-12)
    assert got * 1e3 == pytest.approx(0.03145, rel=5e-3)


def test_bench_asp_bound_by_hand():
    # every frame valid: x and a_tanh read (bf16), W (3072 x 128) once,
    # mean and std written; bias and the float32 mask read
    valid = 32 * 501
    nbytes = 2 * (valid * (3072 + 128) + 3072 * 128 + 2 * 32 * 3072) + 4 * (3072 + 32 * 501)
    flops = 2.0 * 3072 * 128 * valid
    want = max(nbytes / 3.35e12, flops / 989e12)
    assert roofline.asp_bound_s(valid, 32, 501, 3072, 128, "bfloat16") == pytest.approx(want)
    f32 = max(2 * nbytes / 3.35e12 - 4 * (3072 + 32 * 501) / 3.35e12, 3 * flops / 494.7e12)
    assert roofline.asp_bound_s(valid, 32, 501, 3072, 128, "float32") == pytest.approx(f32)


def test_bench_recording_flops_counts_real_windows_only():
    one = roofline.recording_flops(1, CFG)
    assert one == roofline.pyannet_flops(80000, CFG["pyannet"]) + 3 * roofline.ecapa_flops(
        501, CFG["ecapa"])
    assert roofline.recording_flops(10, CFG) == pytest.approx(10 * one)
