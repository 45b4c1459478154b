"""Each hand-written CUDA kernel against its plain PyTorch version, on the
card, at the shapes the main path gives it. Marked ``cuda``: skipped without
a CUDA device. This file imports nothing of JAX, so it also runs where JAX is
not installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from pyannote_audio_speaker_diarization_cpp_tpu_torch.config import FrontendConfig
from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops import asp_cuda
from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops import frontend as tfe
from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops import frontend_cuda
from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops import pack_cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _asp_inputs(B, A, C, T, seed, holes=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, C, T)).astype(np.float32)
    a = np.tanh(rng.normal(size=(B, A, T))).astype(np.float32)
    w = (rng.normal(size=(C, A)) * 0.1).astype(np.float32)
    b = (rng.normal(size=(C,)) * 0.1).astype(np.float32)
    lens = rng.uniform(0.3, 1.0, B).astype(np.float32)
    mask = (np.arange(T)[None, :] < (lens * T)[:, None]).astype(np.float32)
    if holes:  # invalid frames inside the length too, whole 32-frame tiles among them
        mask[:, 20:110] = 0.0
    return x, a, w, b, mask


@pytest.mark.cuda
@pytest.mark.parametrize("p_keep", [0.0, 0.3, 0.7, 1.0])
def test_pack_kernel_matches_plain(cuda, p_keep):
    rng = np.random.default_rng(7)
    wav = torch.from_numpy(rng.normal(size=(32, 80000)).astype(np.float32)).to(cuda)
    keep = torch.from_numpy(rng.uniform(size=(32, 293)) < p_keep).to(cuda)
    got, lens = pack_cuda.pack_frames(wav, keep)
    want, want_lens = pack_cuda.pack_frames_plain(wav, keep)
    assert torch.equal(got, want) and torch.equal(lens, want_lens)


@pytest.mark.cuda
def test_log_mel_kernel_matches_plain(cuda):
    cfg = FrontendConfig()
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(32, 80000)).astype(np.float32))
    x[5, 30000:] = 0.0
    basis, mel = tfe.constants(cfg, cuda)
    mult, db_off = tfe._db_terms(cfg)
    args = (x.to(cuda), basis, mel, cfg.hop_length, cfg.amin, mult, db_off)
    got = frontend_cuda.log_mel_spectrogram(*args)
    want = frontend_cuda.log_mel_spectrogram_plain(*args)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [3072, 200])
@pytest.mark.parametrize("holes", [False, True])
def test_asp_kernel_matches_plain(cuda, dtype, C, holes):
    x, a, w, b, mask = (
        torch.from_numpy(v).to(cuda)
        for v in _asp_inputs(32, 128, C, 501, seed=9, holes=holes)
    )
    x, a, w = x.to(dtype), a.to(dtype), w.to(dtype)
    mean, std = asp_cuda.asp_pool(x, a, w, b, mask)
    want_mean, want_std = asp_cuda.asp_pool_plain(x, a, w, b, mask)
    # float32: reassociation only; bf16: one bf16 rounding step of the output
    tol = dict(mean=(1e-5, 1e-5), std=(1e-4, 1e-5)) if dtype == torch.float32 else dict(
        mean=(8e-3, 1e-4), std=(8e-3, 1e-4)
    )
    torch.testing.assert_close(mean.float(), want_mean.float(), rtol=tol["mean"][0], atol=tol["mean"][1])
    torch.testing.assert_close(std.float(), want_std.float(), rtol=tol["std"][0], atol=tol["std"][1])
