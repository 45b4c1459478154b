"""The port's three kernel modules against the JAX package.

On the CPU every wrapper runs its plain PyTorch version; those are held
against the Pallas kernels in interpret mode (and the jnp formulations).
test_torch_cuda.py holds each hand-written CUDA kernel against its plain
version on the card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pyannote_audio_speaker_diarization_cpp_tpu.config import FrontendConfig as JFrontendConfig
from pyannote_audio_speaker_diarization_cpp_tpu.ops import frontend as jfe
from pyannote_audio_speaker_diarization_cpp_tpu.ops import masks as jmk
from pyannote_audio_speaker_diarization_cpp_tpu.ops.asp_pallas import asp_pool_pallas
from pyannote_audio_speaker_diarization_cpp_tpu.ops.frontend_pallas import (
    log_mel_spectrogram as jlog_mel_pallas,
)
from pyannote_audio_speaker_diarization_cpp_tpu.ops.pack_pallas import pack_frames_pallas
from pyannote_audio_speaker_diarization_cpp_tpu_torch.config import FrontendConfig
from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops import asp_cuda
from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops import frontend as tfe
from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops import frontend_cuda
from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops import masks as tmk
from pyannote_audio_speaker_diarization_cpp_tpu_torch.ops import pack_cuda


# ---------------------------------------------------------------------------
# pack (kernel 1)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p_keep", [0.0, 0.3, 0.7, 1.0])
def test_pack_plain_matches_pallas_bit_exact(p_keep):
    rng = np.random.default_rng(2)
    n, F = 2000, 29
    wav = rng.normal(size=(4, n)).astype(np.float32)
    m = (rng.uniform(size=(4, F)) < p_keep).astype(np.float32)
    want, want_lens = pack_frames_pallas(jnp.asarray(wav), jnp.asarray(m), n, interpret=True)
    got, lens = pack_cuda.pack_frames(torch.from_numpy(wav), torch.from_numpy(m) > 0.5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(lens.numpy(), np.asarray(want_lens))
    # and the sample-level definition: upsample the mask, then left-pack
    imasks = (jmk.interpolate_nearest(jnp.asarray(m), n) > 0.5).astype(np.float32)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jmk.left_pack(jnp.asarray(wav), imasks))
    )


def test_pack_and_lengths_matches_jax():
    rng = np.random.default_rng(3)
    n, F = 80000, 293
    wav = rng.normal(size=(3, n)).astype(np.float32)
    masks = rng.uniform(size=(3, F)).astype(np.float32)
    masks[1] = 0.0  # too short
    masks[2, :2] = 1.0
    masks[2, 2:] = 0.0  # 2 frames: 546 samples < 640 -> too short
    j = jmk.pack_and_lengths(jnp.asarray(wav), jnp.asarray(masks), 0.5, 640, backend="jnp")
    t = tmk.pack_and_lengths(torch.from_numpy(wav), torch.from_numpy(masks), 0.5, 640)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_frame_tables_match_pallas_tables():
    from pyannote_audio_speaker_diarization_cpp_tpu.ops.pack_pallas import _frame_tables

    for F, n in [(293, 80000), (29, 2000), (56, 16000), (17, 1600)]:
        run_len, orig_start = pack_cuda.frame_tables(F, n)
        want_len, want_start = _frame_tables(F, n)
        np.testing.assert_array_equal(run_len.numpy(), want_len)
        np.testing.assert_array_equal(orig_start.numpy(), want_start)


# ---------------------------------------------------------------------------
# log-mel front-end (kernel 2)
# ---------------------------------------------------------------------------


def test_frontend_constants_equal():
    jc, tc = JFrontendConfig(), FrontendConfig()
    np.testing.assert_array_equal(
        jfe.dft_basis(jc.n_fft, jc.win_length), tfe.dft_basis(tc.n_fft, tc.win_length)
    )
    np.testing.assert_array_equal(jfe.mel_filterbank(jc), tfe.mel_filterbank(tc))


def test_log_mel_plain_matches_pallas():
    cfg = FrontendConfig()
    x = np.random.default_rng(0).normal(size=(2, 16000)).astype(np.float32)
    want = np.asarray(jlog_mel_pallas(jnp.asarray(x), JFrontendConfig(), interpret=True))
    basis, mel = tfe.constants(cfg, torch.device("cpu"))
    mult, db_off = tfe._db_terms(cfg)
    got = frontend_cuda.log_mel_spectrogram(
        torch.from_numpy(x), basis, mel, cfg.hop_length, cfg.amin, mult, db_off
    ).numpy()
    assert got.shape == want.shape == (2, 101, 80)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


def test_compute_features_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 32000)).astype(np.float32)
    x[2, 9000:] = 0.0  # a packed row's zero tail
    lens = np.asarray([1.0, 0.6, 0.25], np.float32)
    want = np.asarray(jfe.compute_features(jnp.asarray(x), jnp.asarray(lens), JFrontendConfig()))
    got = tfe.compute_features(torch.from_numpy(x), torch.from_numpy(lens), FrontendConfig())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)
    # the unfused chain (stft_power -> log_mel) too
    power_j = np.asarray(jfe.stft_power(jnp.asarray(x), JFrontendConfig()))
    power_t = tfe.stft_power(torch.from_numpy(x), FrontendConfig()).numpy()
    np.testing.assert_allclose(power_t, power_j, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(
        tfe.log_mel(torch.from_numpy(power_j.copy()), FrontendConfig()).numpy(),
        np.asarray(jfe.log_mel(jnp.asarray(power_j), JFrontendConfig())),
        rtol=1e-4,
        atol=1e-3,
    )


# ---------------------------------------------------------------------------
# ASP tail (kernel 3)
# ---------------------------------------------------------------------------


def _asp_inputs(B, A, C, T, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, C, T)).astype(np.float32)
    a = np.tanh(rng.normal(size=(B, A, T))).astype(np.float32)
    w = (rng.normal(size=(C, A)) * 0.1).astype(np.float32)
    b = (rng.normal(size=(C,)) * 0.1).astype(np.float32)
    lens = rng.uniform(0.3, 1.0, B).astype(np.float32)
    mask = (np.arange(T)[None, :] < (lens * T)[:, None]).astype(np.float32)
    return x, a, w, b, mask


def _asp_jnp(x, a, w, b, mask, eps=1e-12):
    s = jnp.einsum("ca,bat->bct", w, a, precision=jax.lax.Precision.HIGHEST) + b[None, :, None]
    s = jnp.where(jnp.asarray(mask)[:, None, :] == 0, -jnp.inf, s)
    p = jax.nn.softmax(s, axis=2)
    mean = jnp.sum(p * x, axis=2)
    std = jnp.sqrt(jnp.maximum(jnp.sum(p * x * x, axis=2) - mean**2, eps))
    return np.asarray(mean), np.asarray(std)


def test_asp_plain_matches_pallas():
    x, a, w, b, mask = _asp_inputs(4, 32, 256, 97, seed=5)
    want_mean, want_std = asp_pool_pallas(
        jnp.asarray(x), jnp.asarray(a), jnp.asarray(w), jnp.asarray(b), jnp.asarray(mask),
        interpret=True,
    )
    mean, std = asp_cuda.asp_pool(*(torch.from_numpy(v) for v in (x, a, w, b, mask)))
    np.testing.assert_allclose(mean.numpy(), np.asarray(want_mean), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(std.numpy(), np.asarray(want_std), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("C", [100, 200])
def test_asp_plain_any_channel_count_matches_jnp(C):
    """The Pallas kernel needs C % 128 == 0; the port takes any C."""
    x, a, w, b, mask = _asp_inputs(3, 16, C, 61, seed=C)
    want_mean, want_std = _asp_jnp(*(jnp.asarray(v) for v in (x, a, w, b)), mask)
    mean, std = asp_cuda.asp_pool(*(torch.from_numpy(v) for v in (x, a, w, b, mask)))
    np.testing.assert_allclose(mean.numpy(), want_mean, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(std.numpy(), want_std, rtol=1e-4, atol=1e-5)


def test_wrappers_reject_bad_input():
    with pytest.raises(ValueError):
        pack_cuda.pack_frames(torch.zeros(3, 10), torch.zeros(2, 5, dtype=torch.bool))
    with pytest.raises(ValueError):
        asp_cuda.asp_pool(
            torch.zeros(2, 8, 5), torch.zeros(2, 4, 5), torch.zeros(8, 3),
            torch.zeros(8), torch.ones(2, 5),
        )
