"""Embedding front-end: STFT -> power -> mel -> log-dB -> per-sentence mean
normalization.

This replaces the reference's embedding front-end — its published bottleneck:
libtorch ``torch::stft`` in float64 plus four host<->device tensor copies per
batch (reference pipeline/src/speakerDiarizer.cpp:1977-2040, README.md:104-110).
The exact math being reproduced is speechbrain's feature extraction as pinned
down by the reference exporters (embeddings/threeModel.py:7-76 MySTFT/FBank,
:292-396 MyNormalization).

A length-400 real DFT is a (400, 402) matrix with the window folded in, so
the STFT is frame extraction plus one product and the mel projection is a
second one. ``compute_features`` runs the fused log-mel kernel
(ops/frontend_cuda.py: on the card the DFT product runs on the tensor cores
in 3xTF32, as accurate as float32, and the mel projection sums each band's
own bins; bound by the TF32 operations, 0.031 ms a 32-row batch on an H100)
and keeps only the per-row epilogue (top_db clamp, mean-norm) as torch ops.
``stft_power`` and ``log_mel`` are the unfused
formulation, kept for parity with the JAX package's module and its tests;
no pipeline path calls them.
Everything is float32 (the reference's float64 STFT is gratuitous: its own
verification tolerances are rtol 1e-3).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import FrontendConfig
from . import frontend_cuda


def hamming_window(win_length: int) -> np.ndarray:
    """Periodic hamming window, matching torch.hamming_window(N) defaults
    (periodic=True, alpha=0.54, beta=0.46)."""
    n = np.arange(win_length)
    return 0.54 - 0.46 * np.cos(2.0 * np.pi * n / win_length)


def dft_basis(n_fft: int, win_length: int) -> np.ndarray:
    """(win_length, 2*(n_fft//2+1)) windowed real-DFT basis.

    Column k is cos(2 pi k n / n_fft) * w[n]; columns n_fft//2+1.. are the
    matching -sin rows, i.e. an unnormalized onesided STFT with
    return_complex=False packed as [real | imag].
    """
    k = np.arange(n_fft // 2 + 1)
    n = np.arange(win_length)
    angle = 2.0 * np.pi * np.outer(n, k) / n_fft
    w = hamming_window(win_length)[:, None]
    return np.concatenate([np.cos(angle) * w, -np.sin(angle) * w], axis=1)


def mel_filterbank(cfg: FrontendConfig) -> np.ndarray:
    """(num_freqs, n_mels) triangular mel filters, speechbrain-style.

    Triangles are symmetric in Hz with half-width equal to the spacing to the
    previous mel point (speechbrain Filterbank as invoked at
    embeddings/threeModel.py:73-75 with n_mels=80 and defaults).
    """

    def to_mel(hz):
        return 2595.0 * np.log10(1.0 + hz / 700.0)

    def to_hz(mel):
        return 700.0 * (10.0 ** (mel / 2595.0) - 1.0)

    mel_pts = np.linspace(to_mel(cfg.f_min), to_mel(cfg.f_max), cfg.n_mels + 2)
    hz = to_hz(mel_pts)
    band = (hz[1:] - hz[:-1])[:-1]  # (n_mels,)
    f_central = hz[1:-1]  # (n_mels,)
    all_freqs = np.linspace(0, cfg.sample_rate // 2, cfg.num_freqs)
    slope = (all_freqs[:, None] - f_central[None, :]) / band[None, :]
    return np.maximum(0.0, np.minimum(slope + 1.0, -slope + 1.0))


@functools.lru_cache(maxsize=8)
def constants(cfg: FrontendConfig, device: torch.device):
    """(basis, mel) float32 tensors on ``device`` (built once per config)."""
    basis = dft_basis(cfg.n_fft, cfg.win_length).astype(np.float32)
    mel = mel_filterbank(cfg).astype(np.float32)
    return torch.from_numpy(basis).to(device), torch.from_numpy(mel).to(device)


def _db_terms(cfg: FrontendConfig) -> tuple[float, float]:
    """(multiplier, db offset) of the dB conversion."""
    mult = 10.0 if cfg.power_spectrogram == 2 else 20.0
    return mult, float(mult * np.log10(max(cfg.amin, cfg.ref_value)))


def stft_power(x: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """(batch, num_samples) waveforms -> (batch, frames, num_freqs) power.

    Centered, constant(zero)-padded, unnormalized, onesided — the torch.stft
    configuration at speakerDiarizer.cpp:1980-2008 — followed by
    speechbrain.spectral_magnitude(power=1) == |X|^2.
    """
    if cfg.win_length != cfg.n_fft:
        raise ValueError("the front-end expects win_length == n_fft")
    basis, _ = constants(cfg, x.device)
    return frontend_cuda.stft_power_plain(x, basis, cfg.hop_length)


def log_mel(power: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """(batch, frames, num_freqs) power -> (batch, frames, n_mels) log-mel dB.

    speechbrain Filterbank: mel projection, 10*log10, then clamp each batch
    item to its max minus top_db.
    """
    _, mel = constants(cfg, power.device)
    mult, db_off = _db_terms(cfg)
    x_db = mult * torch.log10(torch.clamp(power @ mel, min=cfg.amin)) - db_off
    return top_db_clamp(x_db, cfg.top_db)


def top_db_clamp(x_db: torch.Tensor, top_db: float) -> torch.Tensor:
    """Clamp each batch item to its own max minus ``top_db``."""
    x_max = torch.amax(x_db, dim=(-2, -1), keepdim=True)
    return torch.maximum(x_db, x_max - top_db)


def sentence_mean_norm(feats: torch.Tensor, wav_lens: torch.Tensor) -> torch.Tensor:
    """Per-sentence mean subtraction over the first round(rel_len*T) frames.

    Matches MyNormalization (embeddings/threeModel.py:292-396): the mean is
    computed over the non-padded frames only (torch.round is half-to-even,
    like np.rint) but subtracted from every frame; std is left at 1.
    """
    seq_len = feats.shape[1]
    actual = torch.round(wav_lens * seq_len)
    frame_idx = torch.arange(seq_len, device=feats.device)[None, :, None]
    valid = (frame_idx < actual[:, None, None]).to(feats.dtype)
    denom = torch.clamp(valid.sum(dim=1, keepdim=True), min=1.0)
    mean = (feats * valid).sum(dim=1, keepdim=True) / denom
    return feats - mean


def compute_features(
    x: torch.Tensor, wav_lens: torch.Tensor, cfg: FrontendConfig
) -> torch.Tensor:
    """Full front-end: waveforms -> normalized log-mel features.

    (batch, num_samples), (batch,) -> (batch, frames, n_mels). The log-mel
    runs fused (ops/frontend_cuda.py); the top_db clamp and the mean-norm
    are the per-row epilogue.
    """
    if cfg.win_length != cfg.n_fft:
        raise ValueError("the fused front-end expects win_length == n_fft")
    basis, mel = constants(cfg, x.device)
    mult, db_off = _db_terms(cfg)
    x_db = frontend_cuda.log_mel_spectrogram(
        x, basis, mel, cfg.hop_length, float(cfg.amin), mult, db_off
    )
    return sentence_mean_norm(top_db_clamp(x_db, cfg.top_db), wav_lens)
