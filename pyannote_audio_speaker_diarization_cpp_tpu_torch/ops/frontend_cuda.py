"""Log-mel spectrogram (STFT -> power -> mel -> dB): CUDA kernel wrapper and
plain version.

Replaces the TPU kernel ``log_mel_spectrogram`` (JAX package
ops/frontend_pallas.py). The kernel is ``csrc/frontend.cu``; its header says
what bounds it on the H100 (float32 operations) and how it is laid out. Like
the TPU kernel, it stops before the per-row top_db clamp; ``ops.frontend.
compute_features`` applies the clamp and the sentence mean-norm.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _cuda_lib


def num_stft_frames(num_samples: int, hop_length: int) -> int:
    """Frame count of a centered STFT: 1 + floor(L / hop)."""
    return 1 + num_samples // hop_length


def stft_power_plain(x: torch.Tensor, basis: torch.Tensor, hop: int) -> torch.Tensor:
    """(B, n) -> (B, frames, nf) power of the centered STFT: frames of the
    signal zero-padded by win/2 on each side, times the (win, 2 nf)
    windowed DFT basis, then re^2 + im^2. Products in float32."""
    win = basis.shape[0]
    nf = basis.shape[1] // 2
    frames = num_stft_frames(x.shape[-1], hop)
    pad = win // 2
    total = (frames - 1) * hop + win
    xp = F.pad(x, (pad, total - pad - x.shape[-1]))
    spec = xp.unfold(-1, win, hop) @ basis  # (B, frames, 2 nf)
    return spec[..., :nf] ** 2 + spec[..., nf:] ** 2


def log_mel_spectrogram_plain(
    x: torch.Tensor,
    basis: torch.Tensor,
    mel: torch.Tensor,
    hop: int,
    amin: float,
    mult: float,
    db_off: float,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, same contract as
    ``log_mel_spectrogram``: STFT power, mel projection, dB."""
    fb = stft_power_plain(x, basis, hop) @ mel
    return mult * torch.log10(torch.clamp(fb, min=amin)) - db_off


def log_mel_spectrogram(
    x: torch.Tensor,
    basis: torch.Tensor,
    mel: torch.Tensor,
    hop: int,
    amin: float,
    mult: float,
    db_off: float,
) -> torch.Tensor:
    """(B, n) float32 waveforms -> (B, frames, n_mels) float32 log-mel dB,
    before the top_db clamp. ``basis`` is the (win, 2 nf) windowed real-DFT
    basis (win == n_fft, centered framing), ``mel`` the (nf, n_mels)
    filterbank.

    On a CUDA tensor this launches ``csrc/frontend.cu``; on a CPU tensor it
    runs ``log_mel_spectrogram_plain``.
    """
    if x.dim() != 2 or basis.dim() != 2 or mel.dim() != 2:
        raise ValueError("log_mel_spectrogram wants (B, n), (win, 2nf), (nf, n_mels)")
    if x.device.type == "cpu":
        return log_mel_spectrogram_plain(x, basis, mel, hop, amin, mult, db_off)
    if x.device.type != "cuda" or basis.device != x.device or mel.device != x.device:
        raise ValueError(
            f"log_mel_spectrogram: tensors on {x.device}, {basis.device}, {mel.device}"
        )
    for name, t in (("x", x), ("basis", basis), ("mel", mel)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"log_mel_spectrogram: {name} must be contiguous float32")
    batch, n = x.shape
    win, ncol = basis.shape
    nf, n_mels = mel.shape
    threads = -(-ncol // 32) * 32
    if ncol != 2 * nf or hop % 4 or win % 4 or threads > 1024:
        raise ValueError(
            f"log_mel_spectrogram: unsupported geometry win={win} hop={hop} nf={nf}"
        )
    frames = num_stft_frames(n, hop)
    out = torch.empty((batch, frames, n_mels), dtype=torch.float32, device=x.device)
    if batch == 0:
        return out
    lib = _cuda_lib.library("frontend")
    fn = lib.log_mel_launch
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 4
        + [ctypes.c_int] * 8
        + [ctypes.c_float] * 3
        + [ctypes.c_int, ctypes.c_void_p]
    )
    with torch.cuda.device(x.device):
        err = fn(
            x.data_ptr(),
            basis.data_ptr(),
            mel.data_ptr(),
            out.data_ptr(),
            batch,
            n,
            frames,
            hop,
            win,
            win // 2,
            nf,
            n_mels,
            amin,
            mult,
            db_off,
            threads,
            _cuda_lib.stream_of(x),
        )
    _cuda_lib.check("frontend", err)
    log_mel_spectrogram.launches += 1
    return out


log_mel_spectrogram.launches = 0
