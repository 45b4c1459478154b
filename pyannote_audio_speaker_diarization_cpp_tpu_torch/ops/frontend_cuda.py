"""Log-mel spectrogram (STFT -> power -> mel -> dB): CUDA kernel wrapper and
plain version.

Replaces the TPU kernel ``log_mel_spectrogram`` (JAX package
ops/frontend_pallas.py). The kernel is ``csrc/frontend.cu``: the DFT product
on the tensor cores in 3xTF32 (three TF32 products per float32 product, as
accurate as float32), bound by those operations (0.031 ms at the H100's TF32
peak for a 32 x 80000 batch); the power in registers; the mel projection over
each band's own bins. Its header gives the layout. Like the TPU kernel, it
stops before the per-row top_db clamp; ``ops.frontend.compute_features``
applies the clamp and the sentence mean-norm.

The kernel reads the basis split into TF32 halves in the order its wgmma
reads them (``basis_tiles``) and the filterbank as a band table (``band_table``);
both are built once per basis or mel tensor and cached beside it.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from . import _cuda_lib

# the kernel's fixed sizes (csrc/frontend.cu)
KERNEL_BINS = 208  # frequency bins it computes, 201 padded to 26 pairs of 8
PASS_PAIRS = (7, 7, 6, 6)  # pairs of each pass over the bins
BAND_WIDTH = 16  # bins one mel band may span


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


def round_tf32(v: torch.Tensor) -> torch.Tensor:
    """float32 ``v`` rounded to TF32 (10 mantissa bits, to nearest, ties away
    from zero), as ``cvt.rna.tf32.f32`` rounds finite values: the low 13
    mantissa bits come out zero."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(big, small): big = round_tf32(v), small = round_tf32(v - big), so
    big + small is v to about 2^-22 relative."""
    big = round_tf32(v)
    return big, round_tf32(v - big)


def kernel_ksteps(win: int) -> int:
    """k steps of 8 the kernel takes for a window of ``win`` samples: win
    padded to a multiple of 16 (it loops over k16)."""
    return 2 * -(-win // 16)


def basis_tiles(basis: torch.Tensor) -> torch.Tensor:
    """(win, 2 nf) basis -> the kernel's basis layout, flat float32.

    Columns: KERNEL_BINS bins (zero past nf), pair p (bins 8p .. 8p + 7) as
    its 8 real columns then its 8 imaginary ones. Rows: k, win padded to
    kernel_ksteps(win) x 8 with zero rows. The columns go in passes of
    PASS_PAIRS pairs (N = 16 x pairs columns); pass by pass, k step by k
    step, big then small half (split_tf32), each an N x 8 operand as wgmma
    reads it from shared memory: 8 x 4 core matrices (8 columns, 4 k), the
    two k-groups of an 8-column group side by side, column groups in order.
    """
    win, ncol = basis.shape
    nf = ncol // 2
    if ncol != 2 * nf or nf > KERNEL_BINS:
        raise ValueError(f"basis_tiles: {nf} bins, the kernel takes at most {KERNEL_BINS}")
    kp = 8 * kernel_ksteps(win)
    b = torch.zeros((kp, KERNEL_BINS // 8, 2, 8), dtype=torch.float32, device=basis.device)
    for half in range(2):  # 0: real, 1: imaginary
        cols = torch.zeros((kp, KERNEL_BINS), dtype=torch.float32, device=basis.device)
        cols[:win, :nf] = basis[:, half * nf : (half + 1) * nf].float()
        b[:, :, half, :] = cols.view(kp, KERNEL_BINS // 8, 8)
    halves = split_tf32(b.view(kp, 2 * KERNEL_BINS))
    parts, c0 = [], 0
    for pairs in PASS_PAIRS:
        n = 16 * pairs
        # [k, col] -> [step, kgroup, kk, colgroup, row] -> [step, colgroup, kgroup, row, kk]
        step = [
            h[:, c0 : c0 + n].reshape(kp // 8, 2, 4, n // 8, 8).permute(0, 3, 1, 4, 2)
            for h in halves
        ]
        parts.append(torch.stack(step, dim=1).reshape(-1))
        c0 += n
    return torch.cat(parts).contiguous()


def band_table(mel: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(nf, n_mels) filterbank -> (bins (n_mels, 2) int32: first bin and bin
    count of each band's nonzero span; weights (n_mels, BAND_WIDTH) float32:
    the band's weights over that span, zero after it), on mel's device.
    Raises if a band spans more than BAND_WIDTH bins."""
    m = mel.detach().float().cpu()
    n_mels = m.shape[1]
    bins = torch.zeros((n_mels, 2), dtype=torch.int32)
    weights = torch.zeros((n_mels, BAND_WIDTH), dtype=torch.float32)
    for band in range(n_mels):
        nz = torch.nonzero(m[:, band]).flatten()
        if nz.numel() == 0:
            continue
        first, count = int(nz[0]), int(nz[-1]) - int(nz[0]) + 1
        if count > BAND_WIDTH:
            raise ValueError(
                f"band_table: band {band} spans {count} bins, the kernel takes {BAND_WIDTH}"
            )
        bins[band] = torch.tensor([first, count])
        weights[band, :count] = m[first : first + count, band]
    return bins.to(mel.device), weights.to(mel.device)


_TILES: WeakIdKeyDictionary = WeakIdKeyDictionary()
_BANDS: WeakIdKeyDictionary = WeakIdKeyDictionary()


def _cached(cache: WeakIdKeyDictionary, t: torch.Tensor, build):
    """build(t), kept while t lives and is not written to (an inference
    tensor counts no writes: it is taken as constant, as the front-end's
    constants are)."""
    version = None if t.is_inference() else t._version
    hit = cache.get(t)
    if hit is None or hit[0] != version:
        hit = (version, build(t))
        cache[t] = hit
    return hit[1]


def prepare(basis: torch.Tensor, mel: torch.Tensor) -> None:
    """Build and cache the kernel's basis layout and band table for these
    tensors now (``band_table`` reads the filterbank back to the host, a
    wait for the card), so that no launch builds them."""
    _cached(_TILES, basis, basis_tiles)
    _cached(_BANDS, mel, band_table)


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

    On a CUDA tensor this launches ``csrc/frontend.cu``, and raises on a
    geometry it does not take (nf > KERNEL_BINS, a band wider than
    BAND_WIDTH bins, hop or win not a multiple of 4); on a CPU tensor it
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
    if ncol != 2 * nf or nf > KERNEL_BINS or hop % 4 or win % 4 or hop <= 0:
        raise ValueError(
            f"log_mel_spectrogram: unsupported geometry win={win} hop={hop} nf={nf}"
        )
    tiles = _cached(_TILES, basis, basis_tiles)
    bins, weights = _cached(_BANDS, mel, band_table)
    frames = num_stft_frames(n, hop)
    out = torch.empty((batch, frames, n_mels), dtype=torch.float32, device=x.device)
    if batch == 0:
        return out
    lib = _cuda_lib.library("frontend")
    fn = lib.log_mel_launch
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 5
        + [ctypes.c_int] * 7
        + [ctypes.c_float] * 4
        + [ctypes.c_void_p]
    )
    with torch.cuda.device(x.device):
        err = fn(
            x.data_ptr(),
            tiles.data_ptr(),
            bins.data_ptr(),
            weights.data_ptr(),
            out.data_ptr(),
            batch,
            n,
            frames,
            hop,
            kernel_ksteps(win),
            win // 2,
            n_mels,
            amin,
            mult,
            db_off,
            mult * math.log10(amin) - db_off,  # what silence reads
            _cuda_lib.stream_of(x),
        )
    _cuda_lib.check("frontend", err)
    log_mel_spectrogram.launches += 1
    return out


log_mel_spectrogram.launches = 0
