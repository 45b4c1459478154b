"""Sample-rate conversion and downmixing, host-side.

The reference wraps libsamplerate's ``src_simple``
(reference pipeline/src/frontend/resampler.cc:19-36) but requires the input
wav to already be 16 kHz mono (README.md:37). We go one step further and make
arbitrary-rate input work: polyphase resampling (Kaiser-windowed sinc) on the
host before the waveform ever reaches the device.
"""

from __future__ import annotations

import math

import numpy as np


def downmix(samples: np.ndarray) -> np.ndarray:
    """(channels, n) -> (n,) mean over channels (pyannote downmix
    convention, reference segment/mysegment.py:261 downmix_and_resample)."""
    if samples.ndim == 1:
        return samples
    return samples.mean(axis=0)


def resample(x: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resample 1-D ``x`` from orig_sr to target_sr."""
    if orig_sr == target_sr:
        return np.asarray(x)
    g = math.gcd(int(orig_sr), int(target_sr))
    up, down = target_sr // g, orig_sr // g
    try:
        from scipy.signal import resample_poly

        return resample_poly(x, up, down).astype(np.float32)
    except ImportError:
        # windowed-sinc fallback: upsample by zero-stuffing + low-pass
        n_taps = 64 * max(up, down) + 1
        cutoff = 0.5 / max(up, down)
        t = np.arange(n_taps) - (n_taps - 1) / 2
        h = 2 * cutoff * np.sinc(2 * cutoff * t) * np.kaiser(n_taps, 8.0)
        h *= up
        upsampled = np.zeros(len(x) * up, dtype=np.float64)
        upsampled[::up] = x
        filtered = np.convolve(upsampled, h, mode="same")
        return filtered[::down].astype(np.float32)
