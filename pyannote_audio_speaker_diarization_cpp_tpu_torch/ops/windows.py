"""Sliding-window chunking of waveforms as a strided view.

The reference copies each 5 s window into a fresh buffer inside a scalar loop
(reference pipeline/src/speakerDiarizer.cpp:1419-1480, segment/segment.py:79-93,
via tensor.unfold). Here all chunks are one ``unfold`` view of the padded
waveform: no copy until a batch of windows is gathered for a model call.
"""

from __future__ import annotations

import torch


def chunk_count(num_samples: int, window_size: int, step_size: int) -> int:
    """Total number of sliding chunks including the orphan last chunk.

    Matches Segmentation.slide (segment/segment.py:79-93): complete windows
    plus one ragged window when the audio does not end on a window boundary.
    """
    if num_samples < window_size:
        return 1
    num_complete = (num_samples - window_size) // step_size + 1
    if (num_samples - window_size) % step_size > 0:
        return num_complete + 1
    return num_complete


def device_chunks(
    wav_padded: torch.Tensor, num_chunks: int, window_size: int, step_size: int
) -> torch.Tensor:
    """(samples,) -> (num_chunks, window_size) view of sliding windows.

    ``wav_padded`` must hold at least ``(num_chunks - 1) * step_size +
    window_size`` samples. 16-bit audio may arrive as raw int16 (half the
    host-to-device bytes) and is scaled on the device; int16/32768 is exact
    in float32.
    """
    if wav_padded.dtype == torch.int16:
        wav_padded = wav_padded.to(torch.float32) * (1.0 / 32768.0)
    return wav_padded.unfold(0, window_size, step_size)[:num_chunks]
