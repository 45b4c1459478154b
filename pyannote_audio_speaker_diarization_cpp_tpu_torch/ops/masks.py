"""Mask preparation for the masked-embedding stage, fully vectorized.

Re-design of the reference's host loops (pipeline/src/speakerDiarizer.cpp):
  - cleanSegmentations  :710-743  (zero out frames with overlapping speech)
  - interpolate         :745-768  (nearest-neighbor mask upsampling 293->80000)
  - padSequence         :769-799  (left-pack speech samples, zero pad)
  - wav_lens handling in getEmbedding :2436-2510
Python originals: segment/segment.py:179-215, :283-303.
"""

from __future__ import annotations

import torch

from .pack_cuda import pack_frames


def clean_segmentations(binarized: torch.Tensor) -> torch.Tensor:
    """(num_chunks, num_frames, num_speakers) -> same, overlap frames zeroed.

    Keep a frame iff fewer than 2 speakers are active in it
    (segment/segment.py:179-181).
    """
    clean = (binarized.sum(dim=2, keepdim=True) < 2).to(binarized.dtype)
    return binarized * clean


def choose_masks(
    binarized: torch.Tensor, cleaned: torch.Tensor, min_num_frames: float
) -> torch.Tensor:
    """Per (chunk, speaker): use the clean mask when it retains enough frames,
    else fall back to the raw binarized mask (speakerDiarizer.cpp:3056-3078).

    Inputs are (num_chunks, num_frames, num_speakers); output is
    (num_chunks, num_speakers, num_frames) — one mask row per embedding.
    """
    use_clean = (cleaned.sum(dim=1) > min_num_frames)[:, None, :]
    chosen = torch.nan_to_num(torch.where(use_clean, cleaned, binarized), nan=0.0)
    return chosen.permute(0, 2, 1)


def pack_and_lengths(
    waveforms: torch.Tensor,
    masks: torch.Tensor,
    mask_threshold: float,
    min_num_samples: int,
):
    """Full embedding-preprocessing step for a batch of (chunk, speaker) rows.

    Parameters
    ----------
    waveforms : (batch, num_samples) cropped 5 s windows, float32
    masks : (batch, num_frames) chosen per-speaker frame masks

    Returns
    -------
    signals : (batch, num_samples) left-packed speech samples
    wav_lens : (batch,) relative lengths for the embedding model, normalized
        by the padded window size (num_samples). The reference normalizes by
        the batch max length (speakerDiarizer.cpp:2467-2510) because torch
        pad_sequence pads to the batch max; the fixed-shape batch here is
        padded to the full window, so window-relative lengths put the
        feature-frame mask at the same absolute boundary.
    too_short : (batch,) bool — rows with fewer than min_num_samples kept
        samples; their embeddings are replaced by NaN downstream
        (segment/segment.py:298-303).

    Nearest interpolation is value-preserving, so thresholding at frame level
    before upsampling is identical to thresholding after: the pack works on
    frame-level keep flags and never builds the sample-level mask.
    """
    num_samples = waveforms.shape[-1]
    signals, lens = pack_frames(waveforms, masks > mask_threshold)
    too_short = lens < min_num_samples
    wav_lens = torch.where(
        too_short, torch.ones_like(lens, dtype=torch.float32), lens / num_samples
    ).to(torch.float32)
    return signals, wav_lens, too_short
