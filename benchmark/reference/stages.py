"""Plain stages 1 and 2 of the pyannote v2.1 recipe for one recording.

Stage 1 scores every 5 s window of the recording at a 0.5 s hop with
PyanNet (the last, shorter window at its true length), binarizes the
scores by hysteresis, chooses each (window, local speaker)'s embedding
mask (the overlap-free mask where it keeps more than ``min_num_frames``
frames, else the raw one) and overlap-adds the instantaneous speaker count.
Stage 2 left-packs each row's masked samples into a zero-padded window,
computes speechbrain's log-mel features (``torch.stft``) with sentence
mean normalisation, and runs ECAPA-TDNN on the rows with at least
``min_num_samples`` samples.

Everything runs in float32 with TF32 off unless ``tf32`` asks for it (the
control of a float32 configuration). Rows run in blocks so that a
900 s recording fits beside the program's state.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict

import numpy as np
import torch

from . import decode, models


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def num_chunks(num_samples: int, window: int, step: int) -> int:
    """Windows of a recording, the shorter last one included."""
    if num_samples < window:
        return 1
    full = (num_samples - window) // step + 1
    return full + (1 if (num_samples - window) % step else 0)


def hysteresis(scores: np.ndarray, onset: float, offset: float) -> np.ndarray:
    """(rows, frames) -> bool: on above onset, off below offset, else the
    last well-defined state; before the first, score[0] >= mid-threshold."""
    state = scores[:, 0] >= 0.5 * (onset + offset)
    out = np.zeros(scores.shape, dtype=bool)
    for t in range(scores.shape[1]):
        s = scores[:, t]
        state = np.where(s > onset, True, np.where(s < offset, False, state))
        out[:, t] = state
    return out


def stage1(audio: np.ndarray, weights: Dict, cfg: Dict, device, quant=None, tf32=False,
           block: int = 128) -> Dict:
    """Scores, binarized scores, chosen masks and the raw speaker count of
    one recording (float32 numpy on the host)."""
    seg, model = cfg["segmentation"], cfg["pyannet"]
    sr = cfg["sample_rate"]
    window, step = round(seg["duration"] * sr), round(seg["step"] * sr)
    n = audio.shape[0]
    chunks = num_chunks(n, window, step)
    frames = seg["num_frames"]
    padded = np.zeros((chunks - 1) * step + window, np.float32)
    padded[:n] = audio
    wav = torch.from_numpy(padded).to(device)
    scores = torch.zeros((chunks, frames, model["num_classes"]), device=device)
    last = n - (chunks - 1) * step  # true length of the last window
    full = chunks if last >= window else chunks - 1
    with torch.no_grad(), matmul_precision(tf32):
        for i in range(0, full, block):
            j = min(full, i + block)
            x = wav.unfold(0, window, step)[i:j]
            scores[i:j] = models.pyannet_forward(x, weights, model, sr, quant)
        if full < chunks:
            x = wav[(chunks - 1) * step : (chunks - 1) * step + last][None, :]
            out = models.pyannet_forward(x, weights, model, sr, quant)
            scores[chunks - 1, : out.shape[1]] = out[0]
    scores = scores.cpu().numpy()
    k = scores.shape[2]
    rows = scores.transpose(0, 2, 1).reshape(-1, frames)
    binarized = hysteresis(rows, seg["onset"], seg["offset"]).reshape(chunks, k, frames)
    binarized = binarized.transpose(0, 2, 1).astype(np.float32)
    clean = binarized * (binarized.sum(axis=2, keepdims=True) < 2)
    min_frames = math.ceil(frames * cfg["embedding"]["min_num_samples"] / window)
    use_clean = clean.sum(axis=1) > min_frames  # (chunks, k)
    chosen = np.where(use_clean[:, None, :], clean, binarized).transpose(0, 2, 1)
    count = speaker_count(binarized, chunks, cfg)
    return {"scores": scores, "binarized": binarized, "chosen": chosen, "count_raw": count,
            "num_chunks": chunks, "num_samples": n}


def speaker_count(binarized: np.ndarray, chunks: int, cfg: Dict) -> np.ndarray:
    """Trim the warm-up tenth off each side of every window, sum the
    speakers, overlap-add average onto the frame grid."""
    seg = cfg["segmentation"]
    frames = binarized.shape[1]
    left, right = math.floor(frames * seg["warm_up"][0]), math.floor(frames * seg["warm_up"][1])
    summed = binarized[:, left : frames - right, :].sum(axis=-1, keepdims=True).astype(np.float64)
    trimmed = decode.SlidingWindow(seg["warm_up"][0] * seg["duration"], seg["step"],
                                   (1 - sum(seg["warm_up"])) * seg["duration"])
    frame_grid = decode.SlidingWindow(0.0, seg["frame_step"], seg["frame_step"])
    start_frames, n_out = decode.plan(chunks, trimmed, frame_grid)
    return decode.overlap_add(summed, start_frames, n_out, average=True)[:, 0]


def log_mel(x: torch.Tensor, cfg: Dict) -> torch.Tensor:
    """(B, N) -> (B, frames, n_mels): centred zero-padded STFT (periodic
    Hamming), power, speechbrain's triangular mel filters, 10 log10 with
    the amin floor, each row clamped at its max - top_db."""
    fe = cfg["frontend"]
    win = torch.hamming_window(fe["n_fft"], periodic=True, device=x.device)
    spec = torch.stft(x, fe["n_fft"], hop_length=fe["hop_length"], win_length=fe["n_fft"],
                      window=win, center=True, pad_mode="constant", return_complex=True)
    power = spec.real ** 2 + spec.imag ** 2  # (B, freqs, frames)
    mel = torch.from_numpy(mel_filterbank(fe, cfg["sample_rate"]).astype(np.float32)).to(x.device)
    db = 10.0 * torch.log10(torch.clamp(power.transpose(1, 2) @ mel, min=fe["amin"]))
    top = db.amax(dim=(1, 2), keepdim=True)
    return torch.maximum(db, top - fe["top_db"])


def mel_filterbank(fe: Dict, sample_rate: int) -> np.ndarray:
    """(n_fft // 2 + 1, n_mels) speechbrain triangular filters, symmetric in
    Hz with half-width the spacing to the previous mel point."""
    to_mel = lambda hz: 2595.0 * np.log10(1.0 + hz / 700.0)  # noqa: E731
    hz = 700.0 * (10.0 ** (np.linspace(to_mel(fe["f_min"]), to_mel(fe["f_max"]), fe["n_mels"] + 2)
                           / 2595.0) - 1.0)
    band, centre = (hz[1:] - hz[:-1])[:-1], hz[1:-1]
    freqs = np.linspace(0, sample_rate // 2, fe["n_fft"] // 2 + 1)
    slope = (freqs[:, None] - centre[None, :]) / band[None, :]
    return np.maximum(0.0, np.minimum(slope + 1.0, 1.0 - slope))


def pack(windows: torch.Tensor, masks: torch.Tensor, threshold: float):
    """Left-pack the samples whose nearest-upsampled frame mask is above
    ``threshold``: (B, N) windows, (B, F) masks -> ((B, N) packed, zero
    padded; (B,) kept samples)."""
    B, N = windows.shape
    frame = (torch.arange(N, device=windows.device) * masks.shape[1]) // N
    keep = masks[:, frame] > threshold
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    lens = keep.sum(dim=1)
    packed = torch.gather(windows, 1, order)
    packed = torch.where(torch.arange(N, device=windows.device)[None, :] < lens[:, None],
                         packed, torch.zeros_like(packed))
    return packed, lens


def stage2(audio: np.ndarray, chosen: np.ndarray, weights: Dict, cfg: Dict, device,
           quant=None, tf32=False, block: int = 64) -> Dict:
    """Embeddings (rows, emb_dim) float32, NaN for too-short rows, and the
    too-short flags, of one recording's (window, speaker) rows in order."""
    seg, emb_cfg = cfg["segmentation"], cfg["embedding"]
    sr = cfg["sample_rate"]
    window, step = round(seg["duration"] * sr), round(seg["step"] * sr)
    chunks, k, frames = chosen.shape
    padded = np.zeros((chunks - 1) * step + window, np.float32)
    padded[: audio.shape[0]] = audio
    wav = torch.from_numpy(padded).to(device).unfold(0, window, step)
    masks = torch.from_numpy(np.ascontiguousarray(chosen.reshape(-1, frames))).to(device)
    rows = masks.shape[0]
    chunk_of_row = torch.arange(rows, device=device) // k
    with torch.no_grad():
        _, lens = pack(wav[chunk_of_row], masks, emb_cfg["mask_threshold"])
    too_short = (lens < emb_cfg["min_num_samples"]).cpu().numpy()
    emb = np.full((rows, cfg["ecapa"]["emb_dim"]), np.nan, np.float32)
    todo = np.flatnonzero(~too_short)
    with torch.no_grad(), matmul_precision(tf32):
        for i in range(0, len(todo), block):
            idx = torch.from_numpy(todo[i : i + block]).to(device)
            signals, n_kept = pack(wav[chunk_of_row[idx]], masks[idx], emb_cfg["mask_threshold"])
            rel = n_kept.float() / window
            feats = log_mel(signals, cfg)
            T = feats.shape[1]
            valid = (torch.arange(T, device=device)[None, :]
                     < torch.round(rel * T)[:, None]).float()[:, :, None]
            feats = feats - (feats * valid).sum(1, keepdim=True) / valid.sum(1, keepdim=True).clamp(min=1)
            out = models.ecapa_forward(feats, rel, weights, cfg["ecapa"], quant)
            emb[todo[i : i + block]] = out.float().cpu().numpy()
    return {"emb": emb, "too_short": too_short}
