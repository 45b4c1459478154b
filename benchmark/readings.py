"""What the per-layer metrics' readers share: the audio minutes of the
window, the per-request spans, and the bounds of the hand-written kernels'
calls in the window, counted from the cell's shapes and from the chosen
masks of the reference's own stage 1 on the same recordings (never from a
counter of the program)."""

from __future__ import annotations

import numpy as np

from . import roofline


def audio_min(ctx) -> float:
    return ctx["audio_s"] / 60.0


def span_sum(ctx, *fields) -> float:
    return sum(getattr(r.timings, f) for r in ctx["requests"] for f in fields)


def kernel_seconds(ctx, needle: str):
    """(device seconds, launches) of the traced kernels whose name holds
    ``needle``; None without a trace or without such a kernel."""
    tr = ctx["trace"]
    spans = [(s, e) for n, s, e in tr.kernels() if needle in n]
    if not spans:
        return None
    return sum(e - s for s, e in spans), len(spans)


def _row_lengths(ctx, req):
    """Relative lengths of a request's stage-2 rows as the pipeline hands
    them to ECAPA: kept samples / window, 1 for rows under
    ``min_num_samples`` and for the padding windows' rows."""
    cfg = ctx["cfg"]
    window = round(cfg["segmentation"]["duration"] * cfg["sample_rate"])
    chosen = ctx["refs"][req.index]["chosen"]  # (chunks, S, frames)
    chunks, S, frames = chosen.shape
    owned = np.diff((np.arange(frames + 1) * window + frames - 1) // frames)
    lens = (chosen > cfg["embedding"]["mask_threshold"]).astype(np.int64) @ owned
    rel = np.where(lens < cfg["embedding"]["min_num_samples"], 1.0,
                   lens.astype(np.float32) / np.float32(window)).astype(np.float32).reshape(-1)
    pad = np.ones((req.num_padded - chunks) * S, np.float32)
    return np.concatenate([rel, pad])


def asp_bound_s(ctx, dtype: str) -> float:
    """Least seconds of every ASP call of the window's requests."""
    cfg = ctx["cfg"]
    ec = cfg["ecapa"]
    T = round(cfg["segmentation"]["duration"] * cfg["sample_rate"]) // cfg["frontend"]["hop_length"] + 1
    B = cfg["embedding"]["batch_size"]
    total = 0.0
    cache = {}
    for req in ctx["requests"]:
        if req.index not in cache:
            rel = _row_lengths(ctx, req)
            bounds = rel * np.float32(T)
            valid = np.minimum(np.ceil(bounds), T)
            cache[req.index] = sum(
                roofline.asp_bound_s(float(valid[i : i + B].sum()), B, T, ec["channels"][-1],
                                     ec["attention_channels"], dtype)
                for i in range(0, len(valid), B))
        total += cache[req.index]
    return total


def log_mel_bound_s(ctx) -> float:
    cfg = ctx["cfg"]
    fe = cfg["frontend"]
    window = round(cfg["segmentation"]["duration"] * cfg["sample_rate"])
    frames = window // fe["hop_length"] + 1
    B = cfg["embedding"]["batch_size"]
    from .reference.stages import mel_filterbank

    nnz = int((mel_filterbank(fe, cfg["sample_rate"]) != 0).sum())
    per_call = roofline.log_mel_bound_s(B, window, frames, fe["n_fft"], fe["n_mels"], nnz)
    S = cfg["pyannet"]["num_classes"]
    return sum(per_call * (r.num_padded * S // B) for r in ctx["requests"])


def roofline_share(ctx, needle: str, bound: float):
    got = kernel_seconds(ctx, needle)
    if got is None:
        return None
    return 100.0 * bound / got[0]
