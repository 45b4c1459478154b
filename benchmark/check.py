"""The comparison that decides ``correct``.

For each checked recording the program's outputs of the timed path are
held against the plain reference (``benchmark/reference``), layer by layer:

- ``seg_max_abs``: stage 1's window scores, largest absolute gap;
- ``bin_flip_share``: share of binarized (window, frame, speaker) scores
  that differ;
- ``count_flip_share``: share of frames whose rounded speaker count differs;
- ``emb_max_rel``: stage 2's embeddings, largest ||program - reference|| /
  ||reference|| over the rows whose chosen masks agree (both sides'
  stage 1 chose the same frames) and that both sides embed;
- ``partition_rows_off`` (device route): rows whose cluster differs from
  the reference clustering of the program's own embeddings, after the best
  one-to-one matching of cluster numbers;
- ``turns_diff_s``: seconds where the program's turns differ from the
  reference decode of the program's own scores, count and labels (device
  route) or of the reference clustering of its embeddings (host route).

The last two follow the program from its own state (its embeddings, its
scores): stage 3 and the decode are then judged alone, while the first
four judge stages 1 and 2 against the reference's own computation from the
audio and the weights. Each number is judged against its limit in
``benchmark/limits/<workload>.json``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from .reference import clustering, decode, stages


def reference_stage1(audio, weights, cfg, device, quant=None, tf32=False):
    return stages.stage1(audio, weights["segmentation"], cfg, device, quant, tf32)


def reference_stage2(audio, ref1, weights, cfg, device, quant=None, tf32=False):
    return stages.stage2(audio, ref1["chosen"], weights["embedding"], cfg, device, quant, tf32)


def chosen_masks(binarized: np.ndarray, cfg) -> np.ndarray:
    """(chunks, frames, S) binarized -> (chunks, S, frames) chosen masks, by
    the same rule as the reference's stage 1."""
    frames = binarized.shape[1]
    window = round(cfg["segmentation"]["duration"] * cfg["sample_rate"])
    clean = binarized * (binarized.sum(axis=2, keepdims=True) < 2)
    use_clean = clean.sum(axis=1) > math.ceil(
        frames * cfg["embedding"]["min_num_samples"] / window)
    return np.where(use_clean[:, None, :], clean, binarized).transpose(0, 2, 1)


def partition_mismatch(a: np.ndarray, b: np.ndarray) -> int:
    """Rows whose labels differ after the best one-to-one matching."""
    from scipy.optimize import linear_sum_assignment

    if len(a) == 0:
        return 0
    ua, ia = np.unique(a, return_inverse=True)
    ub, ib = np.unique(b, return_inverse=True)
    table = np.zeros((len(ua), len(ub)), dtype=np.int64)
    np.add.at(table, (ia, ib), 1)
    r, c = linear_sum_assignment(-table)
    return int(len(a) - table[r, c].sum())


def numbers(ans: Dict, ref1: Dict, ref2: Dict, cfg, traffic) -> Dict[str, float]:
    """The compared numbers of one recording."""
    out = {}
    n = ref1["num_chunks"]
    if ans["scores"].shape != ref1["scores"].shape:
        raise ValueError(f"scores {ans['scores'].shape} against {ref1['scores'].shape}")
    out["seg_max_abs"] = float(np.abs(ans["scores"] - ref1["scores"]).max())
    out["bin_flip_share"] = float((ans["binarized"] != ref1["binarized"]).mean())
    nc = len(ref1["count_raw"])
    out["count_flip_share"] = float(
        (np.rint(ans["count_raw"][:nc]) != np.rint(ref1["count_raw"])).mean())
    S = ans["scores"].shape[2]
    same = (chosen_masks(ans["binarized"], cfg) == ref1["chosen"]).all(axis=2).reshape(-1)
    rows = same & ~ans["too_short"] & ~ref2["too_short"]
    if rows.any():
        a, r = ans["emb"][rows].astype(np.float64), ref2["emb"][rows].astype(np.float64)
        rel = np.linalg.norm(a - r, axis=1) / np.linalg.norm(r, axis=1)
        out["emb_max_rel"] = float(np.nan_to_num(rel, nan=np.inf).max())
    out["_emb_rows_share"] = float(rows.sum() / max((~ref2["too_short"]).sum(), 1))

    emb = ans["emb"].astype(np.float64).reshape(n, S, -1)
    num_speakers = traffic["bounds"].get("num_speakers")
    labels = clustering.cluster(emb, ans["inactive"], cfg["clustering"], num_speakers)
    if ans["device_route"]:
        valid = (~ans["too_short"].reshape(n, S)) & ~ans["inactive"]
        out["partition_rows_off"] = float(partition_mismatch(ans["hard"][valid], labels[valid]))
        turns = decode.decode(ans["scores"], ans["hard"], ans["num_large"], ans["count_raw"],
                              cfg, half_activations=True)
    else:
        k = max(int(labels.max()) + 1, 1)
        turns = decode.decode(ans["scores"], labels, k, ans["count_raw"], cfg,
                              half_activations=False)
    out["turns_diff_s"] = float(decode.turn_difference_s(ans["turns"], turns))
    return out


def judge(numbers: Dict[str, float], limits: Dict) -> Dict[str, Dict]:
    """{name: {value, limit, ok}}: a number passes when it is finite and at
    most its limit; a number without a limit fails. Names starting with
    ``_`` are reported, not judged."""
    out = {}
    for name, value in numbers.items():
        if name.startswith("_"):
            continue
        limit = limits.get("numbers", {}).get(name, {}).get("limit")
        ok = limit is not None and math.isfinite(value) and value <= limit
        out[name] = {"value": value, "limit": limit, "ok": ok}
    return out


# ---------------------------------------------------------------------------
# the control: the reference in the program's place, one precision lower
# ---------------------------------------------------------------------------


def round_to(dtype):
    """Round a float32 tensor to ``dtype`` and back (bfloat16, or float8
    e4m3 with a per-tensor scale that maps its largest magnitude to 448)."""
    def q(t: torch.Tensor) -> torch.Tensor:
        if dtype == "bfloat16":
            return t.to(torch.bfloat16).to(t.dtype)
        scale = t.abs().amax().clamp(min=1e-30) / 448.0
        return ((t / scale).to(torch.float8_e4m3fn).to(t.dtype)) * scale
    return q


def control_answer(audio, weights, cfg, traffic, device) -> Dict:
    """What the reference gives one precision below the configuration's:
    for a float32 configuration with TF32 off, TF32; for the default
    numerics (TF32 convolutions in stage 1, a bfloat16 ECAPA trunk),
    bfloat16 operands in stage 1 and float8 (e4m3) operands in the trunk.
    Returned in the shape of the program's answer (host route)."""
    if cfg["compute_dtype"] == "float32":
        ref1 = reference_stage1(audio, weights, cfg, device, tf32=True)
        ref2 = reference_stage2(audio, ref1, weights, cfg, device, tf32=True)
    else:
        ref1 = reference_stage1(audio, weights, cfg, device, quant=round_to("bfloat16"))
        ref2 = reference_stage2(audio, ref1, weights, cfg, device, quant=round_to("float8"))
    n = ref1["num_chunks"]
    S = ref1["scores"].shape[2]
    inactive = ref1["binarized"].sum(axis=1) == 0
    emb = ref2["emb"].astype(np.float64).reshape(n, S, -1)
    labels = clustering.cluster(emb, inactive, cfg["clustering"],
                                traffic["bounds"].get("num_speakers"))
    k = max(int(labels.max()) + 1, 1)
    turns = decode.decode(ref1["scores"], labels, k, ref1["count_raw"], cfg, False)
    return {
        "scores": ref1["scores"], "binarized": ref1["binarized"],
        "count_raw": ref1["count_raw"], "emb": ref2["emb"], "too_short": ref2["too_short"],
        "inactive": inactive, "hard": None, "num_large": 0, "device_route": False,
        "turns": turns,
    }


def worst(per_recording) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for nums in per_recording:
        for k, v in nums.items():
            out[k] = max(out.get(k, -math.inf), v)
    return out


def numbers_for(ans, audio, weights, cfg, traffic, device, ref1: Optional[Dict] = None):
    ref1 = ref1 or reference_stage1(audio, weights, cfg, device)
    ref2 = reference_stage2(audio, ref1, weights, cfg, device)
    return numbers(ans, ref1, ref2, cfg, traffic)
