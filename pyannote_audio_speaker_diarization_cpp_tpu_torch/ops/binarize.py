"""Vectorized hysteresis binarization.

Re-design of pyannote's `binarize_ndarray` (reference
segment/segment.py:419-482; C++ port at pipeline/src/speakerDiarizer.cpp:
1506-1663). The reference builds, per row, the list of "well-defined" frame
indices (score > onset or score < offset) and gathers the on/off state of
the most recent one. That is a running maximum in disguise:
``state[t] = on[last_well_defined_index <= t]`` — one ``cummax`` and one
``gather``, no ragged index lists.
"""

from __future__ import annotations

import torch


def binarize_scores(
    scores: torch.Tensor,
    onset: float,
    offset: float | None = None,
    initial_state: bool | None = None,
) -> torch.Tensor:
    """(batch, num_frames) scores -> boolean hysteresis states.

    Semantics identical to binarize_ndarray (segment/segment.py:419-482):
      - frames with score > onset switch on,
      - frames with score < offset switch off,
      - in-between frames carry the previous well-defined state forward,
      - frames before the first well-defined frame take ``initial_state``
        (default: score[0] >= (onset+offset)/2).
    NaNs are treated as 0 (np.nan_to_num in the original).
    """
    if offset is None:
        offset = onset
    scores = torch.nan_to_num(scores, nan=0.0)
    on = scores > onset
    off_or_on = (scores < offset) | on
    if initial_state is None:
        init = scores[:, 0] >= 0.5 * (onset + offset)
    else:
        init = torch.full(
            (scores.shape[0],), bool(initial_state), device=scores.device
        )
    frame_idx = torch.arange(scores.shape[1], device=scores.device)[None, :]
    # index of the most recent well-defined frame at or before t; -1 if none
    marked = torch.where(off_or_on, frame_idx, -1)
    last_defined = torch.cummax(marked, dim=1).values
    state = torch.gather(on, 1, torch.clamp(last_defined, min=0))
    return torch.where(last_defined >= 0, state, init[:, None])


def binarize_swf(
    scores: torch.Tensor,
    onset: float,
    offset: float | None = None,
    initial_state: bool | None = None,
) -> torch.Tensor:
    """(num_chunks, num_frames, num_classes) -> float32 binarized scores.

    Matches binarize_swf (segment/segment.py:357-417): rearrange
    ``c f k -> (c k) f``, binarize rows, rearrange back, cast to float.
    """
    c, f, k = scores.shape
    rows = scores.permute(0, 2, 1).reshape(c * k, f)
    binarized = binarize_scores(rows, onset, offset, initial_state)
    return binarized.reshape(c, k, f).permute(0, 2, 1).to(torch.float32)
