"""Diarization error rate (DER) with optimal speaker mapping.

The reference repo has no in-repo accuracy metric — correctness is judged by
eyeballing printed turns against pyannote's output (reference README.md:42-52,
SURVEY.md section 5.5 flags this gap). This is the standard NIST-style DER:

    DER = (missed speech + false alarm + speaker confusion) / total reference
          speech time

with the hypothesis->reference speaker mapping chosen by a Hungarian
assignment over pairwise overlap durations, and an optional forgiveness
collar around reference turn boundaries.

A copy of the JAX package's metrics/der.py (it imports no JAX), owned by
the port so the port runs where JAX is not installed.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from ..core.annotation import Annotation


def _boundaries(ann: Annotation, collar: float = 0.0):
    """Event boundaries of all turns; collar shrinks reference turns on both
    sides to produce the scoring regions."""
    times = set()
    for label in ann.labels:
        for seg in ann.segments(label):
            times.add(seg.start)
            times.add(seg.end)
            if collar > 0:
                times.add(seg.start - collar)
                times.add(seg.start + collar)
                times.add(seg.end - collar)
                times.add(seg.end + collar)
    return times


def _active_matrix(ann: Annotation, grid: np.ndarray) -> Tuple[np.ndarray, List[int]]:
    """(num_intervals, num_labels) activity over half-open grid intervals."""
    labels = ann.labels
    mids = 0.5 * (grid[:-1] + grid[1:])
    act = np.zeros((len(mids), len(labels)), dtype=bool)
    for li, label in enumerate(labels):
        for seg in ann.segments(label):
            act[:, li] |= (mids >= seg.start) & (mids < seg.end)
    return act, labels


@dataclasses.dataclass
class DERComponents:
    missed: float
    false_alarm: float
    confusion: float
    total: float

    @property
    def der(self) -> float:
        return (
            (self.missed + self.false_alarm + self.confusion) / self.total
            if self.total > 0
            else 0.0
        )


def diarization_error_rate(
    reference: Annotation,
    hypothesis: Annotation,
    collar: float = 0.0,
    skip_overlap: bool = False,
) -> DERComponents:
    """Compute DER components between two annotations."""
    # collar edges must be grid points so scoring intervals never straddle
    # the forgiven region
    times = _boundaries(reference, collar=collar) | _boundaries(hypothesis)
    if not times:
        return DERComponents(0.0, 0.0, 0.0, 0.0)
    grid = np.array(sorted(times))
    if len(grid) < 2:
        return DERComponents(0.0, 0.0, 0.0, 0.0)
    durations = np.diff(grid)
    ref_act, ref_labels = _active_matrix(reference, grid)
    hyp_act, hyp_labels = _active_matrix(hypothesis, grid)

    # scoring mask: drop collar region around reference boundaries
    score_mask = np.ones(len(durations), dtype=bool)
    if collar > 0:
        mids = 0.5 * (grid[:-1] + grid[1:])
        for label in reference.labels:
            for seg in reference.segments(label):
                for b in (seg.start, seg.end):
                    score_mask &= ~(
                        (mids >= b - collar) & (mids < b + collar)
                    )
    if skip_overlap:
        score_mask &= ref_act.sum(axis=1) <= 1
    dur = durations * score_mask

    # optimal speaker mapping by overlap duration (Hungarian, maximize)
    overlap = np.zeros((len(ref_labels), len(hyp_labels)))
    for i in range(len(ref_labels)):
        for j in range(len(hyp_labels)):
            overlap[i, j] = np.sum(dur * (ref_act[:, i] & hyp_act[:, j]))
    mapping: Dict[int, int] = {}
    if overlap.size:
        try:
            from scipy.optimize import linear_sum_assignment

            ri, hj = linear_sum_assignment(-overlap)
            mapping = dict(zip(ri, hj))
        except ImportError:  # greedy fallback
            used_r, used_h = set(), set()
            for flat in np.argsort(-overlap, axis=None):
                i, j = divmod(flat, overlap.shape[1])
                if i in used_r or j in used_h or overlap[i, j] <= 0:
                    continue
                mapping[i] = j
                used_r.add(i)
                used_h.add(j)

    n_ref = ref_act.sum(axis=1).astype(np.float64)
    n_hyp = hyp_act.sum(axis=1).astype(np.float64)
    # per-interval number of correctly matched speakers
    n_correct = np.zeros(len(durations))
    for i, j in mapping.items():
        n_correct += (ref_act[:, i] & hyp_act[:, j]).astype(np.float64)

    total = float(np.sum(dur * n_ref))
    missed = float(np.sum(dur * np.maximum(n_ref - n_hyp, 0.0)))
    false_alarm = float(np.sum(dur * np.maximum(n_hyp - n_ref, 0.0)))
    confusion = float(np.sum(dur * (np.minimum(n_ref, n_hyp) - n_correct)))
    return DERComponents(missed, false_alarm, confusion, total)


def der(reference: Annotation, hypothesis: Annotation, collar: float = 0.0) -> float:
    return diarization_error_rate(reference, hypothesis, collar=collar).der


def main(argv=None) -> int:
    """One-command DER between two RTTM files:

        python -m pyannote_audio_speaker_diarization_cpp_tpu_torch.metrics.der \\
            reference.rttm hypothesis.rttm [--collar 0.25]

    Pairs with ``cli.py --rttm`` for end-to-end accuracy measurement against
    a pyannote-produced reference (BASELINE.md accuracy target).
    """
    import argparse

    parser = argparse.ArgumentParser(description="diarization error rate")
    parser.add_argument("reference", help="reference RTTM file")
    parser.add_argument("hypothesis", help="hypothesis RTTM file")
    parser.add_argument("--collar", type=float, default=0.0)
    args = parser.parse_args(argv)
    ref = Annotation.from_rttm(open(args.reference).read())
    hyp = Annotation.from_rttm(open(args.hypothesis).read())
    comps = diarization_error_rate(ref, hyp, collar=args.collar)
    print(
        f"DER={comps.der:.4f} (missed={comps.missed:.3f}s "
        f"false_alarm={comps.false_alarm:.3f}s confusion={comps.confusion:.3f}s "
        f"total={comps.total:.3f}s collar={args.collar})"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
