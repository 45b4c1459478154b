"""Diarization annotations: labelled speech turns on a timeline.

Re-design of the reference's `Annotation`/`Track` structs
(reference pipeline/src/speakerDiarizer.cpp:862-1028; pyannote.core
Annotation.support at segment/utils.py and pyannote/core/annotation.py:1350).
Host-side only.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

from .segment import Segment


@dataclasses.dataclass
class Turn:
    segment: Segment
    label: int

    @property
    def start(self) -> float:
        return self.segment.start

    @property
    def end(self) -> float:
        return self.segment.end


class Annotation:
    """Mapping label -> list of segments, with pyannote-style post-processing."""

    def __init__(self) -> None:
        self._tracks: Dict[int, List[Segment]] = {}

    @property
    def labels(self) -> List[int]:
        return sorted(self._tracks)

    def add(self, start: float, end: float, label: int) -> None:
        self._tracks.setdefault(label, []).append(Segment(start, end))

    def segments(self, label: int) -> List[Segment]:
        return list(self._tracks.get(label, []))

    def support(self, collar: float = 0.0) -> "Annotation":
        """Merge same-label segments separated by a gap < ``collar``.

        Matches Track::support (speakerDiarizer.cpp:909-947): sort by start,
        merge while the (signed) gap is strictly below the collar — so
        overlapping segments (negative gap) always merge.
        """
        out = Annotation()
        for label, segs in self._tracks.items():
            if not segs:
                continue
            ordered = sorted(segs, key=lambda s: s.start)
            cur = ordered[0]
            merged: List[Segment] = []
            for nxt in ordered[1:]:
                if cur.gap(nxt) < collar:
                    cur = cur.merge(nxt)
                else:
                    merged.append(cur)
                    cur = nxt
            merged.append(cur)
            out._tracks[label] = merged
        return out

    def remove_short(self, min_duration_on: float) -> "Annotation":
        """Drop segments shorter than ``min_duration_on``.

        The reference's Track::removeShort (speakerDiarizer.cpp:949-959)
        skips index 0 of each track; that is a quirk never exercised because
        min_duration_on is 0.0 in the recipe (speakerDiarizer.cpp:3229). We
        implement the pyannote semantics: drop every too-short segment.
        """
        out = Annotation()
        for label, segs in self._tracks.items():
            kept = [s for s in segs if s.duration >= min_duration_on]
            if kept:
                out._tracks[label] = kept
        return out

    def turns(self) -> List[Turn]:
        """All turns sorted by start time (Annotation::finalResult,
        speakerDiarizer.cpp:963-984)."""
        res = [
            Turn(seg, label)
            for label, segs in self._tracks.items()
            for seg in segs
        ]
        res.sort(key=lambda t: (t.start, t.end, t.label))
        return res

    def crop(self, focus: Segment) -> "Annotation":
        """Intersect every turn with ``focus`` (used by DER computation)."""
        out = Annotation()
        for label, segs in self._tracks.items():
            for seg in segs:
                inter = seg & focus
                if inter:
                    out.add(inter.start, inter.end, label)
        return out

    def __str__(self) -> str:
        return "\n".join(
            f"[{t.start:.3f} -- {t.end:.3f}] --> Speaker_{t.label}"
            for t in self.turns()
        )

    def to_rttm(self, uri: str = "audio") -> str:
        """Serialize to RTTM (one SPEAKER line per turn)."""
        lines = []
        for t in self.turns():
            # 6 decimals: microsecond boundaries survive the roundtrip
            # (pyannote.core's Segment precision, segment/utils.py:68)
            lines.append(
                f"SPEAKER {uri} 1 {t.start:.6f} {t.segment.duration:.6f} "
                f"<NA> <NA> Speaker_{t.label} <NA> <NA>"
            )
        return "\n".join(lines)

    @staticmethod
    def from_rttm(text: str) -> "Annotation":
        ann = Annotation()
        for line in text.splitlines():
            parts = line.split()
            if not parts or parts[0] != "SPEAKER":
                continue
            start, dur = float(parts[3]), float(parts[4])
            label = parts[7]
            if label.startswith("Speaker_"):
                label = label[len("Speaker_"):]
            try:
                label_i = int(label)
            except ValueError:
                label_i = abs(hash(label)) % (10**9)
            ann.add(start, start + dur, label_i)
        return ann
