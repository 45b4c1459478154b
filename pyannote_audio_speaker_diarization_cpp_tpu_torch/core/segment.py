"""Time segments with microsecond precision.

Re-design of the reference's `Segment` struct
(reference pipeline/src/speakerDiarizer.cpp:802-860, vendored from
pyannote.core at segment/utils.py:11-327). Host-side bookkeeping only —
device code never sees these objects.
"""

from __future__ import annotations

import dataclasses
import math

# pyannote.core rounds segment boundaries to 1 microsecond when comparing
# (segment/utils.py:11 "precision 1 us").
_PRECISION = 1e-6


@dataclasses.dataclass(frozen=True, order=True)
class Segment:
    start: float
    end: float

    @property
    def duration(self) -> float:
        return self.end - self.start if self.end > self.start else 0.0

    @property
    def middle(self) -> float:
        return 0.5 * (self.start + self.end)

    def __bool__(self) -> bool:
        """A segment is non-empty iff end > start (up to precision)."""
        return bool(self.end - self.start > _PRECISION)

    def __and__(self, other: "Segment") -> "Segment":
        """Intersection (reference speakerDiarizer.cpp:2703-2705)."""
        return Segment(max(self.start, other.start), min(self.end, other.end))

    def intersects(self, other: "Segment") -> bool:
        return (
            (self.start < other.start and other.start < self.end - _PRECISION)
            or (other.start < self.start and self.start < other.end - _PRECISION)
            or (self.start == other.start)
        )

    def gap(self, other: "Segment") -> float:
        """Signed gap between two segments; negative if they overlap.

        Mirrors `Segment::gap` used by Annotation.support
        (speakerDiarizer.cpp:925-947).
        """
        if other.start >= self.end:
            return other.start - self.end
        if self.start >= other.end:
            return self.start - other.end
        # overlapping: negative overlap length
        return max(self.start, other.start) - min(self.end, other.end)

    def merge(self, other: "Segment") -> "Segment":
        """Union hull of two segments."""
        return Segment(min(self.start, other.start), max(self.end, other.end))

    def __str__(self) -> str:
        return f"[{self.start:.9g} -- {self.end:.9g}]"


def crop_range(
    segment_start: float,
    segment_end: float,
    num_samples: int,
    sample_rate: int,
    duration: float | None = None,
):
    """Sample range + padding for cropping `segment` out of a waveform.

    Returns (start_frame, end_frame, pad_start, pad_end) following the
    reference `SegmentModel::crop` / pyannote Audio.crop semantics
    (speakerDiarizer.cpp:1641-1663, segment/segment.py:322-354): floor-based
    sample indexing, zero padding outside the waveform.
    """
    start_frame = math.floor(segment_start * sample_rate)
    if duration is not None:
        num_frames = math.floor(duration * sample_rate)
        end_frame = start_frame + num_frames
    else:
        end_frame = math.floor(segment_end * sample_rate)
    pad_start = -min(0, start_frame)
    pad_end = max(end_frame, num_samples) - num_samples
    start_frame = max(0, start_frame)
    end_frame = min(end_frame, num_samples)
    return start_frame, end_frame, pad_start, pad_end
