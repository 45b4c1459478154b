"""Sliding-window frame bookkeeping.

Re-design of the reference's `SlidingWindow` / `SlidingWindowFeature`
(reference pipeline/src/speakerDiarizer.cpp:1029-1159, vendored pyannote.core
originals at segment/utils.py:329-860). All math here is exact host-side frame
bookkeeping — banker's rounding included — because off-by-one frame indices are
the easiest way to silently diverge from the reference (SURVEY.md section 7,
"hard parts").
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List

import numpy as np

from .segment import Segment


@dataclasses.dataclass(frozen=True)
class SlidingWindow:
    """A regular grid of (possibly overlapping) frames.

    Frame ``i`` covers ``[start + i*step, start + i*step + duration]``.
    """

    start: float = 0.0
    step: float = 0.0
    duration: float = 0.0
    num_samples: int = 0
    sample_rate: int = 16000

    def __getitem__(self, i: int) -> Segment:
        s = self.start + i * self.step
        return Segment(s, s + self.duration)

    def closest_frame(self, t: float) -> int:
        """Index of the frame whose middle is closest to timestamp ``t``.

        Uses round-half-to-even like np.rint — the reference depends on this
        exact rounding (speakerDiarizer.cpp:1110-1116 clamps negatives to 0;
        the Python original segment/utils.py:409-425 does not, but every call
        site uses t >= start so both agree).
        """
        closest = (t - self.start - 0.5 * self.duration) / self.step
        if closest < 0.0:
            closest = 0.0
        return int(np.rint(closest))

    def chunk_segments(self) -> List[Segment]:
        """Enumerate chunk segments over an audio of ``num_samples`` samples.

        Emits one segment per sliding chunk, including the orphan last chunk,
        matching `SlidingWindow::data` (speakerDiarizer.cpp:1137-1158): emit
        at the current start, stop once the window reaches past the end.
        """
        window_size = round(self.duration * self.sample_rate)
        step_size = round(self.step * self.sample_rate)
        segments = []
        start = 0.0
        cur = 0
        while True:
            segments.append(Segment(start, start + self.duration))
            if cur + window_size >= self.num_samples:
                break
            start += self.step
            cur += step_size
        return segments

    def crop_range(self, focus: Segment) -> tuple[int, int]:
        """Frame index range [i, j) of frames intersecting ``focus`` (mode
        'loose'), following pyannote.core SlidingWindow.crop as replicated in
        crop_segment (speakerDiarizer.cpp:2576-2588)."""
        i_ = (focus.start - self.duration - self.start) / self.step
        i = int(np.ceil(i_))
        if i < 0:
            i = 0
        j_ = (focus.end - self.start) / self.step
        j = int(np.floor(j_)) + 1
        return i, j

    def extent(self, n_frames: int) -> Segment:
        """Time extent covered by the first ``n_frames`` frames.

        Matches the extent computation in to_diarization
        (speakerDiarizer.cpp:2687-2701): start of frame -0.5's middle plus
        n*step of duration.
        """
        start = self.start + (0 - 0.5) * self.step + 0.5 * self.duration
        return Segment(self.start, start + n_frames * self.step)

    def __iter__(self) -> Iterator[Segment]:
        i = 0
        while True:
            yield self[i]
            i += 1


@dataclasses.dataclass
class SlidingWindowFeature:
    """(num_chunks | num_frames, ...) feature array + its frame grid."""

    data: np.ndarray
    sliding_window: SlidingWindow

    def __len__(self) -> int:
        return self.data.shape[0]

    def __iter__(self):
        for i in range(self.data.shape[0]):
            yield self.sliding_window[i], self.data[i]


def num_chunks_for_samples(num_samples: int, window_size: int, step_size: int) -> tuple[int, bool]:
    """(num_complete_chunks, has_orphan_last_chunk) for a waveform.

    Matches Segmentation.slide (segment/segment.py:79-93 and
    speakerDiarizer.cpp:1419-1480).
    """
    if num_samples >= window_size:
        num_complete = (num_samples - window_size) // step_size + 1
    else:
        num_complete = 0
    has_last = (num_samples < window_size) or ((num_samples - window_size) % step_size > 0)
    return num_complete, has_last
