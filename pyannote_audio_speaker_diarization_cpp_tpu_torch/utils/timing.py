"""Stage timers and the profiler hook.

The reference's only observability is wall-clock couts around each stage
(reference pipeline/src/speakerDiarizer.cpp:48-60, :3028/:3110/:3231;
SURVEY.md section 5.1). Here: accumulating timers whose spans end only when
the card has finished the work launched in them, and a context manager
around ``torch.profiler`` for device traces. The port of the JAX package's
utils/timing.py.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch


class StageTimer:
    """Accumulating named wall-clock timers that fence device work: each span
    ends with ``torch.cuda.synchronize()`` where there is a card."""

    def __init__(self) -> None:
        self.times: Dict[str, float] = {}

    @contextlib.contextmanager
    def time(self, name: str):
        """Times a block, ended by a wait for the card; yields a list, as the
        JAX package's timer does (its arrays to block on; here the wait
        covers every launch, so appending to it is optional):

            with timer.time("seg") as fence:
                out = model(x)
                fence.append(out)
        """
        fence: list = []
        t0 = time.perf_counter()
        try:
            yield fence
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        total = sum(self.times.values())
        lines = [f"{k}: {v*1000:.1f}ms" for k, v in self.times.items()]
        lines.append(f"total: {total*1000:.1f}ms")
        return "\n".join(lines)


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str] = None):
    """Capture a ``torch.profiler`` trace of the block (host and, where a
    card is present, CUDA activity) and write it as a Chrome trace under
    ``log_dir`` (view it in Perfetto or chrome://tracing); yields the
    profiler, or None when ``log_dir`` is None (nothing is traced). The
    counterpart of the JAX package's ``xprof_trace``."""
    if log_dir is None:
        yield None
        return
    import os

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def realtime_factor(audio_seconds: float, wall_seconds: float) -> float:
    """audio-seconds processed per wall-clock second."""
    return audio_seconds / wall_seconds if wall_seconds > 0 else float("inf")
