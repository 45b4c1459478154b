"""The device trace of a run's window: ``torch.profiler`` over the window,
reduced to flat lists of (name, start s, end s) for the device's kernels,
copies and memsets and for the host's operations.

The card's profiler has been seen to drop the first tens of milliseconds
of a session, and its device and host clocks to disagree by milliseconds.
So the session starts with a host sleep and a marker kernel
(``torch.cuda._sleep``); device events are kept from the marker on, and
host times are moved onto the device clock by the offset between the
marker's launch and its start.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from typing import Dict, List, Tuple

Span = Tuple[str, float, float]


class Trace:
    def __init__(self):
        self.device: List[Span] = []
        self.host: List[Span] = []
        self.window: Tuple[float, float] = (0.0, 0.0)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def kernels(self) -> List[Span]:
        return [e for e in self.device if not _is_copy(e[0])]

    def busy_s(self) -> float:
        """Seconds in the window in which some device operation ran."""
        return union_length([(s, e) for _, s, e in self.device], *self.window)

    def gaps(self) -> List[Tuple[float, float]]:
        """Idle stretches of the device inside the window, in time order."""
        out, at = [], self.window[0]
        for s, e in merged([(s, e) for _, s, e in self.device]):
            if s > at:
                out.append((at, min(s, self.window[1])))
            at = max(at, e)
        if at < self.window[1]:
            out.append((at, self.window[1]))
        return [(s, e) for s, e in out if e > s]

    def breakdown(self, top: int = 10) -> Dict:
        """The device operations that took most time, and the longest idle
        gaps by what the host was doing as each began (its innermost
        operation)."""
        by_name: Dict[str, float] = {}
        for n, s, e in self.device:
            by_name[n] = by_name.get(n, 0.0) + (e - s)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:top]
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        idle = []
        for s, e in gaps:
            i = bisect.bisect_right(starts, s)
            inner, width = "host_python", float("inf")
            for n, hs, he in host[max(0, i - 400) : i]:
                if hs <= s < he and he - hs < width:
                    inner, width = f"host_{n}", he - hs
            idle.append([inner, e - s])
        return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": idle}


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def merged(spans):
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def union_length(spans, lo: float, hi: float) -> float:
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in merged(spans))


class Incomplete(RuntimeError):
    """The profiler dropped a marker kernel: the window cannot be placed."""


@contextlib.contextmanager
def traced(torch, enabled: bool, lead_s: float = 0.5):
    """Profile the body; yields the Trace, filled when the body has run.
    The window is from the body's start (after the marker) to its end, both
    read from the device clock (a marker kernel at each end), after a host
    sleep of ``lead_s``; raises Incomplete when a marker is missing. Only CUDA
    activity is recorded: the host's side of it is the runtime's calls
    (launches, copies, waits). Recording the host's operators too slowed
    the traced window of the meetings cell from 292 to 213 audio-s/s
    (446 untraced) on one H100."""
    tr = Trace()
    if not enabled:
        yield tr
        return
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(lead_s)
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        yield tr
        torch.cuda.synchronize()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    events = prof.profiler.kineto_results.events()
    dev, host, launch_at = [], [], {}
    for ev in events:
        span = (ev.name(), ev.start_ns() * 1e-9, (ev.start_ns() + ev.duration_ns()) * 1e-9)
        if ev.device_type() == DeviceType.CUDA:
            dev.append(span + (ev.correlation_id(),))
        else:
            host.append(span)
            if "LaunchKernel" in span[0]:
                launch_at[ev.correlation_id()] = span[1]
    dev.sort(key=lambda x: x[1])
    markers = [i for i, d in enumerate(dev) if "spin_kernel" in d[0]]
    if len(markers) < 2:
        raise Incomplete(f"the trace holds {len(markers)} of its 2 marker kernels")
    first, last = markers[0], markers[-1]
    tr.window = (dev[first][2], dev[last][1])
    tr.device = [d[:3] for d in dev[first + 1 : last]]
    # the host's launch of the first marker against its device start: the
    # offset between the two clocks (the launch latency, some microseconds,
    # is in it)
    offset = dev[first][1] - launch_at.get(dev[first][3], dev[first][1])
    lo = tr.window[0]
    tr.host = [(n, s + offset, e + offset) for n, s, e in host if e + offset >= lo]
