"""The program's own spans (``StageTimings.spans``), read by the per-layer
metrics, and placed on the device trace's clock.

Each request's ``StageTimings`` holds a list of spans ``(name, parent
index, start ns, end ns, counters)`` stamped on the host's monotonic clock
(``time.perf_counter_ns``). A program that records none (an older one)
gives None from every reader here.

The clock fit: each ``*.wait`` span brackets exactly one stream synchronize
of the program, and the trace lists the host's ``cudaStreamSynchronize``
calls on the device clock (``benchmark/trace.py`` moved them there). The
offset most wait/call pairs of like length agree on pairs them; a least-
squares line through the pairs' starts and ends gives the offset, and a
rate when the residuals drift. The fit checks itself: unless at least
``MIN_SHARE`` of the waits land within ``TOL_S`` of a call at both ends,
the readers that need the device clock return None.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from .trace import merged

TOL_S = 1e-4
MIN_SHARE = 0.95
SYNC = "cudaStreamSynchronize"
# the waits that propose an offset (the pairing is quadratic in them), and
# the proposed offsets refined
PROPOSERS = 64
CANDIDATES = 8


def requests_spans(ctx):
    """[spans of each request] of the window, or None when the program
    records no spans."""
    out = [getattr(r.timings, "spans", None) for r in ctx["requests"]]
    if not out or any(s is None for s in out):
        return None
    return out


def named_ms_per_audio_min(ctx, keep) -> Optional[float]:
    """Milliseconds of every span whose name ``keep`` accepts, per minute
    of audio; None when the program records no spans."""
    spans = requests_spans(ctx)
    if spans is None:
        return None
    ns = sum(s[3] - s[2] for rs in spans for s in rs if keep(s[0]))
    return 1e-6 * ns / (ctx["audio_s"] / 60.0)


def of_name(ctx, keep) -> List[Tuple[float, float]]:
    """(start s, end s) on the program's clock of every span whose name
    ``keep`` accepts, in time order."""
    spans = requests_spans(ctx) or []
    return sorted((s[2] * 1e-9, s[3] * 1e-9) for rs in spans for s in rs if keep(s[0]))


def route_shares(ctx):
    """{route: share of requests} from the ``collect`` roots' counter."""
    routes = [s[4]["route"] for rs in (requests_spans(ctx) or []) for s in rs
              if s[0] == "collect" and s[4]]
    return {r: routes.count(r) / len(routes) for r in sorted(set(routes))}


@dataclasses.dataclass
class ClockFit:
    """trace seconds = offset + rate * (program seconds - origin)."""

    origin: float
    offset: float
    rate: float
    waits: int
    matched: int
    # (start, end) residuals in seconds of every matched wait
    residuals: List[Tuple[float, float]]

    @property
    def ok(self) -> bool:
        return self.waits > 0 and self.matched >= MIN_SHARE * self.waits

    def at(self, t: float) -> float:
        return self.offset + self.rate * (t - self.origin)

    def worst_s(self) -> float:
        return _worst(self.residuals)


def _match(waits, syncs, fit: ClockFit, tol: float):
    """[(wait index, sync index)] of the waits that land within ``tol`` of
    a call at both ends, each call taken once."""
    starts = [s for s, _ in syncs]
    pairs, used = [], set()
    for i, (ws, we) in enumerate(waits):
        a, b = fit.at(ws), fit.at(we)
        k = bisect.bisect_left(starts, a)
        best = None
        for j in (k - 1, k):
            if 0 <= j < len(syncs) and j not in used:
                d = max(abs(syncs[j][0] - a), abs(syncs[j][1] - b))
                if d <= tol and (best is None or d < best[0]):
                    best = (d, j)
        if best is not None:
            used.add(best[1])
            pairs.append((i, best[1]))
    return pairs


def _line(waits, syncs, pairs, origin, with_rate: bool):
    x = np.array([[waits[i][0], waits[i][1]] for i, _ in pairs]).ravel() - origin
    y = np.array([[syncs[j][0], syncs[j][1]] for _, j in pairs]).ravel()
    if with_rate and np.ptp(x) > 0:
        y0 = float(np.mean(y))
        rate, intercept = np.polyfit(x, y - y0, 1)
        return y0 + float(intercept), float(rate)
    return float(np.mean(y - x)), 1.0


def fit_clock(waits, syncs, tol: float = TOL_S) -> Optional[ClockFit]:
    """Fit the program's clock (``waits``: [(start s, end s)]) onto the
    trace's (``syncs``: [(start s, end s)] of its synchronize calls); None
    when either list is empty."""
    if not waits or not syncs:
        return None
    waits, syncs = sorted(waits), sorted(syncs)
    origin = waits[0][0]
    w = np.array(waits[:PROPOSERS])
    y = np.array(syncs)
    wl, yl = w[:, 1] - w[:, 0], y[:, 1] - y[:, 0]
    i, j = np.nonzero(np.abs(wl[:, None] - yl[None, :]) <= 2 * tol)
    if len(i) == 0:
        return ClockFit(origin, 0.0, 1.0, len(waits), 0, [])
    # the offsets most pairs of like length agree on, within tol; requests
    # that repeat at a steady pace also agree on a whole request off, so
    # the densest few are each refined and the one that pairs most wins
    d = np.sort(y[j, 0] - w[i, 0])
    ends = np.searchsorted(d, d + tol, side="right")
    proposed = []
    for k in np.argsort(-(ends - np.arange(len(d))), kind="stable"):
        c = float(np.median(d[k : ends[k]]))
        if all(abs(c - o) > tol for o in proposed):
            proposed.append(c)
            if len(proposed) == CANDIDATES:
                break
    fits = [_refine(waits, syncs, ClockFit(origin, c + origin, 1.0, len(waits), 0, []), tol)
            for c in proposed]
    return max(fits, key=lambda f: (f.matched, -f.worst_s()))


def _refine(waits, syncs, fit: ClockFit, tol: float) -> ClockFit:
    """Pair under the fit and refit on the pairs, twice over; a rate only
    where it takes out most of what an offset alone leaves."""
    origin = fit.origin
    for _ in range(2):
        pairs = _match(waits, syncs, fit, tol)
        if not pairs:
            break
        plain = dataclasses.replace(fit)
        plain.offset, plain.rate = _line(waits, syncs, pairs, origin, with_rate=False)
        drift = dataclasses.replace(fit)
        drift.offset, drift.rate = _line(waits, syncs, pairs, origin, with_rate=True)
        worst = _worst(_residuals(waits, syncs, pairs, plain))
        fit = drift if _worst(_residuals(waits, syncs, pairs, drift)) < 0.5 * worst else plain
    pairs = _match(waits, syncs, fit, tol)
    fit.matched = len(pairs)
    fit.residuals = _residuals(waits, syncs, pairs, fit)
    return fit


def _residuals(waits, syncs, pairs, fit):
    return [(syncs[j][0] - fit.at(waits[i][0]), syncs[j][1] - fit.at(waits[i][1]))
            for i, j in pairs]


def _worst(res) -> float:
    return max((max(abs(a), abs(b)) for a, b in res), default=0.0)


def clock_fit(ctx) -> Optional[ClockFit]:
    """The window's fit (computed once a run), or None without spans, waits
    or a trace."""
    if "span_clock_fit" not in ctx:
        waits = of_name(ctx, lambda n: n.endswith(".wait"))
        syncs = [(s, e) for n, s, e in ctx["trace"].host if n == SYNC]
        ctx["span_clock_fit"] = fit_clock(waits, syncs)
    return ctx["span_clock_fit"]


def on_device_clock(ctx, name: str) -> Optional[List[Tuple[float, float]]]:
    """The spans called ``name`` on the trace's clock, merged; None without
    a fit that checks."""
    fit = clock_fit(ctx)
    if fit is None or not fit.ok:
        return None
    return merged([(fit.at(s), fit.at(e)) for s, e in of_name(ctx, lambda n: n == name)])


def overlap_s(gaps, spans, lo: float, hi: float) -> float:
    """Seconds of the disjoint, ordered ``gaps`` that lie inside the
    disjoint ``spans``, clipped to [lo, hi]."""
    if not gaps:
        return 0.0
    gs = np.array([g[0] for g in gaps])
    ge = np.array([g[1] for g in gaps])
    cum = np.concatenate([[0.0], np.cumsum(ge - gs)])
    total = 0.0
    for s, e in spans:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        i0 = int(np.searchsorted(ge, s, side="right"))
        i1 = int(np.searchsorted(gs, e, side="left"))
        if i1 <= i0:
            continue
        total += cum[i1] - cum[i0] - max(0.0, s - gs[i0]) - max(0.0, ge[i1 - 1] - e)
    return float(total)


def idle_share_in(ctx, root: str) -> Optional[float]:
    """Percent of the traced window in which the card was idle while the
    host was inside a ``root`` span; None without a trace or a fit."""
    tr = ctx["trace"]
    if tr.window_s <= 0 or not tr.device:
        return None
    spans = on_device_clock(ctx, root)
    if spans is None:
        return None
    return 100.0 * overlap_s(tr.gaps(), spans, *tr.window) / tr.window_s


def coverage(ctx) -> Optional[float]:
    """Share of the traced window's wall time inside a ``dispatch`` or
    ``collect`` root span; None without a fit."""
    tr = ctx["trace"]
    spans = on_device_clock(ctx, "dispatch")
    more = on_device_clock(ctx, "collect")
    if spans is None or more is None or tr.window_s <= 0:
        return None
    lo, hi = tr.window
    inside = sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in merged(spans + more))
    return inside / tr.window_s
