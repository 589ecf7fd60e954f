"""Fixed-memory sliding-window aggregators for live SLO/health math (copy
of ``repro/obs/windows.py``, §14.1).

The registry's ``Histogram`` is an ALL-TIME instrument: fixed buckets,
percentiles over every observation since process start. Health monitoring
needs the opposite — "what does the LAST minute look like" — without
letting a week-long run grow state. This module is the windowed
counterpart, three primitives, all O(capacity) memory forever:

  SlidingWindow   ring buffer over the last ``capacity`` values: EXACT
                  p50/p90/p99 (numpy 'linear' convention), mean/min/max,
                  median, MAD, and the robust MAD z-score the anomaly
                  detectors run on (obs/health.py).
  WindowedRate    ring buffer of event timestamps: events/sec over a
                  trailing wall-clock window (throughput, anomaly rates).

Why MAD and not stddev: one grad-norm blow-up at step N would inflate a
windowed stddev for the next ``capacity`` steps, masking follow-up
spikes exactly when they matter. Median/MAD have a 50% breakdown point —
half the window must be outliers before the scale estimate moves — so
detection stays sharp through the episode (DESIGN.md §14.1).

``push``/``mark`` are a few Python ops under a lock; percentile/MAD sort
the window on demand — the detectors call them once per step on windows of a
few hundred entries, microseconds of host time.
"""
from __future__ import annotations

import math
import threading
import time
from typing import List, Optional, Sequence

# Phi^-1(0.75): scales MAD to estimate sigma under normality, so the MAD
# z-score reads in ordinary "standard deviations" units
MAD_TO_SIGMA = 0.6744897501960817


def percentile(values: Sequence[float], q: float) -> float:
    """Exact linear-interpolated percentile of ``values`` (numpy 'linear'
    convention); NaN for an empty sequence, so callers render "no data"
    instead of crashing mid-report."""
    if not 0 <= q <= 100:
        raise ValueError(f"percentile q={q} outside [0, 100]")
    xs = sorted(values)
    if not xs:
        return math.nan
    pos = q / 100.0 * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


class SlidingWindow:
    """Ring buffer over the last ``capacity`` float values.

    ``push`` overwrites the oldest entry once full — memory is fixed at
    construction no matter how many values flow through. All statistics
    are computed over the CURRENT window contents only; empty-window
    queries return NaN (never raise), so detectors warming up read as
    "no signal" rather than crashing.
    """

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._buf: List[float] = [0.0] * self.capacity
        self._next = 0            # ring write cursor
        self._n = 0               # values currently held (<= capacity)
        self._total = 0           # values ever pushed
        self._lock = threading.Lock()

    def push(self, v: float) -> None:
        """Append one value, evicting the oldest once at capacity."""
        v = float(v)
        with self._lock:
            self._buf[self._next] = v
            self._next = (self._next + 1) % self.capacity
            self._n = min(self._n + 1, self.capacity)
            self._total += 1

    @property
    def count(self) -> int:
        """Values currently in the window (<= capacity)."""
        with self._lock:
            return self._n

    @property
    def total(self) -> int:
        """Values ever pushed (survives eviction)."""
        with self._lock:
            return self._total

    @property
    def full(self) -> bool:
        """True once the ring has wrapped at least once."""
        with self._lock:
            return self._n == self.capacity

    def values(self) -> List[float]:
        """Window contents, oldest first (a copy — safe to mutate)."""
        with self._lock:
            if self._n < self.capacity:
                return self._buf[:self._n]
            return self._buf[self._next:] + self._buf[:self._next]

    def mean(self) -> float:
        """Mean over the window; NaN when empty."""
        vals = self.values()
        return sum(vals) / len(vals) if vals else math.nan

    def min(self) -> float:
        """Smallest value in the window; NaN when empty."""
        vals = self.values()
        return min(vals) if vals else math.nan

    def max(self) -> float:
        """Largest value in the window; NaN when empty."""
        vals = self.values()
        return max(vals) if vals else math.nan

    def percentile(self, q: float) -> float:
        """EXACT windowed percentile (module-level ``percentile`` over the
        current contents — no bucket approximation; the window is small
        by construction)."""
        return percentile(self.values(), q)

    def median(self) -> float:
        """Windowed median (= ``percentile(50)``)."""
        return self.percentile(50)

    def mad(self) -> float:
        """Median absolute deviation around the windowed median; NaN when
        empty. The robust scale estimate the z-score uses."""
        vals = self.values()
        if not vals:
            return math.nan
        med = percentile(vals, 50)
        return percentile([abs(v - med) for v in vals], 50)

    def zscore(self, v: float) -> float:
        """Robust MAD z-score of ``v`` against the window:
        ``(v - median) / (MAD / MAD_TO_SIGMA)`` — reads in sigma units
        under normality. Degenerate windows degrade gracefully: when MAD
        is 0 (over half the window identical) the mean absolute deviation
        is the fallback scale; when that is 0 too (ALL values identical),
        the z-score is 0 for ``v == median`` and +/-inf otherwise — an
        exactly-flat signal makes any deviation infinitely surprising."""
        vals = self.values()
        if not vals:
            return math.nan
        med = percentile(vals, 50)
        scale = self.mad() / MAD_TO_SIGMA
        if scale == 0.0:
            # fallback: mean abs deviation, scaled by E|N(0,1)| = 0.7979
            scale = (sum(abs(x - med) for x in vals) / len(vals)) / 0.7979
        if scale == 0.0:
            if v == med:
                return 0.0
            return math.inf if v > med else -math.inf
        return (float(v) - med) / scale


class WindowedRate:
    """Events/sec over a trailing wall-clock window.

    Keeps up to ``capacity`` event timestamps in a ring; ``rate()``
    counts the ones inside the last ``window_s`` seconds. When events
    arrive faster than ``capacity`` per window the rate saturates at
    ``capacity / window_s`` (fixed memory beats exactness for a health
    signal — the saturated value still reads "very hot").
    """

    def __init__(self, window_s: float = 60.0, capacity: int = 1024,
                 clock=time.monotonic):
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        self.window_s = float(window_s)
        self._times = SlidingWindow(capacity)
        self._clock = clock

    def mark(self, n: int = 1) -> None:
        """Record ``n`` events at the current clock time."""
        now = self._clock()
        for _ in range(int(n)):
            self._times.push(now)

    @property
    def total(self) -> int:
        """Events ever marked."""
        return self._times.total

    def rate(self, now: Optional[float] = None) -> float:
        """Events/sec over the trailing window (0.0 when no recent
        events)."""
        now = self._clock() if now is None else float(now)
        cutoff = now - self.window_s
        recent = sum(1 for t in self._times.values() if t > cutoff)
        return recent / self.window_s
