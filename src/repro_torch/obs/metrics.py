"""Metrics registry: counters, gauges, histograms (copy of
``repro/obs/metrics.py``).

The port's serving path (``MicroBatcher``, ``ZeroShotService``) hangs its
instruments off a ``Registry``; the batcher's dict-shaped ``stats`` is a
view over these counters.

Design constraints, in order:

  * off-hot-path cheap: an ``inc``/``observe`` is a couple of Python int
    ops under a per-instrument lock;
  * thread-safe: instruments are mutated from the micro-batcher flush
    thread and the callers' threads concurrently — every mutation and
    every read of an instrument's state takes its lock, and child creation
    takes the registry lock;
  * fixed memory: histograms are FIXED-BUCKET — ``observe`` never
    allocates, percentiles are interpolated from bucket counts at
    ``snapshot()`` time (§11.1 error bound: one bucket width).

Labeled children: ``registry.counter("serve/flushes", reason="size")``
returns the same child for the same ``(name, labels)`` — label maps are
part of the instrument identity, so per-tower / per-host series coexist
under one name.
"""
from __future__ import annotations

import bisect
import json
import math
import threading
from typing import Dict, Optional, Sequence, Tuple


def exponential_buckets(start: float, factor: float,
                        count: int) -> Tuple[float, ...]:
    """``count`` bucket upper bounds growing geometrically from ``start``
    (the standard latency-histogram ladder; an implicit +inf overflow
    bucket always follows)."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError(f"bad bucket spec start={start} factor={factor} "
                         f"count={count}")
    return tuple(start * factor ** i for i in range(count))


# 100µs … ~107s in ×2 steps: covers span costs through checkpoint writes
DEFAULT_LATENCY_BUCKETS_S = exponential_buckets(1e-4, 2.0, 20)
# occupancy/ratio instruments: linear [0, 1] in 0.1 steps
RATIO_BUCKETS = tuple(round(0.1 * i, 1) for i in range(1, 11))


def _label_key(labels: Dict[str, object]) -> Tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _series_name(name: str, labels: Dict[str, object]) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={v}" for k, v in _label_key(labels))
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonically increasing count (requests, flushes, retries)."""

    __slots__ = ("name", "labels", "_v", "_lock")

    def __init__(self, name: str, labels: Optional[Dict] = None):
        self.name = name
        self.labels = dict(labels or {})
        self._v = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        """Add ``n`` (must be >= 0) to the count."""
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (n={n})")
        with self._lock:
            self._v += n

    @property
    def value(self) -> int:
        """Current count."""
        with self._lock:
            return self._v


class Gauge:
    """Point-in-time level (queue depth, last checkpoint stall)."""

    __slots__ = ("name", "labels", "_v", "_lock")

    def __init__(self, name: str, labels: Optional[Dict] = None):
        self.name = name
        self.labels = dict(labels or {})
        self._v = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        """Set the level to ``v``."""
        with self._lock:
            self._v = float(v)

    def inc(self, n: float = 1.0) -> None:
        """Add ``n`` (may be negative) to the level."""
        with self._lock:
            self._v += n

    def dec(self, n: float = 1.0) -> None:
        """Subtract ``n`` from the level."""
        self.inc(-n)

    @property
    def value(self) -> float:
        """Current level."""
        with self._lock:
            return self._v


class Histogram:
    """Fixed-bucket histogram with interpolated percentile summaries.

    ``buckets`` are finite upper bounds (ascending); an implicit +inf
    overflow bucket follows. ``observe`` is O(log n_buckets) and never
    allocates; ``percentile`` linearly interpolates inside the bucket
    containing the target rank (clamped to the observed min/max), so its
    error is bounded by one bucket width — the policy trade for a
    fixed-memory hot-path instrument (§11.1).
    """

    __slots__ = ("name", "labels", "_bounds", "_counts", "_count", "_sum",
                 "_min", "_max", "_lock")

    def __init__(self, name: str, labels: Optional[Dict] = None,
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_S):
        bounds = tuple(float(b) for b in buckets)
        if not bounds or any(b2 <= b1 for b1, b2 in zip(bounds, bounds[1:])):
            raise ValueError(f"histogram {name}: bucket bounds must be "
                             f"non-empty and strictly ascending: {bounds}")
        self.name = name
        self.labels = dict(labels or {})
        self._bounds = bounds
        self._counts = [0] * (len(bounds) + 1)   # +1: overflow bucket
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        """Record one value (seconds for latency instruments)."""
        v = float(v)
        idx = bisect.bisect_left(self._bounds, v)
        with self._lock:
            self._counts[idx] += 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        """Number of observations."""
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        """Sum of observations."""
        with self._lock:
            return self._sum

    def percentile(self, q: float) -> float:
        """Interpolated ``q``-th percentile (0 <= q <= 100); NaN when
        empty. Exact to within one bucket width vs a sorted-array oracle
        (tests pin this against numpy)."""
        if not 0 <= q <= 100:
            raise ValueError(f"percentile q={q} outside [0, 100]")
        with self._lock:
            return self._percentile_locked(q)

    def _percentile_locked(self, q: float) -> float:
        if self._count == 0:
            return math.nan
        target = q / 100.0 * self._count
        cum = 0
        for i, n in enumerate(self._counts):
            if n == 0:
                continue
            if cum + n >= target:
                lo = self._bounds[i - 1] if i > 0 else self._min
                hi = self._bounds[i] if i < len(self._bounds) else self._max
                lo = max(lo, self._min)
                hi = min(hi, self._max)
                if hi <= lo:
                    return lo
                frac = (max(target, cum) - cum) / n
                return lo + (hi - lo) * frac
            cum += n
        return self._max

    def summary(self) -> dict:
        """``{count, sum, min, max, p50, p90, p99, buckets}`` snapshot
        (one lock acquisition — consistent across fields). ``buckets`` is
        the finite ``[upper_bound, cumulative_count]`` ladder the
        Prometheus exporter renders as ``_bucket{le=...}`` lines
        (``+Inf`` is implied by ``count``)."""
        with self._lock:
            buckets = []
            cum = 0
            for le, n in zip(self._bounds, self._counts):
                cum += n
                buckets.append([le, cum])
            if self._count == 0:
                return {"count": 0, "sum": 0.0, "min": None, "max": None,
                        "p50": None, "p90": None, "p99": None,
                        "buckets": buckets}
            return {"count": self._count, "sum": self._sum,
                    "min": self._min, "max": self._max,
                    "p50": self._percentile_locked(50),
                    "p90": self._percentile_locked(90),
                    "p99": self._percentile_locked(99),
                    "buckets": buckets}


class Registry:
    """Namespace of instruments; get-or-create by ``(name, labels)``.

    ``counter`` / ``gauge`` / ``histogram`` return the SAME child for the
    same name + label map (so call sites need not cache them, though hot
    paths do), and raise when a name is reused across instrument kinds.
    ``snapshot()`` renders everything into one plain dict — the shape the
    runlog's final ``metrics`` record and ``ZeroShotService.stats`` use.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._instruments: Dict[Tuple, object] = {}

    def _get(self, cls, name: str, labels: Dict, **kw):
        key = (name, _label_key(labels))
        with self._lock:
            inst = self._instruments.get(key)
            if inst is None:
                inst = cls(name, labels, **kw)
                self._instruments[key] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"{name!r} already registered as "
                    f"{type(inst).__name__}, requested {cls.__name__}")
            return inst

    def counter(self, name: str, **labels) -> Counter:
        """Get-or-create the counter ``name`` with ``labels``."""
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        """Get-or-create the gauge ``name`` with ``labels``."""
        return self._get(Gauge, name, labels)

    def histogram(self, name: str,
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS_S,
                  **labels) -> Histogram:
        """Get-or-create the histogram ``name`` with ``labels``;
        ``buckets`` only applies at creation."""
        return self._get(Histogram, name, labels, buckets=buckets)

    def series(self, prefix: str) -> dict:
        """Live instruments whose name starts with ``prefix``, keyed by
        label-qualified series name (``name{k=v}``) — the cheap way for a
        watcher (e.g. the straggler detector) to scan one instrument
        family without rendering a full ``snapshot()``."""
        with self._lock:
            instruments = list(self._instruments.values())
        return {_series_name(i.name, i.labels): i for i in instruments
                if i.name.startswith(prefix)}

    def snapshot(self) -> dict:
        """``{"counters": {...}, "gauges": {...}, "histograms": {...}}``
        with label-qualified series names (``name{k=v}``)."""
        with self._lock:
            instruments = list(self._instruments.values())
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for inst in instruments:
            series = _series_name(inst.name, inst.labels)
            if isinstance(inst, Counter):
                out["counters"][series] = inst.value
            elif isinstance(inst, Gauge):
                out["gauges"][series] = inst.value
            else:
                out["histograms"][series] = inst.summary()
        return out

    def to_json(self, *, indent: Optional[int] = None) -> str:
        """``snapshot()`` as a JSON string."""
        return json.dumps(self.snapshot(), indent=indent, sort_keys=True)


# the process-wide default registry: ad-hoc instrumentation that has no
# natural owner hangs off this one; subsystems that are instantiated many
# times per process (batcher, checkpoint manager, loader) default to a
# PRIVATE registry instead so their per-instance stats stay isolated
_REGISTRY = Registry()


def get_registry() -> Registry:
    """The process-wide default ``Registry``."""
    return _REGISTRY
