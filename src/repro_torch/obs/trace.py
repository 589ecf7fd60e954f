"""Span tracing: wall-time events in a ring buffer, Perfetto-exportable
(copy of ``repro/obs/trace.py``).

``with tracer.span("data_wait"):`` records one complete event (begin +
duration) into a bounded ring buffer — a long run never grows the buffer
past ``capacity``, the newest events win (``dropped`` counts evictions).
``to_chrome_trace()`` renders the buffer as Chrome ``trace_event`` JSON
(the ``{"traceEvents": [...]}`` object form) that loads directly in
Perfetto / ``chrome://tracing``; every event carries the required
``ph/ts/dur/pid/tid/name`` keys.

Lanes: ``pid`` is the LOGICAL process lane — the trainer records its
data-wait / device-step / ckpt-stall spans on pid 0 while the simulated
multi-host loader records each host's block generation on pid 1+host, so
a single-process simulation renders as the multi-host timeline it models.
``tid`` defaults to a small per-tracer id for the calling OS thread (the
prefetch / flush / checkpoint-writer threads get their own rows).

A ``None`` tracer is the disabled state: the module-level ``span(tracer,
name)`` helper yields immediately without reading the clock, so
uninstrumented runs pay nothing.
"""
from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import deque
from typing import Optional

REQUIRED_EVENT_KEYS = ("ph", "ts", "dur", "pid", "tid", "name")


class Tracer:
    """Ring-buffered span recorder with Chrome ``trace_event`` export."""

    def __init__(self, capacity: int = 8192):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._events: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._t0 = time.perf_counter_ns()
        self._tids: dict = {}
        self._process_names: dict = {0: "trainer"}
        self.dropped = 0

    # -- recording ---------------------------------------------------------
    def _now_us(self) -> float:
        return (time.perf_counter_ns() - self._t0) / 1e3

    def _tid(self) -> int:
        ident = threading.get_ident()
        with self._lock:
            tid = self._tids.get(ident)
            if tid is None:
                tid = self._tids[ident] = len(self._tids)
            return tid

    def _append(self, event: dict) -> None:
        with self._lock:
            if len(self._events) == self.capacity:
                self.dropped += 1
            self._events.append(event)

    @contextlib.contextmanager
    def span(self, name: str, *, pid: int = 0, tid: Optional[int] = None,
             **args):
        """Record a complete event named ``name`` around the ``with``
        body; ``args`` become the event's Perfetto-visible args."""
        t0 = self._now_us()
        try:
            yield self
        finally:
            event = {"ph": "X", "name": str(name), "ts": t0,
                     "dur": self._now_us() - t0, "pid": int(pid),
                     "tid": self._tid() if tid is None else int(tid)}
            if args:
                event["args"] = {k: _jsonable(v) for k, v in args.items()}
            self._append(event)

    def instant(self, name: str, *, pid: int = 0,
                tid: Optional[int] = None, **args) -> None:
        """Record a zero-duration marker (checkpoint published, resume,
        preemption)."""
        event = {"ph": "i", "s": "t", "name": str(name),
                 "ts": self._now_us(), "dur": 0.0, "pid": int(pid),
                 "tid": self._tid() if tid is None else int(tid)}
        if args:
            event["args"] = {k: _jsonable(v) for k, v in args.items()}
        self._append(event)

    def set_process_name(self, pid: int, name: str) -> None:
        """Label lane ``pid`` (rendered by Perfetto as the process name —
        e.g. pid 1+h as ``host h``)."""
        with self._lock:
            self._process_names[int(pid)] = str(name)

    # -- export ------------------------------------------------------------
    def events(self) -> list:
        """The buffered events, oldest first (copies — safe to mutate)."""
        with self._lock:
            return [dict(e) for e in self._events]

    def to_chrome_trace(self) -> dict:
        """Chrome ``trace_event`` object form: ``process_name`` metadata
        records for every named lane, then the buffered events. The
        top-level ``metadata`` object reports ``dropped`` (events evicted
        past ``capacity`` — a nonzero value means the timeline is
        truncated at the old end) alongside ``capacity`` and the exported
        event count."""
        with self._lock:
            events = [dict(e) for e in self._events]
            names = dict(self._process_names)
            dropped = self.dropped
        meta = [{"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                 "ts": 0, "dur": 0, "args": {"name": label}}
                for pid, label in sorted(names.items())]
        return {"traceEvents": meta + events, "displayTimeUnit": "ms",
                "metadata": {"dropped": dropped, "capacity": self.capacity,
                             "events": len(events)}}

    def export(self, path: str) -> str:
        """Write ``to_chrome_trace()`` JSON to ``path``; returns the
        path (point Perfetto's "Open trace file" at it)."""
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
            f.write("\n")
        return path


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


@contextlib.contextmanager
def span(tracer: Optional[Tracer], name: str, **kw):
    """``tracer.span(name, **kw)`` when ``tracer`` is a ``Tracer``; a free
    no-op when it is ``None`` — the one helper hot paths call so disabled
    tracing costs nothing."""
    if tracer is None:
        yield None
    else:
        with tracer.span(name, **kw):
            yield tracer
