"""Micro-batching embedding engine (port of
``repro/serving/embed/batcher.py``).

Concurrent encode requests are queued per tower, coalesced into one of a
small set of padded batch shapes (the bucket ladder), and flushed either
when the largest bucket fills (size trigger) or when the oldest request has
waited ``max_delay_ms`` (deadline trigger). Callers get futures at once;
the flush path pads the coalesced batch up to the bucket size, so every
shape a tower ever runs is one of ``len(buckets)`` shapes per tower.

Padding replicates the last real example (never zeros: an all-pad attention
mask would give NaN rows); padded rows are dropped before futures resolve.

A payload is a dict of numpy arrays sharing a leading batch axis (the
reference batches any pytree). The engine calls the per-tower
``encode_fns`` it is handed and brings their output to host numpy.

Failure semantics: an encode-fn exception fails that cohort's futures; any
other exception inside the flush thread fails every pending future and the
worker keeps serving. Every future carries a per-request deadline
(``request_timeout_s``), so a bare ``result()`` never hangs for ever.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Callable, Dict, Sequence

import numpy as np
import torch

from repro_torch.obs import metrics as obs_metrics

DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64)

_STAT_KEYS = ("requests", "size_flushes", "deadline_flushes",
              "manual_flushes", "encoded_examples", "padded_examples",
              "batches", "worker_errors")


class DeadlineFuture(Future):
    """A Future whose bare ``result()``/``exception()`` wait at most until
    the request deadline instead of for ever."""

    _deadline = None  # monotonic seconds; set by the batcher at submit

    def _cap(self, timeout):
        if timeout is None and self._deadline is not None:
            return max(0.0, self._deadline - time.monotonic())
        return timeout

    def result(self, timeout=None):
        """``Future.result`` defaulting ``timeout`` to the request
        deadline."""
        return super().result(self._cap(timeout))

    def exception(self, timeout=None):
        """``Future.exception`` defaulting ``timeout`` to the request
        deadline."""
        return super().exception(self._cap(timeout))


class _Group:
    """One submit_many() call: a batched payload awaiting one future."""

    __slots__ = ("payload", "n", "future", "t_submit")

    def __init__(self, payload, n: int, t_submit: float,
                 deadline: float | None = None):
        self.payload = payload
        self.n = n
        self.future: DeadlineFuture = DeadlineFuture()
        self.future._deadline = deadline
        self.t_submit = t_submit


def _as_payload(payload) -> Dict[str, np.ndarray]:
    if not isinstance(payload, dict):
        raise TypeError(f"a payload is a dict of arrays, got "
                        f"{type(payload).__name__}")
    return {k: np.asarray(v) for k, v in payload.items()}


def _leading(payload) -> int:
    if not payload:
        raise ValueError("empty payload")
    ns = {v.shape[0] for v in payload.values()}
    if len(ns) != 1:
        raise ValueError("payload arrays disagree on the batch axis")
    return ns.pop()


def _shape_sig(payload):
    return tuple((k, tuple(v.shape[1:]), v.dtype.name)
                 for k, v in sorted(payload.items()))


def _host(out) -> np.ndarray:
    if isinstance(out, torch.Tensor):
        return out.detach().cpu().numpy()
    return np.asarray(out)


class MicroBatcher:
    """Queue → bucket → flush-on-size-or-deadline → futures.

    encode_fns: tower name -> fn(payload dict) -> (b, D) embeddings (numpy
    or a tensor on any device). The bucket ladder bounds how many batch
    shapes a fn ever sees.
    """

    def __init__(self, encode_fns: Dict[str, Callable], *,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 max_delay_ms: float = 2.0, request_timeout_s: float = 60.0,
                 autostart: bool = True, registry=None):
        if not buckets or any(b <= 0 for b in buckets):
            raise ValueError(f"bad bucket ladder {buckets}")
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.max_delay = float(max_delay_ms) / 1e3
        self.request_timeout = float(request_timeout_s)
        self._fns = dict(encode_fns)
        self._pending: Dict[str, list] = {t: [] for t in self._fns}
        self._cv = threading.Condition()
        self._compiled: Dict[tuple, int] = {}   # shape key -> batches run
        self._stop = False
        self._thread = None
        # counters, a queue-depth gauge and latency/occupancy histograms on
        # an obs registry (pass ``registry=`` to share one)
        self.metrics = registry if registry is not None \
            else obs_metrics.Registry()
        self._c = {k: self.metrics.counter(f"serve/{k}")
                   for k in _STAT_KEYS}
        self._g_queue = self.metrics.gauge("serve/queue_depth")
        self._h_request = self.metrics.histogram("serve/request_latency_s")
        self._h_flush = self.metrics.histogram("serve/flush_latency_s")
        self._h_occupancy = self.metrics.histogram(
            "serve/batch_occupancy", buckets=obs_metrics.RATIO_BUCKETS)
        if autostart:
            self.start()

    @property
    def stats(self) -> dict:
        """Dict-shaped view of the counters."""
        return {k: int(c.value) for k, c in self._c.items()}

    # -- lifecycle ---------------------------------------------------------
    @property
    def running(self) -> bool:
        """True while the flush thread runs."""
        return self._thread is not None and self._thread.is_alive()

    def start(self):
        """Start the flush thread (no-op when it runs)."""
        if self.running:
            return
        self._stop = False
        self._thread = threading.Thread(target=self._worker,
                                        name="microbatcher", daemon=True)
        self._thread.start()

    def stop(self):
        """Stop the flush thread and encode whatever is still pending."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        self.flush_now()

    # -- submission --------------------------------------------------------
    def submit(self, tower: str, example) -> Future:
        """One example (dict of arrays without the batch axis) -> Future of
        its (D,) embedding."""
        batched = {k: v[None] for k, v in _as_payload(example).items()}
        group = self._enqueue(tower, batched, 1)
        out = DeadlineFuture()
        out._deadline = group.future._deadline
        group.future.add_done_callback(
            lambda f: out.set_exception(f.exception()) if f.exception()
            else out.set_result(f.result()[0]))
        return out

    def submit_many(self, tower: str, payload) -> Future:
        """A batched payload (dict of arrays with the batch axis) -> Future
        of (n, D). The group stays contiguous but batches with other
        pending work."""
        payload = _as_payload(payload)
        return self._enqueue(tower, payload, _leading(payload)).future

    def _enqueue(self, tower: str, payload, n: int) -> _Group:
        if tower not in self._fns:
            raise KeyError(f"unknown tower {tower!r}; "
                           f"have {sorted(self._fns)}")
        now = time.monotonic()
        group = _Group(payload, n, now, deadline=now + self.request_timeout)
        with self._cv:
            self._pending[tower].append(group)
            self._g_queue.set(sum(g.n for gs in self._pending.values()
                                  for g in gs))
            self._cv.notify_all()
        self._c["requests"].inc(n)
        return group

    # -- flushing ----------------------------------------------------------
    def flush_now(self) -> int:
        """Synchronously encode everything pending (the manual trigger, and
        the thread-free path tests step with). Returns the number of
        examples encoded."""
        return sum(self._flush_tower(t, "manual_flushes")
                   for t in list(self._pending))

    def _worker(self):
        while True:
            try:
                with self._cv:
                    if self._stop:
                        return
                    deadline = self._earliest_deadline_locked()
                    if deadline is None:
                        self._cv.wait()
                    else:
                        now = time.monotonic()
                        if deadline > now and not self._size_due_locked():
                            self._cv.wait(timeout=deadline - now)
                    if self._stop:
                        return
                    due = [(t, "size_flushes" if self._size_due_locked(t)
                            else "deadline_flushes")
                           for t in self._pending if self._due_locked(t)]
                for tower, reason in due:
                    self._flush_tower(tower, reason)
            except Exception as e:  # noqa: BLE001 — a stranded future is a
                # caller blocked for ever, so every pending request fails
                # with the exception and the worker keeps serving
                self._c["worker_errors"].inc()
                self._fail_all_pending(e)

    def _fail_all_pending(self, exc: Exception) -> int:
        """Fail every queued (unflushed) request with ``exc``; returns how
        many futures were failed."""
        with self._cv:
            groups = [g for gs in self._pending.values() for g in gs]
            for tower in self._pending:
                self._pending[tower] = []
            self._g_queue.set(0)
        failed = 0
        for g in groups:
            if g.future.set_running_or_notify_cancel():
                g.future.set_exception(exc)
                failed += 1
        return failed

    def _earliest_deadline_locked(self):
        oldest = [g.t_submit for gs in self._pending.values() for g in gs]
        return min(oldest) + self.max_delay if oldest else None

    def _size_due_locked(self, tower=None) -> bool:
        towers = [tower] if tower else list(self._pending)
        return any(sum(g.n for g in self._pending[t]) >= self.buckets[-1]
                   for t in towers)

    def _due_locked(self, tower) -> bool:
        groups = self._pending[tower]
        if not groups:
            return False
        if sum(g.n for g in groups) >= self.buckets[-1]:
            return True
        return time.monotonic() - groups[0].t_submit >= self.max_delay

    def _flush_tower(self, tower: str, reason: str) -> int:
        with self._cv:
            groups, self._pending[tower] = self._pending[tower], []
            self._g_queue.set(sum(g.n for gs in self._pending.values()
                                  for g in gs))
        if not groups:
            return 0
        self._c[reason].inc()
        t_flush = time.monotonic()
        try:
            # only payloads with the same keys and per-example shapes may
            # coalesce; each cohort encodes separately
            cohorts: dict = {}
            for g in groups:
                cohorts.setdefault(_shape_sig(g.payload), []).append(g)
            for cohort in cohorts.values():
                self._encode_chunk(tower, cohort)
        except Exception as e:
            # groups are already popped: fail them before propagating, or
            # their callers would block until the deadline for nothing
            for g in groups:
                if not g.future.done():
                    g.future.set_exception(e)
            raise
        self._h_flush.observe(time.monotonic() - t_flush)
        return sum(g.n for g in groups)

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _encode_chunk(self, tower: str, groups: list):
        n = sum(g.n for g in groups)
        try:
            cat = {k: np.concatenate([g.payload[k] for g in groups])
                   for k in groups[0].payload}
            top = self.buckets[-1]
            outs = []
            # slice through the ladder so every encode is a bucket shape
            for s in range(0, n, top):
                part = {k: a[s:s + top] for k, a in cat.items()}
                m = next(iter(part.values())).shape[0]
                bucket = self._bucket_for(m)
                if bucket > m:  # replicate the last row up to the bucket
                    part = {k: np.concatenate(
                        [a, np.repeat(a[-1:], bucket - m, axis=0)])
                        for k, a in part.items()}
                key = (tower, bucket, _shape_sig(part))
                self._compiled[key] = self._compiled.get(key, 0) + 1
                outs.append(_host(self._fns[tower](part))[:m])
                self._c["padded_examples"].inc(bucket - m)
                self._c["batches"].inc()
                self._h_occupancy.observe(m / bucket)
            emb = np.concatenate(outs) if len(outs) > 1 else outs[0]
        except Exception as e:  # noqa: BLE001 — deliver, don't kill worker
            for g in groups:
                g.future.set_exception(e)
            return
        self._c["encoded_examples"].inc(n)
        off = 0
        done = time.monotonic()
        for g in groups:
            g.future.set_result(emb[off:off + g.n])
            self._h_request.observe(done - g.t_submit)
            off += g.n

    # -- observability -----------------------------------------------------
    def compiled_shapes(self):
        """{(tower, bucket, example-shape-sig): batches run}: its length is
        the number of distinct batch shapes the encoders have seen."""
        return dict(self._compiled)
