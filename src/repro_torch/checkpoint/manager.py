"""Async checkpoint manager: hide serialization behind the train step
(port of ``repro/checkpoint/manager.py``).

A blocking ``io.save`` stalls the step for the full copy to the host,
serialization, hashing and rename. The manager splits the save at the only
true synchronization point:

  save_async(step, tree)  — ``io.snapshot`` runs on the calling thread (a
      plain synchronous copy of every leaf to host memory, so the next
      in-place optimizer step cannot change what is written), then
      serialize + hash + atomic rename happen on a background thread. The
      call returns as soon as the leaves are host copies; the stall it
      cost the caller is the ``ckpt/last_stall_s`` gauge.

Ordering and failure contract:

  * writes are serialized: a new ``save``/``save_async``/``wait`` first
    joins the in-flight write, so step dirs appear in order and at most one
    background writer exists;
  * a failed background write is never silent: its exception is re-raised
    on the NEXT ``wait()``/``save*`` call (callers see the failure at the
    next checkpoint boundary, the train loop's natural recovery point);
  * each write attempt retries transient ``OSError`` with capped
    exponential backoff before giving up (``max_retries``/``backoff_s``);
  * ``sync=True`` degrades to the blocking path (also what a trainer
    flips to after a persistent async failure, ``degrade_to_sync``);
  * retention runs after every successful write on the same thread:
    ``keep_last`` newest steps survive plus every ``keep_every``-th
    "keep" step (0 disables retention entirely).
"""
from __future__ import annotations

import threading
import time

from repro_torch.checkpoint import io
from repro_torch.obs import metrics as obs_metrics

_STAT_KEYS = ("saves", "async_saves", "sync_saves", "retried_writes",
              "failed_writes", "gc_removed", "degraded")


class AsyncCheckpointManager:
    """Background-writing checkpointer with retry, deferred-error
    surfacing, and retention GC (see module docstring for the contract).
    Use as a context manager or call ``close()`` so the final write is
    joined before process exit.

    Telemetry: counters, the ``ckpt/write_latency_s``
    histogram (full serialize+hash+rename, observed on whichever thread
    writes) and the ``ckpt/last_stall_s`` gauge (how long the last
    ``save*`` held the CALLER — the step-path cost) live on an
    ``obs.metrics.Registry`` (``metrics`` attribute; pass ``registry=``
    to share the run's). ``stats`` is a read-only dict view of the
    counters."""

    def __init__(self, directory: str, *, sync: bool = False,
                 keep_last: int = 0, keep_every: int = 0,
                 max_retries: int = 3, backoff_s: float = 0.05,
                 backoff_max_s: float = 1.0, registry=None):
        self.directory = directory
        self.sync = bool(sync)
        self.keep_last = int(keep_last)
        self.keep_every = int(keep_every)
        self.max_retries = int(max_retries)
        self.backoff_s = float(backoff_s)
        self.backoff_max_s = float(backoff_max_s)
        self._thread = None
        self._error = None
        self._error_step = None
        self.metrics = registry if registry is not None \
            else obs_metrics.Registry()
        self._c = {k: self.metrics.counter(f"ckpt/{k}") for k in _STAT_KEYS}
        self._h_write = self.metrics.histogram("ckpt/write_latency_s")
        self._g_stall = self.metrics.gauge("ckpt/last_stall_s")

    @property
    def stats(self) -> dict:
        """The counters as a dict of ints, by name."""
        return {k: int(c.value) for k, c in self._c.items()}

    def degrade_to_sync(self) -> None:
        """Flip to blocking saves permanently (the trainer's response to
        a persistent async-write failure) and count the transition."""
        if not self.sync:
            self.sync = True
            self._c["degraded"].inc()

    # -- lifecycle ---------------------------------------------------------
    @property
    def in_flight(self) -> bool:
        """True while a background write is still running."""
        return self._thread is not None and self._thread.is_alive()

    def wait(self) -> None:
        """Join the in-flight write (no-op when idle) and re-raise the
        deferred exception of a write that failed since the last call —
        the single point where background errors surface."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, step = self._error, self._error_step
            self._error = self._error_step = None
            raise io.CheckpointError(
                f"async checkpoint write for step {step} failed after "
                f"{self.max_retries + 1} attempts") from err

    def close(self) -> None:
        """Drain the in-flight write; raises if it failed."""
        self.wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        # don't mask an in-body exception with a pending write error
        if exc and exc[0] is not None:
            try:
                self.wait()
            except io.CheckpointError:
                pass
        else:
            self.close()
        return False

    # -- saving ------------------------------------------------------------
    def save(self, step: int, tree, meta=None):
        """Checkpoint ``tree`` at ``step``: asynchronously unless the
        manager is in ``sync`` mode. Joins (and surfaces errors of) any
        previous write first."""
        if self.sync:
            return self.save_sync(step, tree, meta=meta)
        return self.save_async(step, tree, meta=meta)

    def save_sync(self, step: int, tree, meta=None) -> str:
        """Blocking save (the degraded/final-checkpoint path): join any
        in-flight write, then snapshot + serialize + rename on the calling
        thread, with the same retry/backoff. Returns the step-dir path."""
        t0 = time.perf_counter()
        self.wait()
        arrs, treedef = io.snapshot(tree)
        path = self._write_with_retry(step, arrs, treedef, meta)
        self._gc()
        self._c["saves"].inc()
        self._c["sync_saves"].inc()
        self._g_stall.set(time.perf_counter() - t0)
        return path

    def save_async(self, step: int, tree, meta=None) -> None:
        """Snapshot leaves to host now; serialize + atomically rename on a
        background thread. Raises a previous write's deferred failure
        before snapshotting (in which case THIS save does not start —
        callers fall back, e.g. to ``save_sync``)."""
        t0 = time.perf_counter()
        self.wait()
        arrs, treedef = io.snapshot(tree)

        def work():
            try:
                self._write_with_retry(step, arrs, treedef, meta)
                self._gc()
            except BaseException as e:  # noqa: BLE001 — surfaced in wait()
                self._c["failed_writes"].inc()
                self._error, self._error_step = e, step
        self._thread = threading.Thread(target=work, daemon=True,
                                        name=f"ckpt-save-{step}")
        self._thread.start()
        self._c["saves"].inc()
        self._c["async_saves"].inc()
        self._g_stall.set(time.perf_counter() - t0)

    # -- internals ---------------------------------------------------------
    def _write_with_retry(self, step, arrs, treedef, meta):
        delay = self.backoff_s
        for attempt in range(self.max_retries + 1):
            t0 = time.perf_counter()
            try:
                path = io.write_snapshot(self.directory, step, arrs,
                                         treedef, meta=meta)
                self._h_write.observe(time.perf_counter() - t0)
                return path
            except OSError:
                if attempt == self.max_retries:
                    raise
                self._c["retried_writes"].inc()
                time.sleep(delay)
                delay = min(delay * 2.0, self.backoff_max_s)

    def _gc(self):
        if self.keep_last > 0:
            removed = io.gc_steps(self.directory, keep_last=self.keep_last,
                                  keep_every=self.keep_every)
            self._c["gc_removed"].inc(len(removed))
