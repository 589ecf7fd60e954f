"""Input pipeline: deterministic shard-aware batching with prefetch (copy
of ``repro/data/pipeline.py``, numpy only).

Host-side (numpy) generation, double-buffered via a background thread, with
per-host sharding (each host draws its slice of the global batch from a
host-indexed PRNG stream — the multi-host analog of the paper's input
distribution where "B examples are distributed equally to all cores").
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator

import numpy as np


class Prefetcher:
    """Wrap a batch-producing callable into a prefetching iterator.

    ``close()`` is idempotent and fully shuts the pipeline down: the worker
    thread exits, already-prefetched batches remain consumable, and once
    the queue drains ``__next__`` raises ``StopIteration``. ``__next__``
    waits with a timed get so a consumer blocked on an empty queue wakes
    up and terminates — after ``close()``, or when the worker died —
    instead of hanging forever (the historical deadlock); a worker killed
    by a ``make_batch`` exception re-raises it at the consumer."""

    def __init__(self, make_batch: Callable[[int], object], depth: int = 2,
                 start: int = 0):
        self._make = make_batch
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._start = start
        self._stop = threading.Event()
        self._error: BaseException = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._start
        try:
            while not self._stop.is_set():
                try:
                    self._q.put(self._make(step), timeout=0.5)
                    step += 1
                except queue.Full:
                    continue
        except BaseException as e:  # noqa: BLE001 — surfaced in __next__
            self._error = e

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        while True:
            try:
                return self._q.get(timeout=0.2)
            except queue.Empty:
                if self._thread.is_alive():
                    continue
                # producer gone for good: surface its crash, else end
                if self._error is not None:
                    raise self._error
                raise StopIteration from None

    def close(self):
        """Stop prefetching (idempotent). Already-queued batches stay
        readable; after them, iteration ends with StopIteration."""
        if self._stop.is_set():
            return
        self._stop.set()
        self._thread.join()


def host_rng(seed: int, host_id: int, step: int) -> np.random.Generator:
    """Deterministic per-(host, step) stream."""
    return np.random.default_rng(
        np.random.SeedSequence([seed, host_id, step]))


def contrastive_stream(world, tok, global_batch: int, *, seed=0, host_id=0,
                       n_hosts=1, text_len=16, classes=None, depth=2):
    """Prefetching stream of host ``host_id``'s slice of the global batch
    (the legacy single-knob entry; ``data.sharded.ShardedLoader`` adds
    augmentation, resumable state, and device assembly on the same
    layout)."""
    if global_batch % n_hosts:
        raise ValueError(
            f"global batch {global_batch} must be divisible by n_hosts "
            f"{n_hosts} — each host draws an equal slice; a remainder "
            f"would silently shrink the global batch to "
            f"{global_batch // n_hosts * n_hosts}")
    local = global_batch // n_hosts
    from repro_torch.data.synthetic import contrastive_batch

    def make(step):
        rng = host_rng(seed, host_id, step)
        batch, _ = contrastive_batch(world, tok, local, rng,
                                     text_len=text_len, classes=classes)
        return batch

    return Prefetcher(make, depth=depth)
