"""Deterministic fault injectors for checkpoints (port of
``repro/checkpoint/faults.py``; pure file work, copied).

Two families:

  * WRITE-PATH injectors (context managers) ride the ``io`` write fault
    hook and fire on the Nth file-write of a save: ``failing_writes``
    raises ``OSError`` (exercises the manager's retry/backoff + the
    trainer's sync fallback), ``exit_during_write`` calls ``os._exit``
    (a SIGKILL-equivalent: the process dies mid-save leaving a torn
    ``.tmp_ckpt_*`` dir, exactly what host preemption produces).

  * ON-DISK corruptors mutate a COMPLETED step dir the way real storage
    failures do: ``truncate_leaf`` (short read/torn page),
    ``flip_byte`` (bit rot — size unchanged, only the hash catches it),
    ``tamper_index_hash`` (bad metadata), ``leftover_tmp`` (stale
    partial-save dir). ``verify``/``latest_verified_step`` must reject or
    skip every one of them.

All injectors are process-local and deterministic.
"""
from __future__ import annotations

import contextlib
import json
import os

from repro_torch.checkpoint import io


@contextlib.contextmanager
def failing_writes(n: int = 1, *, message: str = "injected I/O failure"):
    """Make the next ``n`` checkpoint file-writes raise ``OSError`` (then
    heal). Yields a one-key dict ``{"fired": count}`` so tests can check
    how many faults actually triggered."""
    state = {"fired": 0}

    def hook(path):
        if state["fired"] < n:
            state["fired"] += 1
            raise OSError(f"{message} (write #{state['fired']}: {path})")
    prev = io.set_write_fault_hook(hook)
    try:
        yield state
    finally:
        io.set_write_fault_hook(prev)


@contextlib.contextmanager
def exit_during_write(after: int = 0, *, code: int = 17):
    """Kill the process (``os._exit`` — no cleanup, no atexit, the closest
    in-process stand-in for SIGKILL/preemption) on the ``after+1``-th
    checkpoint file-write. The save in progress leaves a torn
    ``.tmp_ckpt_*`` dir behind; the parent recognizes the death by exit
    ``code``."""
    state = {"writes": 0}

    def hook(path):
        state["writes"] += 1
        if state["writes"] > after:
            os._exit(code)
    prev = io.set_write_fault_hook(hook)
    try:
        yield state
    finally:
        io.set_write_fault_hook(prev)


def _leaf_path(directory: str, step: int, leaf: int) -> str:
    return os.path.join(directory, f"step_{step:08d}", f"arr_{leaf}.npy")


def truncate_leaf(directory: str, step: int, leaf: int = 0,
                  keep_bytes: int = 8) -> str:
    """Truncate ``arr_<leaf>.npy`` of a completed step to ``keep_bytes``
    bytes (a torn write / short read). Returns the mutated path."""
    path = _leaf_path(directory, step, leaf)
    with open(path, "r+b") as f:
        f.truncate(keep_bytes)
    return path


def flip_byte(directory: str, step: int, leaf: int = 0,
              offset: int = -1) -> str:
    """XOR one byte of ``arr_<leaf>.npy`` (bit rot: the file size stays
    right, only the recorded sha256 can catch it). ``offset`` indexes from
    the end when negative. Returns the mutated path."""
    path = _leaf_path(directory, step, leaf)
    size = os.path.getsize(path)
    pos = offset % size
    with open(path, "r+b") as f:
        f.seek(pos)
        b = f.read(1)
        f.seek(pos)
        f.write(bytes([b[0] ^ 0xFF]))
    return path


def tamper_index_hash(directory: str, step: int, leaf: int = 0) -> str:
    """Rewrite ``index.json`` with a wrong sha256 for ``leaf`` (corrupt
    metadata: the leaf file itself is intact but can no longer be
    trusted). Returns the index path."""
    path = os.path.join(directory, f"step_{step:08d}", "index.json")
    with open(path) as f:
        index = json.load(f)
    index["leaves"][leaf]["sha256"] = "0" * 64
    with open(path, "w") as f:
        json.dump(index, f)
    return path


def leftover_tmp(directory: str, *, n_files: int = 2) -> str:
    """Plant a stale ``.tmp_ckpt_*`` dir with partial leaf files — what a
    crash mid-save leaves behind. ``latest_verified_step`` must GC it.
    Returns the planted path."""
    import tempfile
    os.makedirs(directory, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=directory, prefix=io.TMP_PREFIX)
    for i in range(n_files):
        with open(os.path.join(tmp, f"arr_{i}.npy"), "wb") as f:
            f.write(b"\x93NUMPY torn" * 3)
    return tmp
