"""Checkpoints: tree save/restore with an integrity-verified index and
atomic writes (port of ``repro/checkpoint/io.py``), in the reference's
on-disk format byte for byte, so either package restores what the other
saved.

Layout:  <dir>/step_<N:08d>/
            index.json      — ``treedef`` (JAX's ``str(treedef)`` form),
                              ``n``, ``step``, ``format`` 2 and per leaf its
                              dtype, shape and the integrity record: sha256
                              and byte size of ``arr_<i>.npy`` as written
            arr_<i>.npy     — one file per leaf, in JAX's flattening order
                              (dict keys sorted, lists and NamedTuple fields
                              in order: ``repro_torch.tree.leaves``)
            user_meta.json  — optional JSON sidecar (``save(..., meta=...)``)

numpy has no bfloat16: a bf16 leaf is recorded as dtype ``bfloat16`` and
its bits are stored as ``uint16``, as the reference stores them; ``restore``
views them back. JAX treats ``None`` as an empty subtree, which would
number the leaves differently, so a ``None`` leaf is refused.

Everything is written into a ``.tmp_ckpt_*`` dir that is renamed into
place only once complete, ``meta`` included. The async manager
(``checkpoint/manager.py``) reuses the ``snapshot`` / ``write_snapshot``
split: snapshot (a copy to host memory) on the caller's thread, serialize
and rename on a background one. Validation never uses ``assert``: every
corrupt, mismatched or missing condition raises ``CheckpointError`` naming
the offending leaf.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.tree import leaves, treedef_str, unflatten

TMP_PREFIX = ".tmp_ckpt_"
INDEX_FORMAT = 2          # 1: no hashes (pre-integrity); 2: sha256 + bytes

# test-only fault hook (checkpoint/faults.py): called with the path of every
# file about to be written and before the final rename; raising simulates a
# transient I/O failure, os._exit a hard kill mid-save
_write_fault_hook = None


class CheckpointError(Exception):
    """A checkpoint is missing, torn, corrupt, or does not match the target
    structure. The message names the offending leaf index and the
    expected-vs-found shape, dtype, count or hash."""


class HostLeaf(NamedTuple):
    """One leaf copied to host memory: its dtype as the index records it
    and the array ``np.save`` writes (a bf16 leaf's bits as uint16)."""
    dtype: str
    array: np.ndarray


def set_write_fault_hook(hook):
    """Install (or clear, with None) the test-only write fault hook; returns
    the previous hook. It is called as ``hook(path)`` before every file
    write and before the atomic rename (the path then ends in the final
    step-dir name)."""
    global _write_fault_hook
    prev, _write_fault_hook = _write_fault_hook, hook
    return prev


def _fault(path: str) -> None:
    if _write_fault_hook is not None:
        _write_fault_hook(path)


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _leaf_pairs(tree) -> list:
    """(path, leaf) of ``tree`` in JAX's order, refusing ``None`` leaves."""
    pairs = list(leaves(tree))
    for i, (path, leaf) in enumerate(pairs):
        if leaf is None:
            raise CheckpointError(
                f"leaf {i} ({path or 'the root'}) is None; JAX reads None as "
                f"an empty subtree, so the leaves would be numbered "
                f"differently")
    return pairs


def to_host(leaf) -> HostLeaf:
    """A copy of ``leaf`` (a tensor on any device, a numpy array or a
    Python scalar) in host memory, C-contiguous, never sharing storage with
    the original."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True,
                             memory_format=torch.contiguous_format)
        if t.dtype == torch.bfloat16:
            return HostLeaf("bfloat16",
                            t.view(torch.int16).numpy().view(np.uint16))
        arr = t.numpy()
    else:
        arr = np.array(leaf, copy=True, order="C")
    return HostLeaf(str(arr.dtype), arr)


def snapshot(tree):
    """Copy every leaf of ``tree`` to host memory: the only part of a save
    that must run synchronously with the training loop (the next in-place
    step must not change what is being written). Returns ``(host leaves,
    treedef string)`` ready for ``write_snapshot`` on any thread."""
    return ([to_host(x) for _, x in _leaf_pairs(tree)], treedef_str(tree))


def write_snapshot(directory: str, step: int, arrs, treedef,
                   meta=None) -> str:
    """Serialize a host snapshot (``HostLeaf`` list and treedef string) as
    ``<directory>/step_<N>/`` atomically: every ``arr_<i>.npy`` plus its
    sha256/byte-size index entry goes into a ``.tmp_ckpt_*`` dir, renamed
    into place only once complete. A crash at any point leaves the
    previous state or a stale tmp dir (GC'd by ``latest_verified_step``),
    never a torn step."""
    final = _step_dir(directory, step)
    os.makedirs(directory, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=directory, prefix=TMP_PREFIX)
    try:
        index = {"treedef": treedef, "n": len(arrs), "step": step,
                 "format": INDEX_FORMAT, "leaves": []}
        for i, leaf in enumerate(arrs):
            path = os.path.join(tmp, f"arr_{i}.npy")
            _fault(path)
            np.save(path, leaf.array)
            index["leaves"].append({
                "dtype": leaf.dtype, "shape": list(leaf.array.shape),
                "bytes": os.path.getsize(path),
                "sha256": _sha256_file(path)})
        _fault(os.path.join(tmp, "index.json"))
        with open(os.path.join(tmp, "index.json"), "w") as f:
            json.dump(index, f)
        if meta is not None:
            _fault(os.path.join(tmp, "user_meta.json"))
            with open(os.path.join(tmp, "user_meta.json"), "w") as f:
                json.dump(meta, f, indent=1)
        _fault(final)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def save(directory: str, step: int, tree, meta=None) -> str:
    """Write ``tree`` as ``<directory>/step_<N>/`` atomically, blocking
    (snapshot, serialize and rename on the calling thread; the async path
    is ``checkpoint.manager.AsyncCheckpointManager``). ``meta``: optional
    JSON-serializable dict stored as ``user_meta.json`` in the same rename.
    Returns the step dir."""
    arrs, treedef = snapshot(tree)
    return write_snapshot(directory, step, arrs, treedef, meta=meta)


def load_meta(directory: str, step: int):
    """The ``user_meta.json`` sidecar of a step dir, or None when the
    checkpoint was saved without one."""
    path = os.path.join(_step_dir(directory, step), "user_meta.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _list_steps(directory: str):
    return sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                  if d.startswith("step_"))


def latest_step(directory: str):
    """Newest step number present on disk (no integrity check; prefer
    ``latest_verified_step`` to resume), or None."""
    if not os.path.isdir(directory):
        return None
    steps = _list_steps(directory)
    return steps[-1] if steps else None


def verify(directory: str, step: int) -> dict:
    """Replay the integrity record of ``<directory>/step_<N>/``: the index
    must parse, every ``arr_<i>.npy`` must exist with the recorded byte size
    and sha256. Returns the parsed index; raises ``CheckpointError`` naming
    the first offending leaf otherwise. Format-1 checkpoints (no hashes)
    verify existence and leaf count only."""
    path = _step_dir(directory, step)
    if not os.path.isdir(path):
        raise CheckpointError(f"no checkpoint dir at {path}")
    try:
        with open(os.path.join(path, "index.json")) as f:
            index = json.load(f)
    except FileNotFoundError:
        raise CheckpointError(f"{path}: missing index.json (torn write?)") \
            from None
    except (json.JSONDecodeError, OSError) as e:
        raise CheckpointError(f"{path}: unreadable index.json: {e}") from e
    recs = index.get("leaves")
    if not isinstance(recs, list) or index.get("n") != len(recs):
        raise CheckpointError(
            f"{path}: index.json inconsistent: n={index.get('n')} vs "
            f"{len(recs) if isinstance(recs, list) else 'no'} leaf records")
    for i, leaf in enumerate(recs):
        apath = os.path.join(path, f"arr_{i}.npy")
        if not os.path.exists(apath):
            raise CheckpointError(f"{path}: leaf {i} missing ({apath})")
        want_bytes = leaf.get("bytes")
        if want_bytes is not None:
            found = os.path.getsize(apath)
            if found != want_bytes:
                raise CheckpointError(
                    f"{path}: leaf {i} truncated/resized: expected "
                    f"{want_bytes} bytes, found {found}")
        want_sha = leaf.get("sha256")
        if want_sha is not None:
            found_sha = _sha256_file(apath)
            if found_sha != want_sha:
                raise CheckpointError(
                    f"{path}: leaf {i} content hash mismatch: expected "
                    f"{want_sha[:12]}…, found {found_sha[:12]}…")
    return index


def gc_tmp_dirs(directory: str) -> list:
    """Remove stale ``.tmp_ckpt_*`` dirs a crash mid-save left behind;
    returns the removed paths. Call only when no async save is in flight."""
    if not os.path.isdir(directory):
        return []
    removed = []
    for d in os.listdir(directory):
        if d.startswith(TMP_PREFIX):
            path = os.path.join(directory, d)
            shutil.rmtree(path, ignore_errors=True)
            removed.append(path)
    return removed


def latest_verified_step(directory: str, *, gc: bool = True):
    """Newest step whose checkpoint passes ``verify``, walking newest to
    oldest and skipping torn or corrupt steps; ``gc`` (default) also
    removes stale ``.tmp_ckpt_*`` dirs. None when no step verifies."""
    if not os.path.isdir(directory):
        return None
    if gc:
        gc_tmp_dirs(directory)
    for step in reversed(_list_steps(directory)):
        try:
            verify(directory, step)
            return step
        except CheckpointError:
            continue
    return None


def gc_steps(directory: str, *, keep_last: int, keep_every: int = 0) -> list:
    """Retention: delete step dirs beyond the newest ``keep_last``, except
    steps divisible by ``keep_every`` (0: none kept that way). Returns the
    deleted step numbers. ``keep_last`` must be >= 1, so the newest
    checkpoint is never collected."""
    if keep_last < 1:
        raise CheckpointError(f"keep_last must be >= 1, got {keep_last}")
    if not os.path.isdir(directory):
        return []
    steps = _list_steps(directory)
    keep = set(steps[-keep_last:])
    if keep_every > 0:
        keep.update(s for s in steps if s % keep_every == 0)
    dropped = [s for s in steps if s not in keep]
    for s in dropped:
        shutil.rmtree(_step_dir(directory, s), ignore_errors=True)
    return dropped


def _from_npy(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(directory: str, step: int, like, *, device):
    """Restore into the structure of ``like``, a tree of tensors or
    ``torch.empty(..., device="meta")`` stand-ins (NamedTuples keep their
    type). Every leaf comes back on ``device`` (required) in its recorded
    dtype. Raises ``CheckpointError`` on a missing step, a leaf-count
    mismatch, an unreadable leaf file, or a leaf whose shape or dtype
    differs from ``like``'s."""
    path = _step_dir(directory, step)
    try:
        with open(os.path.join(path, "index.json")) as f:
            index = json.load(f)
    except FileNotFoundError:
        raise CheckpointError(f"no checkpoint at {path} (missing "
                              f"index.json)") from None
    like_pairs = _leaf_pairs(like)
    if index["n"] != len(like_pairs):
        raise CheckpointError(
            f"{path}: checkpoint has {index['n']} leaves, target structure "
            f"has {len(like_pairs)}")
    out = []
    for i, (_, ref) in enumerate(like_pairs):
        apath = os.path.join(path, f"arr_{i}.npy")
        try:
            arr = np.load(apath)
        except (FileNotFoundError, OSError, ValueError) as e:
            raise CheckpointError(
                f"{path}: leaf {i} unreadable ({apath}): "
                f"{type(e).__name__}: {e}") from e
        expect = tuple(ref.shape)
        if tuple(arr.shape) != expect:
            raise CheckpointError(
                f"{path}: leaf {i} shape mismatch: checkpoint has "
                f"{tuple(arr.shape)}, target expects {expect}")
        dtype_name = index["leaves"][i]["dtype"]
        t = _from_npy(arr, dtype_name)
        if t.dtype != ref.dtype:
            raise CheckpointError(
                f"{path}: leaf {i} dtype mismatch: checkpoint has "
                f"{dtype_name}, target expects {ref.dtype}")
        out.append(t.to(device))
    return unflatten(like, out)
