"""Schema-versioned run log: one JSONL record per train step (copy of
``repro/obs/runlog.py``, §11.3; the same schema v1, so the reference's
readers and ``scripts/check_runlog.py`` read the port's runlogs).

The committed artifact of a run is its metric TRAJECTORY (Cherti et al.,
PAPERS.md) — not a final number — so the trainer streams one record per
step to ``<run_dir>/runlog.jsonl``:

  run_start   — schema version, wall-clock time, run meta (arch, batch,
                objective, flags) — always the file's first record
  resume      — ``{"resumed_from": step}`` marker appended when a
                ``--resume`` relaunch continues the SAME file, so the two
                segments never silently interleave
  step        — loss, grad_norm, examples_per_sec, and the full step-time
                breakdown (``data_wait_s`` / ``device_step_s`` /
                ``ckpt_stall_s`` + total ``step_s``)
  checkpoint  — save/retention/degrade/preempt events with their step
  metrics     — a final ``Registry.snapshot()`` dump
  anomaly     — a health detector fired (detector, step, severity,
                value — written by ``obs/health.py``'s ``HealthMonitor``)
  event       — anything else worth a timestamped line

Every record carries ``{"schema": SCHEMA_VERSION, "kind": ..., "t": ...}``.
Readers REJECT records from a different schema version (``RunlogError``)
instead of guessing: the version only moves when the record shape does,
and ``scripts/check_runlog.py`` gates committed samples against it.

Writes are append-only line-buffered JSON — cheap enough for every
step, crash-tolerant by construction (a torn final line is detected and
reported by the reader, never fatal to earlier records). The port writes
no anomaly records yet (its health tier is not ported); readers accept
them.
"""
from __future__ import annotations

import json
import os
import time
from typing import Iterator, List, Optional

SCHEMA_VERSION = 1

# the step-time breakdown every step record must carry (§11.3): host time
# waiting on the input pipeline, device time under the jitted step, and
# time the checkpoint path held the loop
STEP_BREAKDOWN_KEYS = ("data_wait_s", "device_step_s", "ckpt_stall_s")
STEP_REQUIRED_KEYS = (("step", "loss", "examples_per_sec", "step_s")
                      + STEP_BREAKDOWN_KEYS)
KINDS = ("run_start", "resume", "step", "checkpoint", "metrics",
         "anomaly", "event")

# an anomaly record names its detector, anchors to a step, grades itself,
# and carries the offending value (obs/health.py emits these)
ANOMALY_SEVERITIES = ("warn", "critical")
ANOMALY_REQUIRED_KEYS = ("detector", "step", "severity", "value")


class RunlogError(ValueError):
    """A runlog record failed schema validation (wrong version, unknown
    kind, missing/ill-typed required keys)."""


def validate_record(rec: object) -> List[str]:
    """Schema-v1 errors for one decoded record (empty list = valid)."""
    if not isinstance(rec, dict):
        return [f"record is {type(rec).__name__}, not an object"]
    errors = []
    schema = rec.get("schema")
    if schema != SCHEMA_VERSION:
        errors.append(f"schema {schema!r} != supported {SCHEMA_VERSION}")
    kind = rec.get("kind")
    if kind not in KINDS:
        errors.append(f"unknown kind {kind!r} (have {KINDS})")
    if not isinstance(rec.get("t"), (int, float)):
        errors.append("missing/non-numeric wall-clock key 't'")
    if kind == "step":
        for key in STEP_REQUIRED_KEYS:
            if not isinstance(rec.get(key), (int, float)):
                errors.append(f"step record missing/non-numeric {key!r}")
    if kind == "resume" and not isinstance(rec.get("resumed_from"), int):
        errors.append("resume record missing integer 'resumed_from'")
    if kind == "anomaly":
        if not isinstance(rec.get("detector"), str):
            errors.append("anomaly record missing string 'detector'")
        if not isinstance(rec.get("step"), int):
            errors.append("anomaly record missing integer 'step'")
        if rec.get("severity") not in ANOMALY_SEVERITIES:
            errors.append(f"anomaly severity {rec.get('severity')!r} not "
                          f"in {ANOMALY_SEVERITIES}")
        if not isinstance(rec.get("value"), (int, float)):
            errors.append("anomaly record missing numeric 'value'")
    return errors


class RunLogger:
    """Append-only JSONL writer for one run directory.

    Fresh file: writes the ``run_start`` header. Resumed run
    (``resumed_from=step``): appends a ``resume`` marker to the SAME file
    instead of a second header, so a reader sees one continuous
    trajectory with explicit segment boundaries. Context-manager
    friendly; ``close()`` is idempotent.
    """

    def __init__(self, path: str, *, meta: Optional[dict] = None,
                 resumed_from: Optional[int] = None):
        self.path = path
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        fresh = not os.path.exists(path) or os.path.getsize(path) == 0
        self._f = open(path, "a", buffering=1)   # line-buffered: one
        # record per write() — a crash tears at most the final line
        if fresh:
            self.log("run_start", meta=dict(meta or {}))
        if resumed_from is not None:
            self.log("resume", resumed_from=int(resumed_from),
                     meta=dict(meta or {}))

    def log(self, kind: str, **fields) -> dict:
        """Write one ``kind`` record with ``fields``; returns the record
        as written (schema/kind/t filled in)."""
        if kind not in KINDS:
            raise RunlogError(f"unknown record kind {kind!r}")
        rec = {"schema": SCHEMA_VERSION, "kind": kind, "t": time.time()}
        rec.update(fields)
        errors = validate_record(rec)
        if errors:
            raise RunlogError(f"refusing to write invalid {kind} record: "
                              + "; ".join(errors))
        self._f.write(json.dumps(rec) + "\n")
        return rec

    def log_step(self, step: int, *, loss: float, data_wait_s: float,
                 device_step_s: float, ckpt_stall_s: float, step_s: float,
                 examples_per_sec: float, **extra) -> dict:
        """The per-step record: loss + the full time breakdown, plus any
        ``extra`` numeric fields (grad_norm, lr, ...)."""
        return self.log("step", step=int(step), loss=float(loss),
                        data_wait_s=float(data_wait_s),
                        device_step_s=float(device_step_s),
                        ckpt_stall_s=float(ckpt_stall_s),
                        step_s=float(step_s),
                        examples_per_sec=float(examples_per_sec), **extra)

    def close(self) -> None:
        """Flush and close the underlying file (idempotent)."""
        if not self._f.closed:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def iter_runlog(path: str, *, strict: bool = True) -> Iterator[dict]:
    """Yield validated records from a runlog JSONL file.

    ``strict=True`` raises ``RunlogError`` on the first invalid or
    unparseable record — EXCEPT a torn final line (truncated by a crash
    mid-write), which is skipped: earlier records are still a valid
    trajectory. ``strict=False`` skips invalid records silently."""
    with open(path) as f:
        lines = f.read().splitlines()
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError as e:
            if i == len(lines) - 1:
                return            # torn final line: crash mid-write
            if strict:
                raise RunlogError(f"{path}:{i + 1}: unparseable JSON "
                                  f"({e})") from e
            continue
        errors = validate_record(rec)
        if errors:
            if strict:
                raise RunlogError(f"{path}:{i + 1}: " + "; ".join(errors))
            continue
        yield rec


def read_runlog(path: str, *, strict: bool = True) -> List[dict]:
    """All validated records of ``path`` (see ``iter_runlog``)."""
    return list(iter_runlog(path, strict=strict))
