"""Runlog trajectory summariser (port of ``repro/obs/report.py``):
``python -m repro_torch.obs.report <runlog>``.

Reads a schema-v1 runlog JSONL (``obs/runlog.py``) and prints the run's
trajectory (§11.3): loss first → last, throughput, and EXACT p50/p90/p99
of every step-time component (from the raw per-step records), plus
checkpoint / resume / degrade events. A runlog with a ``run_start`` but
zero ``step`` records (a run that died before step 1) reports "no steps"
instead of crashing. ``--health`` adds the run's anomaly trail and the
``health/*`` / SLO series of the final metrics snapshot; ``--serving``
reads a serving metrics snapshot (``Registry.snapshot()`` or
``ZeroShotService.stats()`` as JSON) and reports the retrieval series.
"""
from __future__ import annotations

import argparse
import math
import sys
from typing import List, Sequence

from repro_torch.obs import runlog as rl
from repro_torch.obs import windows as _windows

_PCTS = (50, 90, 99)
_PHASES = rl.STEP_BREAKDOWN_KEYS + ("step_s",)


def _percentile(values: Sequence[float], q: float) -> float:
    """Exact linear-interpolated percentile of ``values`` (numpy 'linear'
    convention); NaN for an empty sequence — a zero-step runlog must
    summarise, not crash."""
    return _windows.percentile(values, q)


def summarize(records: List[dict]) -> dict:
    """Aggregate a record list into the report's plain-dict form:
    ``{"steps", "loss", "throughput", "phases", "events", "resumes",
    "anomalies", "final_metrics"}``."""
    steps = [r for r in records if r["kind"] == "step"]
    out = {
        "n_records": len(records),
        "steps": len(steps),
        "resumes": [r["resumed_from"] for r in records
                    if r["kind"] == "resume"],
        "events": [r for r in records
                   if r["kind"] in ("checkpoint", "event")],
        "anomalies": [r for r in records if r["kind"] == "anomaly"],
        "final_metrics": next(
            ({k: r.get(k, {}) for k in ("counters", "gauges", "histograms")}
             for r in reversed(records) if r["kind"] == "metrics"), {}),
        "meta": next((r.get("meta", {}) for r in records
                      if r["kind"] == "run_start"), {}),
    }
    if steps:
        losses = [r["loss"] for r in steps]
        out["loss"] = {"first": losses[0], "last": losses[-1],
                       "min": min(losses)}
        eps = [r["examples_per_sec"] for r in steps]
        out["throughput"] = {"examples_per_sec_mean": sum(eps) / len(eps)}
        out["phases"] = {
            phase: {f"p{q}": _percentile([r[phase] for r in steps], q)
                    for q in _PCTS}
            for phase in _PHASES}
        total = sum(r["step_s"] for r in steps) or 1.0
        out["phase_share"] = {
            phase: sum(r[phase] for r in steps) / total
            for phase in rl.STEP_BREAKDOWN_KEYS}
    return out


def format_report(summary: dict) -> str:
    """Human-readable multi-line rendering of ``summarize()``'s output."""
    lines = [f"runlog: {summary['steps']} step records "
             f"({summary['n_records']} total)"]
    if summary["meta"]:
        meta = ", ".join(f"{k}={v}" for k, v in
                         sorted(summary["meta"].items()))
        lines.append(f"run: {meta}")
    if summary["resumes"]:
        lines.append("resumed at step(s): "
                     + ", ".join(str(s) for s in summary["resumes"]))
    if not summary["steps"]:
        lines.append("no steps recorded (run ended before step 1)")
    if summary["steps"]:
        loss = summary["loss"]
        lines.append(f"loss: {loss['first']:.4f} -> {loss['last']:.4f} "
                     f"(min {loss['min']:.4f})")
        lines.append(f"throughput: "
                     f"{summary['throughput']['examples_per_sec_mean']:.1f} "
                     f"examples/sec (mean)")
        lines.append(f"{'phase':<16}" + "".join(f"{f'p{q}':>12}"
                                                for q in _PCTS) + "   share")
        for phase in _PHASES:
            p = summary["phases"][phase]
            share = summary.get("phase_share", {}).get(phase)
            tail = f"  {share * 100:5.1f}%" if share is not None else ""
            lines.append(f"{phase:<16}"
                         + "".join(f"{p[f'p{q}'] * 1e3:10.2f}ms"
                                   for q in _PCTS) + tail)
    for ev in summary["events"]:
        what = ev.get("event", ev["kind"])
        extra = {k: v for k, v in ev.items()
                 if k not in ("schema", "kind", "t", "event")}
        lines.append(f"event: {what} "
                     + " ".join(f"{k}={v}" for k, v in sorted(extra.items())))
        if what == "trace_export" and ev.get("dropped", 0):
            lines.append(f"WARNING: trace ring dropped {ev['dropped']} "
                         f"events past capacity — timeline truncated at "
                         f"the old end")
    n_anom = len(summary.get("anomalies", []))
    if n_anom:
        lines.append(f"anomalies: {n_anom} (rerun with --health for "
                     f"detail)")
    return "\n".join(lines)


def format_health(summary: dict) -> str:
    """``--health`` rendering: the run's anomaly trail plus the
    ``health/*`` and ``*/slo_*`` series from the final metrics record."""
    lines = []
    anomalies = summary.get("anomalies", [])
    lines.append(f"health: {len(anomalies)} anomaly record(s)")
    for a in anomalies:
        msg = a.get("message", "")
        lines.append(f"  [{a['severity']:>8}] step {a['step']:>6} "
                     f"{a['detector']}: value={a['value']:.4g}"
                     + (f"  {msg}" if msg else ""))
    snap = summary.get("final_metrics", {})
    rows = []
    for table in ("counters", "gauges"):
        for name, v in sorted(snap.get(table, {}).items()):
            if name.startswith("health/") or "/slo_" in name:
                rows.append(f"  {name} = {v:g}" if isinstance(v, float)
                            else f"  {name} = {v}")
    if rows:
        lines.append("health/SLO series (final metrics snapshot):")
        lines.extend(rows)
    burn = snap.get("gauges", {}).get("serve/slo_error_budget_burn")
    if burn is not None and math.isfinite(burn):
        lines.append(f"error budget: {'EXHAUSTED' if burn >= 1 else 'ok'} "
                     f"(burn {burn:.2f}; >=1 flips readiness)")
    return "\n".join(lines)


def format_serving(snapshot: dict) -> str:
    """Render a serving metrics snapshot (``Registry.snapshot()`` JSON, or
    the full ``ZeroShotService.stats()`` dict — the ``metrics`` key is
    unwrapped automatically) with the retrieval path front and centre:
    per-stage latency percentiles, the two-stage prune ratio, and
    per-shard winner skew (``serve/retrieval_shard_share`` records the
    MAX per-shard share of top-k winners each call; 1/S is perfectly
    balanced, 1.0 means one shard owns every winner)."""
    snap = snapshot.get("metrics", snapshot)
    hists = snap.get("histograms", {})
    counters = snap.get("counters", {})
    lines = []

    latency = {k: v for k, v in sorted(hists.items())
               if k.startswith("serve/retrieval_latency_s")}
    if latency:
        lines.append(f"{'retrieval latency':<34}{'count':>7}"
                     + "".join(f"{f'p{q}':>12}" for q in _PCTS))
        for name, h in latency.items():
            lines.append(f"{name:<34}{h['count']:>7}"
                         + "".join(f"{h[f'p{q}'] * 1e3:10.2f}ms"
                                   for q in _PCTS))
    for name, h in sorted(hists.items()):
        if name.startswith("serve/retrieval_prune_ratio") and h["count"]:
            mean = h["sum"] / h["count"]
            lines.append(f"prune ratio ({name}): mean {mean:.3f} "
                         f"p50 {h['p50']:.3f} p99 {h['p99']:.3f} "
                         f"over {h['count']} calls "
                         f"(fraction of gallery reranked; lower = "
                         f"coarser stage pruned more)")
        elif name.startswith("serve/retrieval_shard_share") and h["count"]:
            mean = h["sum"] / h["count"]
            lines.append(f"shard skew ({name}): max-share mean {mean:.3f} "
                         f"p99 {h['p99']:.3f} over {h['count']} calls "
                         f"(1/S balanced, 1.0 one shard wins all)")
    serve_counters = {k: v for k, v in sorted(counters.items())
                      if k.startswith("serve/")}
    if serve_counters:
        lines.append("counters: " + " ".join(f"{k}={v}" for k, v in
                                             serve_counters.items()))
    if not lines:
        lines.append("no serve/retrieval_* series in snapshot")
    return "\n".join(lines)


def main(argv=None) -> int:
    """CLI entry: summarize one runlog; non-zero on schema failures."""
    ap = argparse.ArgumentParser(
        description="summarize a runlog JSONL's trajectory and step-time "
                    "percentiles (obs/runlog.py schema v1), or a serving "
                    "metrics snapshot with --serving")
    ap.add_argument("runlog", help="path to runlog.jsonl (or, with "
                                   "--serving, a metrics snapshot JSON)")
    ap.add_argument("--lenient", action="store_true",
                    help="skip invalid records instead of failing")
    ap.add_argument("--serving", action="store_true",
                    help="treat the input as a JSON metrics snapshot "
                         "(Registry.snapshot() or ZeroShotService.stats()) "
                         "and report the serve/retrieval_* series")
    ap.add_argument("--health", action="store_true",
                    help="also render the run's anomaly records and "
                         "health/SLO series (obs/health.py)")
    args = ap.parse_args(argv)
    if args.serving:
        import json
        with open(args.runlog) as f:
            print(format_serving(json.load(f)))
        return 0
    try:
        records = rl.read_runlog(args.runlog, strict=not args.lenient)
    except rl.RunlogError as e:
        print(f"report: INVALID RUNLOG {e}", file=sys.stderr)
        return 1
    summary = summarize(records)
    print(format_report(summary))
    if args.health:
        print(format_health(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
