"""Active run monitoring: anomaly detectors, flight recorder, SLOs (copy of
``repro/obs/health.py``, §14).

The runlog, metrics and trace RECORD what happened; this layer WATCHES it
happen. Three pieces:

  detectors      small stateful objects fed one ``StepSample`` per train
                 step (or one latency per serving request). Each returns
                 ``Anomaly`` records when its signal trips: non-finite
                 loss/grad, grad-norm spike (windowed MAD z-score,
                 obs/windows.py), loss plateau/spike, data-wait stall
                 watchdog, per-host straggler skew read from the
                 ``data/gen_seconds{host=h}`` registry series.
  HealthMonitor  owns the detector set and the response: every anomaly
                 becomes a schema-v1 ``anomaly`` runlog record, a trace
                 instant, and a ``health/*`` counter bump — and the
                 flight recorder dumps the trace ring + registry snapshot
                 + last-K step records into the run dir, so the state
                 that PRECEDED the anomaly survives the crash that may
                 follow it.
  SLOTracker     serving-side: windowed p99 latency vs a target, error-
                 budget burn over the window, and a readiness bit that
                 flips when the budget is exhausted (and recovers as the
                 window slides). ``/healthz`` serves it (obs/export.py).

Everything is optional and cheap: a monitor without a runlog/tracer just
counts; detector checks are a handful of window pushes and one sorted
percentile over <=256 floats, host work outside the device step.
DESIGN.md §14 derives the MAD z-score threshold.
"""
from __future__ import annotations

import abc
import dataclasses
import json
import math
import os
import re
import threading
import time
from collections import deque
from typing import Callable, List, Optional, Sequence

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import runlog as obs_runlog
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.windows import SlidingWindow

SEVERITIES = ("warn", "critical")


@dataclasses.dataclass(frozen=True)
class Anomaly:
    """One detector firing: who, when, how bad, and the offending value.

    ``detector``/``step``/``severity``/``value`` are the schema-v1
    ``anomaly`` runlog record's required fields; ``message`` is the
    human line."""
    detector: str
    step: int
    severity: str                 # "warn" | "critical"
    value: float
    message: str


@dataclasses.dataclass(frozen=True)
class StepSample:
    """One train step's health-relevant signals, host-side floats only
    (the loop already fetched the loss; nothing here touches the
    device)."""
    step: int
    loss: float = math.nan
    grad_norm: float = math.nan
    data_wait_s: float = 0.0
    device_step_s: float = 0.0
    step_s: float = 0.0
    skipped: bool = False         # the step guard rejected this update


class Detector(abc.ABC):
    """Base class: stateful, fed one ``StepSample`` per step.

    Subclasses implement ``_check(sample) -> list[Anomaly]`` (an abstract
    method here, where the reference's base raises when called); the base
    adds a fire cooldown (a tripped plateau shouldn't re-fire every
    subsequent step — one anomaly per episode, then silence for
    ``cooldown`` steps)."""

    name = "detector"

    def __init__(self, *, cooldown: int = 0):
        self.cooldown = int(cooldown)
        self._last_fired: Optional[int] = None

    def observe(self, sample: StepSample) -> List[Anomaly]:
        """Feed one sample; returns the anomalies it trips (cooldown
        applied)."""
        found = self._check(sample)
        if not found:
            return []
        if self._last_fired is not None and \
                sample.step - self._last_fired <= self.cooldown:
            return []
        self._last_fired = sample.step
        return found

    @abc.abstractmethod
    def _check(self, sample: StepSample) -> List[Anomaly]:
        """The anomalies ``sample`` trips, before the cooldown."""


class NonFiniteDetector(Detector):
    """NaN/inf loss or grad norm — the canonical multi-day-run killer
    (EVA-CLIP-18B and the OpenCLIP scaling runs both report exactly
    this; PAPERS.md). Always critical: a non-finite update poisons every
    parameter it touches."""

    name = "nonfinite"

    def __init__(self, fields: Sequence[str] = ("loss", "grad_norm")):
        super().__init__(cooldown=0)
        self.fields = tuple(fields)

    def _check(self, sample: StepSample) -> List[Anomaly]:
        out = []
        for field in self.fields:
            v = float(getattr(sample, field))
            if not math.isfinite(v):
                out.append(Anomaly(
                    detector=self.name, step=sample.step,
                    severity="critical", value=v,
                    message=f"non-finite {field} at step {sample.step}: "
                            f"{v}"))
        return out

    def observe(self, sample: StepSample) -> List[Anomaly]:
        """No cooldown: every poisoned step is its own incident."""
        return self._check(sample)


class SpikeDetector(Detector):
    """Windowed robust-z spike watch on one sample field.

    Fires when the MAD z-score of the new value against the trailing
    window exceeds ``threshold`` (default 8 — DESIGN.md §14.1 argues the
    margin: grad-norm steps are heavy-tailed, and 8 sigma-equivalents
    under the robust scale keeps the false-positive rate per multi-day
    run below one while a real blow-up lands z in the hundreds). The
    window only absorbs the value AFTER the check, and only when it was
    not itself anomalous — a spike must not teach the window that spikes
    are normal. Non-finite values are ignored here (NonFiniteDetector
    owns them)."""

    def __init__(self, field: str, *, threshold: float = 8.0,
                 window: int = 128, min_count: int = 16,
                 cooldown: int = 0):
        super().__init__(cooldown=cooldown)
        self.name = f"{field}_spike"
        self.field = field
        self.threshold = float(threshold)
        self.min_count = int(min_count)
        self.window = SlidingWindow(window)

    def _check(self, sample: StepSample) -> List[Anomaly]:
        v = float(getattr(sample, self.field))
        if not math.isfinite(v):
            return []
        out = []
        if self.window.count >= self.min_count:
            z = self.window.zscore(v)
            if z > self.threshold:
                out.append(Anomaly(
                    detector=self.name, step=sample.step, severity="warn",
                    value=v,
                    message=f"{self.field} spike at step {sample.step}: "
                            f"{v:.4g} (robust z={z:.1f} > "
                            f"{self.threshold:g}, window median "
                            f"{self.window.median():.4g})"))
        if not out:
            self.window.push(v)
        return out


class PlateauDetector(Detector):
    """Loss plateau: the run is burning accelerator-hours without
    learning. Compares the older half of the window against the newer
    half; fires when relative improvement is below ``rel_improvement``
    once the window is full. Cooldown defaults to the window length —
    one anomaly per plateau episode, not one per step."""

    name = "loss_plateau"

    def __init__(self, *, window: int = 128, rel_improvement: float = 1e-3,
                 cooldown: Optional[int] = None):
        super().__init__(cooldown=window if cooldown is None else cooldown)
        self.rel_improvement = float(rel_improvement)
        self.window = SlidingWindow(window)

    def _check(self, sample: StepSample) -> List[Anomaly]:
        v = float(sample.loss)
        out = []
        if math.isfinite(v):
            self.window.push(v)
            if self.window.full:
                vals = self.window.values()
                half = len(vals) // 2
                older = sum(vals[:half]) / half
                newer = sum(vals[half:]) / (len(vals) - half)
                improvement = (older - newer) / max(abs(older), 1e-12)
                if improvement < self.rel_improvement:
                    out.append(Anomaly(
                        detector=self.name, step=sample.step,
                        severity="warn", value=newer,
                        message=f"loss plateau at step {sample.step}: "
                                f"{older:.4f} -> {newer:.4f} over "
                                f"{len(vals)} steps "
                                f"(rel improvement {improvement:.2e} < "
                                f"{self.rel_improvement:g})"))
        return out


class StallDetector(Detector):
    """Data-wait stall watchdog: a wedged input host shows up as one step
    whose ``data_wait_s`` dwarfs the trailing median. Fires warn past
    ``factor`` x the windowed median (with an absolute ``min_stall_s``
    floor so microsecond jitter on a fully-prefetched pipeline can never
    trip it), critical past ``hard_limit_s`` regardless of history."""

    name = "data_stall"

    def __init__(self, *, factor: float = 10.0, min_stall_s: float = 1.0,
                 hard_limit_s: float = 60.0, window: int = 128,
                 min_count: int = 8):
        super().__init__(cooldown=0)
        self.factor = float(factor)
        self.min_stall_s = float(min_stall_s)
        self.hard_limit_s = float(hard_limit_s)
        self.min_count = int(min_count)
        self.window = SlidingWindow(window)

    def _check(self, sample: StepSample) -> List[Anomaly]:
        v = float(sample.data_wait_s)
        out = []
        if v >= self.hard_limit_s:
            out.append(Anomaly(
                detector=self.name, step=sample.step, severity="critical",
                value=v,
                message=f"input pipeline stalled {v:.1f}s at step "
                        f"{sample.step} (hard limit "
                        f"{self.hard_limit_s:g}s)"))
        elif self.window.count >= self.min_count:
            floor = max(self.min_stall_s,
                        self.factor * self.window.median())
            if v > floor:
                out.append(Anomaly(
                    detector=self.name, step=sample.step, severity="warn",
                    value=v,
                    message=f"data wait {v:.3f}s at step {sample.step} > "
                            f"{floor:.3f}s ({self.factor:g}x trailing "
                            f"median {self.window.median():.4f}s)"))
        if not out:
            self.window.push(v)
        return out


_HOST_SERIES = re.compile(r"^data/gen_seconds\{host=(\d+)\}$")


class StragglerDetector(Detector):
    """Per-host input skew from the ``data/gen_seconds{host=h}`` series
    the ShardedLoader already emits (§11): fires when the slowest host's
    mean block time exceeds ``ratio`` x the median host's. Checked every
    ``every`` steps (the series move once per step; scanning the registry
    more often buys nothing). Cooldown = one full check interval."""

    name = "host_straggler"

    def __init__(self, registry: obs_metrics.Registry, *,
                 ratio: float = 3.0, min_count: int = 8, every: int = 16):
        super().__init__(cooldown=int(every))
        self.registry = registry
        self.ratio = float(ratio)
        self.min_count = int(min_count)
        self.every = int(every)

    def _check(self, sample: StepSample) -> List[Anomaly]:
        if sample.step % self.every:
            return []
        means = {}
        for series, inst in self.registry.series("data/gen_seconds").items():
            m = _HOST_SERIES.match(series)
            if not m or not isinstance(inst, obs_metrics.Histogram):
                continue
            if inst.count >= self.min_count:
                means[int(m.group(1))] = inst.sum / inst.count
        if len(means) < 2:
            return []                    # skew needs at least two hosts
        worst = max(means, key=means.get)
        med = sorted(means.values())[len(means) // 2]
        if med <= 0 or means[worst] <= self.ratio * med:
            return []
        return [Anomaly(
            detector=self.name, step=sample.step, severity="warn",
            value=means[worst] / med,
            message=f"host {worst} straggling at step {sample.step}: "
                    f"mean block {means[worst]*1e3:.2f}ms = "
                    f"{means[worst]/med:.1f}x the median host "
                    f"({med*1e3:.2f}ms) over {len(means)} hosts")]


def default_detectors(registry: Optional[obs_metrics.Registry] = None
                      ) -> List[Detector]:
    """The train-loop detector set (DESIGN.md §14.2): non-finite loss and
    grad, grad-norm + loss spikes, loss plateau, data-wait stall — plus
    the per-host straggler watch when a ``registry`` carries the loader's
    ``data/gen_seconds{host=h}`` series."""
    dets: List[Detector] = [
        NonFiniteDetector(),
        SpikeDetector("grad_norm"),
        SpikeDetector("loss"),
        PlateauDetector(),
        StallDetector(),
    ]
    if registry is not None:
        dets.append(StragglerDetector(registry))
    return dets


class FlightRecorder:
    """Dumps the run's in-memory state to disk when an anomaly fires.

    One directory per dump under ``<run_dir>/flight/``:

      anomaly.json   the triggering record (detector/step/severity/value)
      trace.json     the tracer's full ring as Chrome trace JSON
      metrics.json   the registry snapshot at dump time
      steps.jsonl    the last ``keep_steps`` step records (the runlog has
                     them too, but the dump is self-contained — ship the
                     directory, not the run)

    ``max_dumps`` bounds disk: a NaN storm dumps the first few incidents,
    then counts silently (``health/flight_dumps_suppressed``)."""

    def __init__(self, run_dir: str, *, keep_steps: int = 64,
                 max_dumps: int = 4):
        self.run_dir = run_dir
        self.keep_steps = int(keep_steps)
        self.max_dumps = int(max_dumps)
        self.dumps = 0
        self._recent: deque = deque(maxlen=self.keep_steps)

    def record_step(self, record: dict) -> None:
        """Retain one step record (plain dict) in the last-K ring."""
        self._recent.append(dict(record))

    def dump(self, anomaly: Anomaly, *,
             tracer: Optional[obs_trace.Tracer] = None,
             registry: Optional[obs_metrics.Registry] = None
             ) -> Optional[str]:
        """Write one dump directory for ``anomaly``; returns its path, or
        None when the ``max_dumps`` budget is spent."""
        if self.dumps >= self.max_dumps:
            return None
        self.dumps += 1
        d = os.path.join(self.run_dir, "flight",
                         f"step{anomaly.step:06d}_{anomaly.detector}")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "anomaly.json"), "w") as f:
            json.dump(dataclasses.asdict(anomaly), f, indent=2)
            f.write("\n")
        if tracer is not None:
            tracer.export(os.path.join(d, "trace.json"))
        if registry is not None:
            with open(os.path.join(d, "metrics.json"), "w") as f:
                f.write(registry.to_json(indent=2))
                f.write("\n")
        with open(os.path.join(d, "steps.jsonl"), "w") as f:
            for rec in self._recent:
                f.write(json.dumps(rec) + "\n")
        return d


class HealthMonitor:
    """The run's watchdog: detectors in, anomaly response out.

    Per step the trainer calls ``observe_step`` with the host-side floats
    it already has; the monitor runs every detector and, for each
    anomaly: appends a schema-v1 ``anomaly`` record to the runlog, drops
    a trace instant on the trainer lane, bumps
    ``health/anomalies{detector=,severity=}``, and (first ``max_dumps``
    times) triggers the flight recorder. ``status()`` is the
    ``/healthz`` payload: healthy until ``unhealthy_after`` CONSECUTIVE
    critical steps (one skipped NaN step is an incident, not an outage —
    the guard already contained it; a persistent storm is an outage).
    """

    def __init__(self, *, detectors: Optional[Sequence[Detector]] = None,
                 registry: Optional[obs_metrics.Registry] = None,
                 tracer: Optional[obs_trace.Tracer] = None,
                 runlog: Optional[obs_runlog.RunLogger] = None,
                 run_dir: Optional[str] = None,
                 keep_steps: int = 64, max_dumps: int = 4,
                 unhealthy_after: int = 3):
        self.registry = registry if registry is not None \
            else obs_metrics.Registry()
        self.detectors = list(detectors) if detectors is not None \
            else default_detectors(self.registry)
        self.tracer = tracer
        self.runlog = runlog
        self.recorder = FlightRecorder(run_dir, keep_steps=keep_steps,
                                       max_dumps=max_dumps) \
            if run_dir else None
        self.unhealthy_after = int(unhealthy_after)
        self.anomalies: List[Anomaly] = []
        self._consecutive_critical = 0
        self._lock = threading.Lock()
        self._m_checks = self.registry.counter("health/checks")
        self._m_skipped = self.registry.counter("health/steps_skipped")
        self._m_dumps = self.registry.counter("health/flight_dumps")
        self._m_suppressed = self.registry.counter(
            "health/flight_dumps_suppressed")
        self._m_last = self.registry.gauge("health/last_anomaly_step")
        self._m_healthy = self.registry.gauge("health/healthy")
        self._m_last.set(-1)
        self._m_healthy.set(1)

    def observe_step(self, sample: StepSample,
                     record: Optional[dict] = None) -> List[Anomaly]:
        """Run every detector on ``sample``; returns (and responds to)
        the anomalies. ``record``: the step's runlog dict, retained for
        the flight recorder's last-K ring."""
        with self._lock:
            self._m_checks.inc()
            if sample.skipped:
                self._m_skipped.inc()
            if self.recorder is not None and record is not None:
                self.recorder.record_step(record)
            found: List[Anomaly] = []
            for det in self.detectors:
                found.extend(det.observe(sample))
            for anomaly in found:
                self._respond(anomaly)
            if any(a.severity == "critical" for a in found):
                self._consecutive_critical += 1
            else:
                self._consecutive_critical = 0
            self._m_healthy.set(1 if self.healthy else 0)
            return found

    def _respond(self, anomaly: Anomaly) -> None:
        self.anomalies.append(anomaly)
        self.registry.counter("health/anomalies",
                              detector=anomaly.detector,
                              severity=anomaly.severity).inc()
        self._m_last.set(anomaly.step)
        if self.tracer is not None:
            self.tracer.instant(f"anomaly/{anomaly.detector}",
                                step=anomaly.step,
                                severity=anomaly.severity,
                                value=anomaly.value)
        if self.runlog is not None:
            self.runlog.log("anomaly", detector=anomaly.detector,
                            step=anomaly.step, severity=anomaly.severity,
                            value=float(anomaly.value),
                            message=anomaly.message)
        if self.recorder is not None:
            path = self.recorder.dump(anomaly, tracer=self.tracer,
                                      registry=self.registry)
            if path is not None:
                self._m_dumps.inc()
            else:
                self._m_suppressed.inc()

    @property
    def healthy(self) -> bool:
        """False only under a sustained critical episode
        (>= ``unhealthy_after`` consecutive critical steps)."""
        return self._consecutive_critical < self.unhealthy_after

    def status(self) -> dict:
        """The ``/healthz`` payload: healthy bit, totals, and the last
        anomaly (if any) inlined."""
        with self._lock:
            out = {
                "healthy": self.healthy,
                "checks": self._m_checks.value,
                "anomalies": len(self.anomalies),
                "steps_skipped": self._m_skipped.value,
                "consecutive_critical": self._consecutive_critical,
            }
            if self.anomalies:
                out["last_anomaly"] = dataclasses.asdict(self.anomalies[-1])
            return out


class SLOTracker:
    """Serving SLO: windowed p99 latency vs a target + error-budget burn.

    The SLO is "fraction of requests over ``target_s`` stays within
    ``1 - objective``" over the trailing ``window`` requests. ``burn``
    is the violating fraction divided by the allowance — burn 1.0 means
    the budget is exactly spent; past it ``ready`` flips False (and
    recovers as the window slides, so a transient brown-out self-heals
    without a restart). Gauges/counters land on the injected registry
    under ``<name>/slo_*`` and the endpoint's ``/healthz`` serves
    ``status()`` (obs/export.py).
    """

    def __init__(self, *, target_s: float, objective: float = 0.99,
                 window: int = 256,
                 registry: Optional[obs_metrics.Registry] = None,
                 name: str = "serve"):
        if not 0 < objective < 1:
            raise ValueError(f"objective={objective} outside (0, 1)")
        if target_s <= 0:
            raise ValueError(f"target_s={target_s} must be > 0")
        self.target_s = float(target_s)
        self.objective = float(objective)
        self.window = SlidingWindow(window)
        self._violations = SlidingWindow(window)   # 1.0 per violating req
        self.registry = registry if registry is not None \
            else obs_metrics.Registry()
        self._lock = threading.Lock()
        self._m_requests = self.registry.counter(f"{name}/slo_requests")
        self._m_violations = self.registry.counter(f"{name}/slo_violations")
        self._m_p99 = self.registry.gauge(f"{name}/slo_p99_s")
        self._m_burn = self.registry.gauge(f"{name}/slo_error_budget_burn")
        self._m_ready = self.registry.gauge(f"{name}/slo_ready")
        self._m_ready.set(1)

    def observe(self, latency_s: float) -> None:
        """Record one request latency and refresh the derived gauges."""
        v = float(latency_s)
        with self._lock:
            self.window.push(v)
            violated = v > self.target_s
            self._violations.push(1.0 if violated else 0.0)
            self._m_requests.inc()
            if violated:
                self._m_violations.inc()
            self._m_p99.set(self.window.percentile(99))
            self._m_burn.set(self._burn())
            self._m_ready.set(1 if self._ready() else 0)

    def _burn(self) -> float:
        n = self._violations.count
        if n == 0:
            return 0.0
        frac = sum(self._violations.values()) / n
        return frac / (1.0 - self.objective)

    def _ready(self) -> bool:
        return self._burn() < 1.0

    @property
    def ready(self) -> bool:
        """True while the windowed error budget is not exhausted."""
        with self._lock:
            return self._ready()

    def status(self) -> dict:
        """The ``/healthz`` payload: readiness + the SLO arithmetic."""
        with self._lock:
            return {
                "healthy": self._ready(),
                "target_s": self.target_s,
                "objective": self.objective,
                "p99_s": self.window.percentile(99),
                "error_budget_burn": self._burn(),
                "window_count": self.window.count,
                "requests": self._m_requests.value,
                "violations": self._m_violations.value,
            }


# -- step fault-hook seam ----------------------------------------------------
# The trainer applies this hook to every batch right before the device step
# (launch/train_distributed.py). Tests use it to inject a poisoned batch at
# an exact step (and to probe the live /metrics endpoint mid-run); it is
# also the natural seat for chaos drills against a real run. The hook
# signature is fn(step, batch) -> batch (return the input unchanged for a
# pure probe).
_STEP_FAULT_HOOK: Optional[Callable] = None


def set_step_fault_hook(fn: Optional[Callable]) -> None:
    """Install (or clear, with None) the process-wide step fault hook."""
    global _STEP_FAULT_HOOK
    _STEP_FAULT_HOOK = fn


def apply_step_fault_hook(step: int, batch):
    """Run the installed hook on (step, batch); identity when none."""
    if _STEP_FAULT_HOOK is None:
        return batch
    return _STEP_FAULT_HOOK(step, batch)


def monitor_wall_time(fn, slo: SLOTracker):
    """Wrap a callable so each invocation's wall time feeds ``slo`` —
    the one-liner for instrumenting an existing serving entry point."""
    def wrapped(*a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            slo.observe(time.perf_counter() - t0)
    return wrapped
