"""Telemetry of the port (copies of the reference's framework-free
``repro/obs`` modules).

The passive layers: ``metrics`` (counters, gauges, histograms), ``trace``
(span ring buffer, Perfetto export) and ``runlog`` (schema-v1 JSONL per
train step, summarised by ``python -m repro_torch.obs.report``). The
active tier on top of them: ``windows`` (sliding-window percentiles,
rates, MAD z-scores), ``health`` (anomaly detectors, ``HealthMonitor``,
flight recorder, serving ``SLOTracker``, the step fault hook) and
``export`` (Prometheus text and the ``/metrics`` / ``/healthz`` /
``/snapshot.json`` endpoint on 127.0.0.1).
"""
from repro_torch.obs.export import MetricsServer, render_prometheus
from repro_torch.obs.health import (Anomaly, Detector, FlightRecorder,
                                    HealthMonitor, NonFiniteDetector,
                                    PlateauDetector, SLOTracker,
                                    SpikeDetector, StallDetector, StepSample,
                                    StragglerDetector, default_detectors,
                                    set_step_fault_hook)
from repro_torch.obs.metrics import (Counter, Gauge, Histogram, Registry,
                                     exponential_buckets, get_registry)
from repro_torch.obs.runlog import (RunLogger, RunlogError, SCHEMA_VERSION,
                                    STEP_BREAKDOWN_KEYS, read_runlog,
                                    validate_record)
from repro_torch.obs.trace import Tracer, span
from repro_torch.obs.windows import SlidingWindow, WindowedRate, percentile

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "exponential_buckets",
    "get_registry", "RunLogger", "RunlogError", "SCHEMA_VERSION",
    "STEP_BREAKDOWN_KEYS", "read_runlog", "validate_record", "Tracer",
    "span",
    "SlidingWindow", "WindowedRate", "percentile",
    "Anomaly", "Detector", "FlightRecorder", "HealthMonitor",
    "NonFiniteDetector", "PlateauDetector", "SLOTracker", "SpikeDetector",
    "StallDetector", "StepSample", "StragglerDetector",
    "default_detectors", "set_step_fault_hook",
    "MetricsServer", "render_prometheus",
]
