"""Live metrics endpoint: Prometheus text exposition + stdlib HTTP (copy of
``repro/obs/export.py``, §14.3).

Two layers, deliberately separable:

  render_prometheus(snapshot)   pure function from any ``Registry``
                                snapshot to Prometheus text-exposition
                                format 0.0.4 — counters/gauges as single
                                samples, histograms as the full
                                ``_bucket{le=...}`` / ``_sum`` /
                                ``_count`` ladder. Golden-file tested.
  MetricsServer                 a ``http.server.ThreadingHTTPServer`` on
                                a daemon thread serving ``/metrics``
                                (scrape), ``/healthz`` (readiness: 200 or
                                503 from the attached health source), and
                                ``/snapshot.json`` (the raw registry
                                JSON, for humans and tests).

Security posture: the server binds ``127.0.0.1`` by DEFAULT — the
endpoint exposes run internals with no auth, so exposure beyond the host
is an explicit ``host="0.0.0.0"`` opt-in behind whatever network policy
the deployment provides (DESIGN.md §14.3). ``port=0`` asks the kernel for
an ephemeral port; the bound port is re-read from ``server.port`` and,
when a ``run_dir`` is given, written to ``<run_dir>/metrics_port`` so
out-of-process scrapers (and tests) can find it.
"""
from __future__ import annotations

import http.server
import json
import os
import re
import threading
from typing import Callable, Optional

from repro_torch.obs import metrics as obs_metrics

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")
_SERIES = re.compile(r"^(?P<name>[^{]+)(?:\{(?P<labels>.*)\})?$")


def _sanitize_name(name: str) -> str:
    """Map a registry name (``serve/requests``) onto the Prometheus
    metric-name alphabet (``serve_requests``)."""
    out = _NAME_OK.sub("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    return out


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _parse_series(series: str):
    """Split a snapshot series key (``name{k=v,k2=v2}``) back into
    (sanitized_name, [(k, v), ...])."""
    m = _SERIES.match(series)
    name = _sanitize_name(m.group("name"))
    raw = m.group("labels")
    labels = []
    if raw:
        for pair in raw.split(","):
            k, _, v = pair.partition("=")
            labels.append((_sanitize_name(k), v))
    return name, labels


def _label_str(labels) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label(str(v))}"' for k, v in labels)
    return "{" + inner + "}"


def _fmt(v: float) -> str:
    f = float(v)
    if f != f:
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def render_prometheus(snapshot: dict) -> str:
    """Render a ``Registry.snapshot()`` dict as Prometheus text
    exposition format 0.0.4.

    Series sharing a base name are grouped under one ``# TYPE`` header;
    histogram summaries become the cumulative ``_bucket{le=...}`` ladder
    (finite bounds from the summary's ``buckets`` key, then the implied
    ``le="+Inf"`` = ``count``) plus ``_sum`` and ``_count`` samples.
    Output ends with a trailing newline as the format requires.
    """
    lines = []

    def emit_scalars(kind: str, table: dict) -> None:
        by_name: dict = {}
        for series, value in sorted(table.items()):
            name, labels = _parse_series(series)
            by_name.setdefault(name, []).append((labels, value))
        for name, rows in sorted(by_name.items()):
            lines.append(f"# TYPE {name} {kind}")
            for labels, value in rows:
                lines.append(f"{name}{_label_str(labels)} {_fmt(value)}")

    emit_scalars("counter", snapshot.get("counters", {}))
    emit_scalars("gauge", snapshot.get("gauges", {}))

    by_name: dict = {}
    for series, summ in sorted(snapshot.get("histograms", {}).items()):
        name, labels = _parse_series(series)
        by_name.setdefault(name, []).append((labels, summ))
    for name, rows in sorted(by_name.items()):
        lines.append(f"# TYPE {name} histogram")
        for labels, summ in rows:
            for le, cum in summ.get("buckets", []):
                lines.append(
                    f"{name}_bucket"
                    f"{_label_str(labels + [('le', _fmt(le))])} {cum}")
            lines.append(
                f"{name}_bucket"
                f"{_label_str(labels + [('le', '+Inf')])} {summ['count']}")
            lines.append(f"{name}_sum{_label_str(labels)} "
                         f"{_fmt(summ['sum'])}")
            lines.append(f"{name}_count{_label_str(labels)} "
                         f"{summ['count']}")
    return "\n".join(lines) + "\n"


class _Handler(http.server.BaseHTTPRequestHandler):
    """Routes ``/metrics`` / ``/healthz`` / ``/snapshot.json`` against the
    owning ``MetricsServer``'s registry and health source."""

    server_version = "repro-obs/1"

    def do_GET(self):  # noqa: N802 (stdlib handler naming)
        owner: "MetricsServer" = self.server.owner  # type: ignore[attr-defined]
        path = self.path.split("?", 1)[0]
        if path == "/metrics":
            body = render_prometheus(owner.registry.snapshot())
            self._reply(200, body, CONTENT_TYPE)
        elif path == "/healthz":
            status = owner.health_status()
            code = 200 if status.get("healthy", True) else 503
            self._reply(code, json.dumps(status, sort_keys=True) + "\n",
                        "application/json")
        elif path == "/snapshot.json":
            self._reply(200, owner.registry.to_json(indent=2) + "\n",
                        "application/json")
        else:
            self._reply(404, "not found\n", "text/plain")

    def _reply(self, code: int, body: str, ctype: str) -> None:
        data = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, fmt, *args):
        """Silence per-request stderr lines (scrapes arrive every few
        seconds; the trainer's stdout is for training)."""


class MetricsServer:
    """Serves a ``Registry`` (and optional health source) over HTTP.

    ``health`` is any zero-arg callable returning a dict with a boolean
    ``healthy`` key — ``HealthMonitor.status`` and ``SLOTracker.status``
    both fit; ``/healthz`` answers 200/503 from it (absent source: always
    healthy). The server thread is a daemon: it never blocks process
    exit, and ``stop()`` shuts it down deterministically for tests.
    """

    def __init__(self, registry: obs_metrics.Registry, *,
                 health: Optional[Callable[[], dict]] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 run_dir: Optional[str] = None):
        self.registry = registry
        self._health = health
        self.host = host
        self.run_dir = run_dir
        self._httpd = http.server.ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.owner = self  # type: ignore[attr-defined]
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def health_status(self) -> dict:
        """The current health payload (``{"healthy": True}`` when no
        source is attached)."""
        if self._health is None:
            return {"healthy": True}
        return self._health()

    def start(self) -> "MetricsServer":
        """Start serving on the daemon thread; idempotent. Writes the
        bound port to ``<run_dir>/metrics_port`` when a run dir was
        given, so other processes can discover an ephemeral port."""
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, name="obs-metrics-http",
                daemon=True)
            self._thread.start()
            if self.run_dir:
                with open(os.path.join(self.run_dir, "metrics_port"),
                          "w") as f:
                    f.write(f"{self.port}\n")
        return self

    def stop(self) -> None:
        """Shut the server down and join its thread; idempotent."""
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join(timeout=5)
            self._thread = None
        self._httpd.server_close()

    @property
    def url(self) -> str:
        """Base URL of the endpoint (``http://host:port``)."""
        return f"http://{self.host}:{self.port}"

    def __enter__(self) -> "MetricsServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
