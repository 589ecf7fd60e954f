"""Port parity: Prometheus exposition and the live endpoint
(``repro_torch.obs.export``) against the reference's ``repro.obs.export``.

``render_prometheus`` of the same snapshot must give the reference's text
byte for byte, and the golden ``artifacts/metrics_sample.prom`` for the
registry the reference's golden test builds; snapshots taken from the
port's registry render as the reference's own. ``MetricsServer`` is stood
up on an ephemeral loopback port and scraped: /metrics, /healthz 200 and
503 from a live health source, /snapshot.json, 404, the port file, and a
stop that frees the port.
"""
from __future__ import annotations

import json
import math
import os
import urllib.error
import urllib.request

import numpy as np
import pytest

from repro.obs import export as je
from repro.obs import metrics as jm
from repro_torch.obs import export as te
from repro_torch.obs import metrics as tm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "artifacts", "metrics_sample.prom")


def _golden_registry(mod):
    """The registry of the reference's golden test, on ``mod``'s
    ``Registry``."""
    reg = mod.Registry()
    reg.counter("train/steps").inc(42)
    reg.counter("data/bytes-read", host=0).inc(1024)
    reg.counter("data/bytes-read", host=1).inc(2048)
    reg.counter("serve/requests", route='cls "a\\b"').inc(7)
    reg.gauge("health/healthy").set(1)
    reg.gauge("train/loss").set(2.718281828459045)
    reg.gauge("health/last_p99_s").set(math.nan)
    reg.gauge("serve/burn").set(math.inf)
    h = reg.histogram("serve/latency_s", buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.05, 0.05, 0.5, 5.0):
        h.observe(v)
    return reg


def _serving_registry(mod, seed):
    """A registry shaped like a serving run's: labelled retrieval latency
    histograms on the default buckets, ratio histograms, SLO gauges,
    odd names and label values."""
    rng = np.random.default_rng(seed)
    reg = mod.Registry()
    for mode in ("fused", "sharded", "twostage"):
        for stage in ("total", "coarse", "rerank"):
            h = reg.histogram("serve/retrieval_latency_s", mode=mode,
                              stage=stage)
            for v in rng.exponential(0.01, 17):
                h.observe(float(v))
    r = reg.histogram("serve/retrieval_prune_ratio",
                      buckets=mod.RATIO_BUCKETS, mode="twostage")
    for v in rng.uniform(0, 1, 9):
        r.observe(float(v))
    reg.counter("serve/slo_requests").inc(int(rng.integers(1, 100)))
    reg.gauge("serve/slo_p99_s").set(float(rng.exponential(0.1)))
    reg.gauge("serve/slo_error_budget_burn").set(
        [0.0, 1.5, math.inf, math.nan][seed % 4])
    reg.gauge("9-odd.name", lab="x\\\"y").set(-3.0)
    reg.counter("health/anomalies", detector="nonfinite",
                severity="critical").inc(2)
    return reg


def test_render_matches_the_golden_file_and_reference():
    got = te.render_prometheus(_golden_registry(tm).snapshot())
    with open(GOLDEN) as f:
        assert got == f.read()
    assert got == je.render_prometheus(_golden_registry(jm).snapshot())


@pytest.mark.parametrize("seed", range(4))
def test_render_matches_reference_byte_for_byte(seed):
    tsnap = _serving_registry(tm, seed).snapshot()
    jsnap = _serving_registry(jm, seed).snapshot()
    assert json.dumps(tsnap, sort_keys=True) == \
        json.dumps(jsnap, sort_keys=True)
    got = te.render_prometheus(tsnap)
    assert got == je.render_prometheus(tsnap) == je.render_prometheus(jsnap)
    assert got.endswith("\n")


@pytest.mark.parametrize("snap", [
    {}, {"counters": {}}, {"gauges": {"a{k=v}": 0.5, "a{k=w}": 1e20}},
    {"histograms": {"h": {"buckets": [], "count": 0, "sum": 0.0}}}])
def test_render_edge_snapshots_match_reference(snap):
    assert te.render_prometheus(snap) == je.render_prometheus(snap)


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=5) as r:
            return r.status, r.headers.get("Content-Type"), r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read().decode()


def test_metrics_server_endpoints(tmp_path):
    reg = _serving_registry(tm, 1)
    health = {"healthy": True, "checks": 3}
    with te.MetricsServer(reg, health=lambda: dict(health),
                          run_dir=str(tmp_path)) as srv:
        assert srv.host == "127.0.0.1" and srv.port > 0
        assert int((tmp_path / "metrics_port").read_text()) == srv.port
        code, ctype, body = _get(f"{srv.url}/metrics")
        assert code == 200 and ctype == je.CONTENT_TYPE == te.CONTENT_TYPE
        assert body == je.render_prometheus(reg.snapshot())
        code, ctype, body = _get(f"{srv.url}/healthz?x=1")
        assert (code, ctype) == (200, "application/json")
        assert json.loads(body) == health
        health["healthy"] = False
        assert _get(f"{srv.url}/healthz")[0] == 503
        code, _, body = _get(f"{srv.url}/snapshot.json")
        assert code == 200 and json.loads(body)["counters"] == \
            json.loads(reg.to_json())["counters"]
        assert _get(f"{srv.url}/missing")[0] == 404
        port = srv.port
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=1)


def test_metrics_server_without_health_source_and_restart():
    srv = te.MetricsServer(tm.Registry())
    srv.start()
    srv.start()
    code, _, body = _get(f"{srv.url}/healthz")
    assert code == 200 and json.loads(body) == {"healthy": True}
    assert _get(f"{srv.url}/metrics")[2] == "\n"
    srv.stop()
    srv.stop()
