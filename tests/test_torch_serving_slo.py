"""The serving side of the health tier on the CPU: SLOs and the live
endpoint of ``ZeroShotService`` and the continuous engine, the launchers'
``--slo-ms`` / ``--metrics-port`` / ``--retrieval`` / ``--nprobe`` flags,
and ``obs.report --health`` / ``--serving`` against the reference's
report.

- ``ZeroShotService(latency_slo_s=)``: every ``classify`` / ``retrieve``
  call feeds the tracker (``serve/slo_*``); ``serve_metrics()`` serves
  /metrics with the SLO and retrieval series, /healthz 200 while the
  budget holds and 503 once a target below the calls' latency burns it,
  and /snapshot.json. ``stats()["slo"]`` has the reference tracker's
  status keys.
- The continuous engine under ``latency_slo_s``: one observation per
  request, ``decode/slo_*`` gauges, the endpoint.
- ``launch.serve`` and ``launch.serve_zeroshot`` accept the flags and
  print the reference's ``slo:`` line.
- ``repro_torch.obs.report --health`` of a runlog and ``--serving`` of a
  service's stats print what the reference's report prints for the same
  files.
"""
from __future__ import annotations

import json
import math
import os
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from repro.obs import health as jh
from repro.obs import report as jreport
from repro_torch import interop
from repro_torch.configs import get_arch, smoke_dual_variant, smoke_variant
from repro_torch.data import load_tokenizer, render_images, world_for_tower
from repro_torch.launch import serve as tserve
from repro_torch.launch import serve_zeroshot
from repro_torch.models import dual_encoder as de
from repro_torch.obs import health, metrics, report, runlog, trace
from repro_torch.serving import ContinuousEngine, ZeroShotService

torch.set_num_threads(1)


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


@pytest.fixture(scope="module")
def dual():
    cfg = smoke_dual_variant(get_arch("basic-s"))
    params = de.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    world = world_for_tower(rng, cfg.image_tower, n_classes=10)
    images = render_images(world, rng.integers(0, 10, 4), rng)
    gallery = rng.standard_normal((200, cfg.embed_dim)).astype(np.float32)
    gallery /= np.linalg.norm(gallery, axis=1, keepdims=True)
    return cfg, params, world, images, gallery


@pytest.mark.parametrize("mode", ["fused", "sharded", "twostage"])
def test_service_slo_and_live_endpoint(dual, mode):
    cfg, params, world, images, gallery = dual
    kw = {"mesh": ["cpu"] * 4} if mode == "sharded" else {}
    with ZeroShotService(cfg, params, load_tokenizer(), device="cpu",
                         max_delay_ms=1.0, retrieval=mode,
                         latency_slo_s=60.0, index_blocks=6, **kw) as svc:
        server = svc.serve_metrics(port=0)
        try:
            svc.classify(images, world.class_names, k=3)
            svc.retrieve(["a photo", "an image"], gallery, k=4)
            code, text = _get(f"{server.url}/metrics")
            assert code == 200
            for series in ("serve_slo_requests 2", "serve_slo_ready 1",
                           "# TYPE serve_slo_p99_s gauge",
                           "serve_retrieval_latency_s_bucket{mode=\"" +
                           mode + "\",stage=\"total\""):
                assert series in text, series
            code, body = _get(f"{server.url}/healthz")
            assert code == 200 and json.loads(body)["requests"] == 2
            code, body = _get(f"{server.url}/snapshot.json")
            assert code == 200 and json.loads(body)["counters"][
                "serve/slo_requests"] == 2
        finally:
            server.stop()
        status = svc.stats()["slo"]
    ref = jh.SLOTracker(target_s=60.0).status()
    assert status.keys() == ref.keys()
    assert status["requests"] == 2 and status["violations"] == 0


def test_service_slo_burns_out_and_endpoint_turns_503(dual):
    cfg, params, world, images, gallery = dual
    with ZeroShotService(cfg, params, load_tokenizer(), device="cpu",
                         max_delay_ms=1.0, latency_slo_s=1e-9,
                         slo_window=8) as svc:
        with svc.serve_metrics() as server:
            assert _get(f"{server.url}/healthz")[0] == 200
            svc.retrieve(["x"], gallery, k=2)
            code, body = _get(f"{server.url}/healthz")
        assert code == 503 and json.loads(body)["healthy"] is False
        assert svc.slo.ready is False
    with ZeroShotService(cfg, params, load_tokenizer(), device="cpu",
                         max_delay_ms=1.0) as svc:
        assert svc.slo is None and "slo" not in svc.stats()
        with svc.serve_metrics() as server:
            assert _get(f"{server.url}/healthz") == (200,
                                                     '{"healthy": true}\n')
    with pytest.raises(ValueError, match="retrieval="):
        ZeroShotService(cfg, params, load_tokenizer(), device="cpu",
                        retrieval="ivf")


def test_continuous_engine_slo_and_endpoint():
    cfg = smoke_variant(get_arch("llama3.2-1b"))
    params = interop.init_params(cfg, torch.Generator().manual_seed(0),
                                 "cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(4, cfg.vocab, (n,), dtype=np.int32)
               for n in (5, 6, 7, 8)]
    eng = ContinuousEngine(cfg, params, cache_len=32, num_slots=2,
                           latency_slo_s=1e-9)
    server = eng.serve_metrics(port=0)
    try:
        eng.run([(p, 1 + i % 3) for i, p in enumerate(prompts)])
        snap = eng.stats()
        code, text = _get(f"{server.url}/metrics")
        health_code, _ = _get(f"{server.url}/healthz")
    finally:
        server.stop()
    assert snap["slo"]["requests"] == 4 and snap["slo"]["violations"] == 4
    assert snap["gauges"]["decode/slo_ready"] == 0
    assert code == 200 and "decode_slo_requests 4" in text
    assert health_code == 503
    easy = ContinuousEngine(cfg, params, cache_len=32, num_slots=2,
                            latency_slo_s=600.0)
    easy.run([(prompts[0], 2)])
    assert easy.stats()["slo"]["healthy"] is True


@pytest.mark.parametrize("retrieval", ["fused", "sharded", "twostage"])
def test_serve_zeroshot_flags(retrieval, capsys):
    rep = serve_zeroshot.main([
        "--smoke", "--device", "cpu", "--classes", "12", "--batch", "2",
        "--requests", "2", "--retrieval", retrieval, "--nprobe", "2",
        "--slo-ms", "60000", "--metrics-port", "0"])
    out = capsys.readouterr().out
    assert "obs: serving /metrics /healthz /snapshot.json on " in out
    assert "slo: p99" in out and "READY" in out
    assert rep["stats"]["retrieval_mode"] == retrieval
    assert rep["slo"]["requests"] == 3
    assert rep["last_result"].indices.shape == (2, 5)


def test_serve_flags(capsys):
    rep = tserve.main(["--arch", "llama3.2-1b", "--smoke", "--device", "cpu",
                       "--engine", "continuous", "--requests", "3",
                       "--slots", "2", "--prompt-len", "8", "--max-new",
                       "3", "--slo-ms", "60000", "--metrics-port", "0"])
    out = capsys.readouterr().out
    assert rep["slo"]["requests"] == 3 and "slo: p99" in out
    assert "obs: serving /metrics" in out


def _health_runlog(path, run_dir):
    """A runlog with steps, anomalies and a final metrics record, written
    through the port's RunLogger and HealthMonitor."""
    reg = metrics.Registry()
    log = runlog.RunLogger(path, meta={"arch": "basic-s"})
    mon = health.HealthMonitor(registry=reg, tracer=trace.Tracer(),
                               runlog=log, run_dir=run_dir)
    slo = health.SLOTracker(target_s=0.01, registry=reg)
    for i in range(40):
        loss = math.nan if i in (7, 8) else 3.0 - 0.01 * i
        gnorm = 300.0 if i == 30 else 1.0 + 0.01 * (i % 3)
        rec = log.log_step(i, loss=loss, data_wait_s=0.01,
                           device_step_s=0.1, ckpt_stall_s=0.0, step_s=0.12,
                           examples_per_sec=64.0, grad_norm=gnorm)
        mon.observe_step(health.StepSample(
            step=i, loss=loss, grad_norm=gnorm, data_wait_s=0.01,
            device_step_s=0.1, step_s=0.12,
            skipped=not math.isfinite(loss)), record=rec)
        slo.observe(0.005 if i % 5 else 0.02)
    log.log("metrics", **reg.snapshot())
    log.close()


def test_report_health_prints_the_reference_text(tmp_path, capsys):
    path = str(tmp_path / "runlog.jsonl")
    _health_runlog(path, str(tmp_path))
    assert report.main([path, "--health"]) == 0
    got = capsys.readouterr().out
    assert jreport.main([path, "--health"]) == 0
    want = capsys.readouterr().out
    assert got == want
    assert "health: 3 anomaly record(s)" in got
    assert "error budget: EXHAUSTED" in got


def test_report_serving_prints_the_reference_text(dual, tmp_path, capsys):
    cfg, params, world, images, gallery = dual
    for mode, kw in (("twostage", {"index_blocks": 5}),
                     ("sharded", {"mesh": ["cpu"] * 2})):
        with ZeroShotService(cfg, params, load_tokenizer(), device="cpu",
                             max_delay_ms=1.0, retrieval=mode, **kw) as svc:
            svc.retrieve(["a", "b", "c"], gallery, k=3)
            svc.retrieve(["d"], gallery, k=3, nprobe=1) if mode == \
                "twostage" else svc.retrieve(["d"], gallery, k=3)
            stats = svc.stats()
        path = str(tmp_path / f"{mode}.json")
        with open(path, "w") as f:
            json.dump(stats, f)
        assert report.main([path, "--serving"]) == 0
        got = capsys.readouterr().out
        assert jreport.main([path, "--serving"]) == 0
        assert got == capsys.readouterr().out
        assert ("prune ratio" if mode == "twostage" else "shard skew") in got
    empty = str(tmp_path / "empty.json")
    with open(empty, "w") as f:
        json.dump({"counters": {}}, f)
    assert report.main([empty, "--serving"]) == 0
    assert "no serve/retrieval_* series" in capsys.readouterr().out
