"""Port parity: the health tier (``repro_torch.obs.{windows,health}``)
against the reference objects (``repro.obs.{windows,health}``), fed the
same sequences on the CPU.

Both packages' modules are framework-free, so each port object is held to
its reference object exactly: windowed percentiles, means, MADs and
z-scores; every detector's anomalies on trajectories built to trip it (and
on a healthy one); ``HealthMonitor`` events, counters, healthy bits,
runlog records and flight dumps; ``SLOTracker`` p99, burn and readiness
as the window slides; ``WindowedRate`` under a fake clock; the step fault
hook and ``monitor_wall_time``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os

import numpy as np
import pytest

from repro.obs import health as jh
from repro.obs import metrics as jm
from repro.obs import runlog as jrl
from repro.obs import trace as jtr
from repro.obs import windows as jw
from repro_torch.obs import health as th
from repro_torch.obs import metrics as tm
from repro_torch.obs import runlog as trl
from repro_torch.obs import trace as ttr
from repro_torch.obs import windows as tw


def _same(a, b):
    """Equal floats, NaN equal to NaN."""
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return a == b


def _stream(kind: str, n: int = 400):
    rng = np.random.default_rng({"normal": 0, "heavy": 1, "ties": 2}[kind])
    if kind == "normal":
        return rng.standard_normal(n).tolist()
    if kind == "heavy":
        return (rng.standard_cauchy(n) * 3).tolist()
    return rng.integers(0, 4, n).astype(float).tolist()


@pytest.mark.parametrize("kind", ["normal", "heavy", "ties"])
@pytest.mark.parametrize("capacity", [1, 16, 64])
def test_sliding_window_matches_reference(kind, capacity):
    a, b = jw.SlidingWindow(capacity), tw.SlidingWindow(capacity)
    for j, v in enumerate(_stream(kind)):
        a.push(v)
        b.push(v)
        if j % 37 == 0 or j < 3:
            assert a.values() == b.values()
            assert (a.count, a.total, a.full) == (b.count, b.total, b.full)
            for q in (0, 10, 50, 90, 99, 100):
                assert _same(a.percentile(q), b.percentile(q))
            for fn in ("mean", "median", "mad", "min", "max"):
                assert _same(getattr(a, fn)(), getattr(b, fn)()), fn
            for x in (v, 0.0, 10.0, -3.5):
                assert _same(a.zscore(x), b.zscore(x))


def test_percentile_function_and_refusals_match():
    for vals in ([], [1.0], [3.0, 1.0, 2.0], _stream("heavy", 57)):
        for q in (0, 25, 50, 99.9, 100):
            assert _same(jw.percentile(vals, q), tw.percentile(vals, q))
    for bad in (-1, 101):
        with pytest.raises(ValueError):
            jw.percentile([1.0], bad)
        with pytest.raises(ValueError):
            tw.percentile([1.0], bad)
    for mod in (jw, tw):
        with pytest.raises(ValueError):
            mod.SlidingWindow(0)


def test_windowed_rate_matches_reference_under_a_fake_clock():
    now = [100.0]
    a = jw.WindowedRate(5.0, capacity=8, clock=lambda: now[0])
    b = tw.WindowedRate(5.0, capacity=8, clock=lambda: now[0])
    rng = np.random.default_rng(3)
    for _ in range(60):
        now[0] += float(rng.exponential(0.7))
        for r in (a, b):
            r.mark()
        assert a.rate() == b.rate()


# -- detectors ---------------------------------------------------------------

def _samples(kind: str, mod):
    """A trajectory of StepSamples built to trip one detector (or none)."""
    rng = np.random.default_rng(7)
    out = []
    for i in range(300):
        loss = 3.0 * math.exp(-i / 80) + 0.01 * rng.standard_normal()
        g = 1.0 + 0.05 * rng.standard_normal()
        wait = 0.01 + 0.001 * rng.random()
        if kind == "nonfinite" and i in (40, 41, 200):
            loss = math.nan if i != 41 else math.inf
            g = math.nan if i == 200 else g
        if kind == "spike" and i in (60, 150):
            g *= 300.0
            loss *= 50.0
        if kind == "plateau":
            loss = 1.0 + 1e-6 * rng.standard_normal()
        if kind == "stall" and i in (50, 120):
            wait = 5.0 if i == 50 else 90.0
        out.append(mod.StepSample(step=i, loss=loss, grad_norm=g,
                                  data_wait_s=wait, device_step_s=0.1,
                                  step_s=0.2, skipped=not math.isfinite(loss)))
    return out


DETECTORS = {
    "nonfinite": lambda m, reg: m.NonFiniteDetector(),
    "grad_spike": lambda m, reg: m.SpikeDetector("grad_norm"),
    "loss_spike": lambda m, reg: m.SpikeDetector("loss", window=32,
                                                 min_count=8, cooldown=3),
    "plateau": lambda m, reg: m.PlateauDetector(window=64),
    "stall": lambda m, reg: m.StallDetector(),
}


@pytest.mark.parametrize("kind", ["healthy", "nonfinite", "spike",
                                  "plateau", "stall"])
@pytest.mark.parametrize("det", sorted(DETECTORS))
def test_detector_matches_reference(det, kind):
    a = DETECTORS[det](jh, None)
    b = DETECTORS[det](th, None)
    got, want = [], []
    for sa, sb in zip(_samples(kind, jh), _samples(kind, th)):
        want += [dataclasses.asdict(x) for x in a.observe(sa)]
        got += [dataclasses.asdict(x) for x in b.observe(sb)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert all(_same(g[k], w[k]) for k in g), (g, w)
    if kind == "healthy" and det != "plateau":
        assert not got


def _straggler_registry(mod, slow: float):
    reg = mod.Registry()
    for host in range(4):
        h = reg.histogram("data/gen_seconds", host=host)
        for _ in range(10):
            h.observe(0.01 * (slow if host == 2 else 1.0))
    return reg


@pytest.mark.parametrize("slow", [1.0, 2.5, 10.0])
def test_straggler_matches_reference(slow):
    a = jh.StragglerDetector(_straggler_registry(jm, slow))
    b = th.StragglerDetector(_straggler_registry(tm, slow))
    for step in range(0, 64):
        want = a.observe(jh.StepSample(step=step))
        got = b.observe(th.StepSample(step=step))
        assert [dataclasses.asdict(x) for x in got] == \
            [dataclasses.asdict(x) for x in want]
    assert len(jh.default_detectors(_straggler_registry(jm, 1.0))) == \
        len(th.default_detectors(_straggler_registry(tm, 1.0))) == 6
    assert [d.name for d in th.default_detectors()] == \
        [d.name for d in jh.default_detectors()]


# -- the monitor ---------------------------------------------------------------

def _monitor_run(mod, metrics, runlog_mod, trace_mod, tmp, kind):
    reg = metrics.Registry()
    tracer = trace_mod.Tracer()
    log = runlog_mod.RunLogger(os.path.join(tmp, "runlog.jsonl"),
                               meta={"arch": "x"})
    mon = mod.HealthMonitor(registry=reg, tracer=tracer, runlog=log,
                            run_dir=tmp, max_dumps=2, unhealthy_after=3)
    healthy, statuses = [], []
    for s in _samples(kind, mod)[:160]:
        rec = log.log_step(s.step, loss=s.loss, data_wait_s=s.data_wait_s,
                           device_step_s=s.device_step_s, ckpt_stall_s=0.0,
                           step_s=s.step_s, examples_per_sec=1.0)
        mon.observe_step(s, record=rec)
        healthy.append(mon.healthy)
    statuses.append(mon.status())
    log.close()
    snap = reg.snapshot()
    recs = [dict(r, t=0) for r in runlog_mod.read_runlog(
        os.path.join(tmp, "runlog.jsonl"))]
    dumps = sorted(os.listdir(os.path.join(tmp, "flight"))) \
        if os.path.isdir(os.path.join(tmp, "flight")) else []
    files = {d: sorted(os.listdir(os.path.join(tmp, "flight", d)))
             for d in dumps}
    return healthy, statuses, snap, recs, dumps, files, [
        dataclasses.asdict(a) for a in mon.anomalies]


@pytest.mark.parametrize("kind", ["healthy", "nonfinite", "spike", "stall"])
def test_health_monitor_matches_reference(tmp_path, kind):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    want = _monitor_run(jh, jm, jrl, jtr, str(tmp_path / "j"), kind)
    got = _monitor_run(th, tm, trl, ttr, str(tmp_path / "t"), kind)
    names = ("healthy", "status", "snapshot", "runlog", "dumps", "files",
             "anomalies")
    for name, g, w in zip(names, got, want):
        if name in ("runlog", "anomalies", "status"):
            assert json.dumps(g, sort_keys=True, default=str) == \
                json.dumps(w, sort_keys=True, default=str), name
        else:
            assert g == w, name
    if kind == "nonfinite":
        assert got[2]["counters"]["health/steps_skipped"] == 2
        assert got[4] and got[6]


def test_monitor_turns_unhealthy_on_a_critical_storm_and_recovers():
    seq = [math.nan] * 4 + [1.0] + [math.nan] * 2
    bits = []
    for mod in (jh, th):
        mon = mod.HealthMonitor(detectors=[mod.NonFiniteDetector()],
                                unhealthy_after=3)
        out = []
        for i, v in enumerate(seq):
            mon.observe_step(mod.StepSample(step=i, loss=v, grad_norm=1.0,
                                            skipped=not math.isfinite(v)))
            out.append((mon.healthy, mon.status()["consecutive_critical"]))
        bits.append(out)
    assert bits[0] == bits[1]
    assert [h for h, _ in bits[1]] == [True, True, False, False, True, True,
                                      True]


# -- the SLO tracker ---------------------------------------------------------

@pytest.mark.parametrize("objective,window", [(0.99, 256), (0.9, 16),
                                              (0.5, 4)])
def test_slo_tracker_matches_reference(objective, window):
    rega, regb = jm.Registry(), tm.Registry()
    a = jh.SLOTracker(target_s=0.05, objective=objective, window=window,
                      registry=rega, name="serve")
    b = th.SLOTracker(target_s=0.05, objective=objective, window=window,
                      registry=regb, name="serve")
    rng = np.random.default_rng(5)
    lat = np.concatenate([rng.uniform(0.001, 0.04, 100),
                          rng.uniform(0.06, 0.2, 30),
                          rng.uniform(0.001, 0.04, 300)])
    flips = []
    for v in lat:
        a.observe(float(v))
        b.observe(float(v))
        sa, sb = a.status(), b.status()
        assert sa.keys() == sb.keys()
        assert all(_same(sa[k], sb[k]) for k in sa)
        assert a.ready == b.ready
        flips.append(b.ready)
    assert rega.snapshot() == regb.snapshot()
    assert not all(flips) and flips[-1]          # burnt out, then recovered


def test_slo_refusals_hook_and_wall_time_match_reference():
    for mod in (jh, th):
        with pytest.raises(ValueError):
            mod.SLOTracker(target_s=0.1, objective=1.0)
        with pytest.raises(ValueError):
            mod.SLOTracker(target_s=0.0)
    seen = []
    th.set_step_fault_hook(lambda step, batch: seen.append(step) or batch + 1)
    try:
        assert th.apply_step_fault_hook(3, 1) == 2
    finally:
        th.set_step_fault_hook(None)
    assert th.apply_step_fault_hook(4, 1) == 1 and seen == [3]
    slo = th.SLOTracker(target_s=10.0, registry=tm.Registry())
    fn = th.monitor_wall_time(lambda x: x * 2, slo)
    assert fn(21) == 42 and slo.status()["requests"] == 1
