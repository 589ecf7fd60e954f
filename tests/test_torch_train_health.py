"""The distributed trainer's health tier (``train_distributed --health
--metrics-port``) and its step guard, on the CPU.

- A smoke BASIC-S run of the port's trainer with ``--health --metrics-port
  0`` and a NaN image batch injected at step 1 through
  ``set_step_fault_hook``: exactly that step is skipped (its loss NaN, the
  params and optimizer state the step received equal to those the next
  step receives), steps 0 and 2 are finite, ``health/steps_skipped`` is 1,
  the nonfinite detector fires critical at step 1 (a runlog record each
  for the loss and the gradient norm), one flight dump, the step record
  marked ``skipped``, /healthz and /metrics answer 200 mid-run, and
  ``obs.report --health`` shows the trail. Under ``--objective lm`` on
  the smoke Llama every step is watched and /healthz served.
- The guarded step against the reference's ``make_contrastive_step(...,
  skip_nonfinite=True)`` on one device (no mesh: the reference's
  materialising loss) from the same weights and batches: a poisoned batch
  is skipped by both, finite batches give the reference's loss and
  gradient norm. The guarded run's finite steps are bit for bit those of
  an unguarded run; ``lm_step``'s guard likewise.
"""
from __future__ import annotations

import json
import math
import os
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import smoke_dual_variant as jax_smoke_dual
from repro.launch import steps as jsteps
from repro.models import dual_encoder as jde
from repro_torch import interop
from repro_torch.configs import get_arch, smoke_dual_variant, smoke_variant
from repro_torch.data import contrastive_batch, load_tokenizer, \
    world_for_tower
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.launch import train_distributed as td
from repro_torch.models import frontends
from repro_torch.obs import health, report, runlog
from repro_torch.optim import AdaFactorW
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)
NAN_STEP = 1
CONTRASTIVE = ["--arch", "basic-s", "--smoke", "--device", "cpu", "--batch",
               "8", "--seq", "16", "--num-micro", "2", "--loss", "local",
               "--precision", "f32", "--steps", "3", "--lr", "3e-4",
               "--quiet", "--health", "--metrics-port", "0"]
LM = ["--arch", "llama3.2-1b", "--smoke", "--device", "cpu", "--batch", "2",
      "--seq", "16", "--steps", "3", "--lr", "3e-3", "--quiet", "--health",
      "--metrics-port", "0"]


def _poison(batch):
    """A contrastive ``batch`` with its images turned NaN."""
    images = dict(batch["images"])
    images["image"] = batch["images"]["image"] * float("nan")
    return dict(batch, images=images)


def _run(argv, run_dir, poison):
    """The trainer's ``main`` with a hook that poisons step NAN_STEP and
    scrapes the live endpoint at the next step; returns (losses,
    probes)."""
    probes = {}

    def hook(step, batch):
        if step == NAN_STEP:
            batch = poison(batch)
        if step == NAN_STEP + 1:
            with open(os.path.join(run_dir, "metrics_port")) as f:
                port = int(f.read())
            for ep in ("healthz", "metrics"):
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/{ep}", timeout=10) as r:
                    probes[ep] = (r.status, r.read().decode())
        return batch
    health.set_step_fault_hook(hook)
    try:
        losses = td.main(argv + ["--run-dir", run_dir])
    finally:
        health.set_step_fault_hook(None)
    return losses, probes


@pytest.fixture
def recorded(monkeypatch):
    """Each contrastive step call's incoming (params, opt_state)."""
    log = []
    make = tsteps.make_contrastive_step

    def recording(*a, **kw):
        step_fn, opt = make(*a, **kw)

        def step(params, opt_state, batch):
            log.append((params, opt_state))
            return step_fn(params, opt_state, batch)
        return step, opt
    monkeypatch.setattr(tsteps, "make_contrastive_step", recording)
    return log


def _same(a, b):
    """Every leaf bit for bit (NaN payloads included)."""
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x.reshape(-1).contiguous().view(torch.uint8),
                    y.reshape(-1).contiguous().view(torch.uint8))
        for x, y in zip(la, lb))


def _check_outcome(run_dir, losses, probes, log):
    finite = [math.isfinite(v) for v in losses]
    assert finite == [i != NAN_STEP for i in range(3)], losses
    assert _same(log[NAN_STEP], log[NAN_STEP + 1])       # state kept
    assert not _same(log[0][0], log[1][0])               # step 0 moved it
    recs = runlog.read_runlog(os.path.join(run_dir, "runlog.jsonl"))
    anomalies = [r for r in recs if r["kind"] == "anomaly"]
    assert [(a["detector"], a["step"], a["severity"]) for a in anomalies] \
        == [("nonfinite", NAN_STEP, "critical")] * 2
    steps = {r["step"]: r for r in recs if r["kind"] == "step"}
    assert steps[NAN_STEP]["skipped"] == 1
    assert all("skipped" not in steps[i] for i in steps if i != NAN_STEP)
    final = [r for r in recs if r["kind"] == "metrics"][-1]
    assert final["counters"]["health/steps_skipped"] == 1
    assert final["counters"][
        "health/anomalies{detector=nonfinite,severity=critical}"] == 2
    assert os.listdir(os.path.join(run_dir, "flight")) == \
        [f"step{NAN_STEP:06d}_nonfinite"]
    dump = os.path.join(run_dir, "flight", f"step{NAN_STEP:06d}_nonfinite")
    assert sorted(os.listdir(dump)) == ["anomaly.json", "metrics.json",
                                        "steps.jsonl", "trace.json"]
    code, body = probes["healthz"]
    assert code == 200 and json.loads(body)["healthy"] is True
    assert json.loads(body)["steps_skipped"] == 1
    code, body = probes["metrics"]
    assert code == 200 and "# TYPE health_checks counter" in body
    assert 'health_anomalies{detector="nonfinite",severity="critical"} 2' \
        in body


def test_contrastive_health_run_skips_the_nan_step(tmp_path, recorded,
                                                    capsys):
    rd = str(tmp_path / "run")
    losses, probes = _run(CONTRASTIVE, rd, _poison)
    _check_outcome(rd, losses, probes, recorded)
    capsys.readouterr()
    assert report.main([os.path.join(rd, "runlog.jsonl"), "--health"]) == 0
    out = capsys.readouterr().out
    assert "health: 2 anomaly record(s)" in out
    assert "health/steps_skipped = 1" in out


def test_lm_health_run_is_watched_and_served(tmp_path):
    """``--objective lm`` under ``--health --metrics-port 0``: every step is
    observed, none is skipped, /healthz answers 200 mid-run (a token batch
    cannot carry a NaN; ``lm_step``'s guard is tested below)."""
    rd = str(tmp_path / "run")
    losses, probes = _run(LM, rd, lambda b: b)
    assert all(math.isfinite(v) for v in losses)
    final = [r for r in runlog.read_runlog(os.path.join(rd, "runlog.jsonl"))
             if r["kind"] == "metrics"][-1]
    assert final["counters"]["health/checks"] == 3
    assert final["counters"]["health/steps_skipped"] == 0
    assert probes["healthz"][0] == 200
    assert not os.path.exists(os.path.join(rd, "flight"))


# -- the guarded step against the reference's --------------------------------

@pytest.fixture(scope="module")
def setup():
    jcfg = jax_smoke_dual(jax_get_arch("basic-s"))
    tcfg = smoke_dual_variant(get_arch("basic-s"))
    jparams = jax.device_get(jde.init_params(jcfg, jax.random.key(0)))
    rng = np.random.default_rng(0)
    world = world_for_tower(rng, tcfg.image_tower, n_classes=16)
    batches = [contrastive_batch(world, load_tokenizer(), 8, rng)[0]
               for _ in range(3)]
    return jcfg, tcfg, jparams, batches


def _nan_images(batch):
    bad = {k: dict(v) for k, v in batch.items()}
    bad["images"]["image"] = batch["images"]["image"].copy()
    bad["images"]["image"][2, 0, 0, 0] = np.nan
    return bad


def test_guarded_step_matches_reference_guard(setup):
    jcfg, tcfg, jparams, batches = setup
    kw = dict(num_micro=2, precision="f32", loss="local", remat="basic",
              lr=1e-3, skip_nonfinite=True)
    jstep, jo = jsteps.make_contrastive_step(jcfg, **kw)
    tstep, to = tsteps.make_contrastive_step(tcfg, **kw)
    jstep = jax.jit(jstep)
    jp = jax.tree.map(jnp.asarray, jparams)
    js = jo.init(jp)
    tp = interop.from_numpy(jparams, "cpu")
    ts = to.init(tp)
    seq = [batches[0], _nan_images(batches[1]), batches[2]]
    for i, b in enumerate(seq):
        jp2, js2, jl, jm = jstep(jp, js, jax.tree.map(jnp.asarray, b))
        tp2, ts2, tl, tm = tstep(tp, ts, ttrain.batch_to(b, "cpu"))
        assert int(tm["skipped"]) == int(jm["skipped"]) == (i == 1)
        if i == 1:
            assert not math.isfinite(float(tl))
            assert not math.isfinite(float(jl))
            assert _same(tp2, tp) and _same(ts2, ts)
            np.testing.assert_array_equal(
                np.asarray(jp2["text"]["proj"]), np.asarray(jp["text"]["proj"]))
        else:
            assert float(tl) == pytest.approx(float(jl), rel=1e-4)
            assert float(tm["grad_norm"]) == pytest.approx(
                float(jm["grad_norm"]), rel=1e-3)
        jp, js, tp, ts = jp2, js2, tp2, ts2


def test_guarded_finite_steps_are_the_unguarded_ones(setup):
    _, tcfg, jparams, batches = setup
    runs = []
    for guard in (False, True):
        step, opt = tsteps.make_contrastive_step(
            tcfg, num_micro=2, precision="f32", loss="local", lr=1e-3,
            skip_nonfinite=guard)
        p = interop.from_numpy(jparams, "cpu")
        s = opt.init(p)
        losses = []
        for b in batches:
            p, s, loss, _ = step(p, s, ttrain.batch_to(b, "cpu"))
            losses.append(loss.item())
        runs.append((losses, p, s))
    assert runs[0][0] == runs[1][0]
    assert _same(runs[0][1], runs[1][1]) and _same(runs[0][2], runs[1][2])


def test_lm_step_guard_skips_and_keeps_finite_steps_exact():
    cfg = smoke_variant(get_arch("llama3.2-1b"))
    opt = AdaFactorW(weight_decay=0.0025)
    params0 = interop.init_params(cfg, torch.Generator().manual_seed(0),
                                  "cpu")
    rng = np.random.default_rng(0)
    batches = [frontends.synthetic_inputs(cfg, 2, 16, rng, device="cpu")
               for _ in range(2)]
    out = []
    for guard in (False, True):
        step = tsteps.lm_step(cfg, opt, 1e-3, precision="f32",
                              skip_nonfinite=guard)
        p, s = params0, opt.init(params0)
        losses = []
        for b in batches:
            p, s, loss, m = step(p, s, b)
            losses.append(loss.item())
        out.append((losses, p, m))
    assert out[0][0] == out[1][0] and _same(out[0][1], out[1][1])
    assert "skipped" not in out[0][2] and int(out[1][2]["skipped"]) == 0
    step = tsteps.lm_step(cfg, opt, 1e-3, precision="f32",
                          skip_nonfinite=True)
    state = opt.init(params0)
    bad = dict(params0, embed=params0["embed"] * float("nan"))
    new_p, new_s, loss, m = step(bad, state, batches[0])
    assert int(m["skipped"]) == 1 and not math.isfinite(loss.item())
    assert _same(new_p, bad) and _same(new_s, state)
