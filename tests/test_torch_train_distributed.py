"""The port's distributed trainer against the reference's.

torch cannot redraw ``jax.random``'s weights, so the two trainers meet at
a checkpoint: the reference's ``repro.launch.train_distributed.train``
runs 4 steps (checkpoints at 2 and 4; BASIC-S smoke, f32, the chunked
loss; and Llama-3.2-1B smoke for the LM objective), in a subprocess with
two CPU devices, on a data extent of 1 and of 2. The port then resumes
from the reference's step-2 checkpoint, at R = 1 in this process and at
R = 2 on spawned gloo ranks (``tests/torch_spawn.py``), and must give the
reference's losses for steps 2 and 3 within rtol 1e-4
(``tests/test_train_distributed.py:56``) and its step-4 parameters and
AdaFactorW slots, leaf by leaf, within 1e-3 of the change steps 2-3 made
(both store the first moment in bf16). That holds the restore, the
loader's replay (the layout of R blocks and its state in the checkpoint
meta), GradAccum over each rank's block, the cross-shard loss, the
gradient all-reduce and the update together.

jax 0.9's ``jax.make_mesh`` gives Explicit axes, under which the
reference's contrastive trainer stops in ``with_sharding_constraint``
(``src/repro/core/gradaccum.py:69``); the subprocess hands it the
Auto-axis mesh it was written for by replacing the trainer module's
``make_local_mesh``. Nothing of the reference is edited.
"""
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from repro.obs import report as jreport
from repro.obs import runlog as jrunlog
from repro_torch.launch import train_distributed as td
from repro_torch.launch.spawn import run_world
from repro_torch.obs import report, runlog

sys.path.insert(0, os.path.dirname(__file__))

from torch_spawn import worker_train, worker_train_printed  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONTRASTIVE = ["--arch", "basic-s", "--smoke", "--batch", "16", "--seq",
               "16", "--lr", "3e-4", "--num-micro", "2", "--loss", "chunked",
               "--precision", "f32"]
LM = ["--arch", "llama3.2-1b", "--smoke", "--batch", "4", "--seq", "32",
      "--lr", "3e-3"]

_REFERENCE = r"""
import json, sys, types
import jax
from jax.sharding import AxisType
import repro.launch.train_distributed as rtd

def mesh_of(n):
    def make_local_mesh(model=1):
        return jax.make_mesh((n, model), ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2,
                             devices=jax.devices()[:n * model])
    return make_local_mesh

base = dict(objective="auto", smoke=True, steps=4, seed=0,
            sharding="basic_ws", remat="basic", model_parallel=1,
            log_every=100, ckpt_every=2, stop_after=None, quiet=True,
            run_dir=None)
contrastive = dict(arch="basic-s", batch=16, seq=16, lr=3e-4, num_micro=2,
                   loss="chunked", precision="f32")
lm = dict(arch="llama3.2-1b", batch=4, seq=32, lr=3e-3)
out = {}
for name, n, kw in (("contrastive_r1", 1, contrastive),
                    ("contrastive_r2", 2, contrastive), ("lm", 1, lm)):
    rtd.make_local_mesh = mesh_of(n)
    out[name] = rtd.train(types.SimpleNamespace(
        **base, **kw, ckpt_dir=f"{sys.argv[1]}/{name}"))
print("LOSSES " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """{run: (losses, checkpoint dir)} of the reference's three runs."""
    root = str(tmp_path_factory.mktemp("reference"))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS=os.environ.get("XLA_FLAGS", "")
               + " --xla_force_host_platform_device_count=2")
    proc = subprocess.run([sys.executable, "-c", _REFERENCE, root],
                          capture_output=True, text=True, timeout=600,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("LOSSES "))
    return {k: (v, os.path.join(root, k))
            for k, v in json.loads(line[len("LOSSES "):]).items()}


def _from_step2(ref_dir, tmp):
    """A fresh checkpoint dir holding only the reference's step 2."""
    os.makedirs(tmp, exist_ok=True)
    shutil.copytree(os.path.join(ref_dir, "step_00000002"),
                    os.path.join(tmp, "step_00000002"))
    return tmp


def _leaves(ckpt_dir, step):
    """A checkpoint's leaves as numpy (bf16 bits widened to float32)."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "index.json")) as f:
        index = json.load(f)
    out = []
    for i, rec in enumerate(index["leaves"]):
        a = np.load(os.path.join(path, f"arr_{i}.npy"))
        if rec["dtype"] == "bfloat16":
            a = (a.astype(np.uint32) << 16).view(np.float32)
        out.append(a)
    return index["treedef"], out


def _assert_step4_matches(port_dir, ref_dir):
    tdef, got = _leaves(port_dir, 4)
    rdef, want = _leaves(ref_dir, 4)
    _, start = _leaves(ref_dir, 2)
    assert tdef == rdef and len(got) == len(want)
    for i, (g, w, s) in enumerate(zip(got, want, start)):
        if g.dtype.kind in "iu":
            np.testing.assert_array_equal(g, w, err_msg=f"leaf {i}")
            continue
        moved = np.linalg.norm((w - s).ravel())
        assert np.linalg.norm((g - w).ravel()) <= 1e-3 * moved + 1e-7, i


@pytest.fixture(scope="module")
def port_r1(reference, tmp_path_factory):
    """The port at R = 1 resumed from the reference's step 2."""
    d = _from_step2(reference["contrastive_r1"][1],
                    str(tmp_path_factory.mktemp("port_r1")))
    losses = td.main(CONTRASTIVE + ["--device", "cpu", "--steps", "4",
                                    "--ckpt-dir", d, "--quiet"])
    return losses, d


def test_r1_resumes_the_references_checkpoint(reference, port_r1):
    ref_losses, ref_dir = reference["contrastive_r1"]
    losses, d = port_r1
    np.testing.assert_allclose(losses, ref_losses[2:], rtol=1e-4)
    _assert_step4_matches(d, ref_dir)


def test_r2_resumes_the_references_checkpoint_and_survives_preemption(
        reference, tmp_path):
    """Two gloo ranks from the reference's data-extent-2 step 2: its
    losses and step-4 state; then the same resume SIGTERM-preempted after
    one step (a final sync checkpoint every rank agrees on) and resumed
    again gives the same losses."""
    ref_losses, ref_dir = reference["contrastive_r2"]
    a = _from_step2(ref_dir, str(tmp_path / "a"))
    b = _from_step2(ref_dir, str(tmp_path / "b"))
    run = CONTRASTIVE + ["--device", "cpu", "--steps", "4", "--quiet"]
    ranks = run_world(worker_train, 2, str(tmp_path / "rdv"),
                      [run + ["--ckpt-dir", a],
                       run + ["--ckpt-dir", b, "--preempt-after", "1"],
                       run + ["--ckpt-dir", b]], timeout=300)
    for full, cut, rest in ranks:
        np.testing.assert_allclose(full, ref_losses[2:], rtol=1e-4)
        assert len(cut) == 1 and cut + rest == full
    _assert_step4_matches(a, ref_dir)
    events = [r.get("event") for r in runlog.read_runlog(
        os.path.join(b, "runlog.jsonl")) if r["kind"] == "checkpoint"]
    assert events == ["preempt_save", "final_save"]


def test_lm_resumes_the_references_checkpoint(reference, tmp_path):
    ref_losses, ref_dir = reference["lm"]
    d = _from_step2(ref_dir, str(tmp_path / "lm"))
    losses = td.main(LM + ["--device", "cpu", "--steps", "4", "--ckpt-dir",
                           d, "--quiet"])
    np.testing.assert_allclose(losses, ref_losses[2:], rtol=1e-4)
    _assert_step4_matches(d, ref_dir)


@pytest.mark.parametrize("argv", [CONTRASTIVE, LM], ids=["contrastive",
                                                         "lm"])
def test_stop_and_resume_is_exact(argv, tmp_path):
    """4 straight steps == 2, a checkpoint, 2 resumed (``--stop-after``
    keeps the LR horizon)."""
    run = argv + ["--device", "cpu", "--steps", "4", "--quiet"]
    full = td.main(run)
    d = str(tmp_path / "ck")
    first = td.main(run + ["--ckpt-dir", d, "--stop-after", "2"])
    rest = td.main(run + ["--ckpt-dir", d])
    np.testing.assert_allclose(first + rest, full, rtol=1e-4)


def test_runlog_passes_the_schema_gate_and_reports(port_r1):
    """The port's runlog (a resumed segment: run_start, resume marker,
    steps 2-3, checkpoint events, the metrics snapshot) passes the
    reference's ``validate_record``, ``scripts/check_runlog.py`` and
    summarises alike under both reports."""
    _, d = port_r1
    path = os.path.join(d, "runlog.jsonl")
    records = runlog.read_runlog(path)
    for rec in records:
        assert jrunlog.validate_record(rec) == [] == \
            runlog.validate_record(rec)
    kinds = [r["kind"] for r in records]
    assert kinds[:2] == ["run_start", "resume"] and kinds.count("step") == 2
    assert [r["step"] for r in records if r["kind"] == "step"] == [2, 3]
    assert records[-1]["kind"] == "metrics" and \
        records[-1]["counters"]["ckpt/saves"] == 1
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    check = subprocess.run([sys.executable, os.path.join(
        ROOT, "scripts", "check_runlog.py"), path], capture_output=True,
        text=True, timeout=120, env=env)
    assert check.returncode == 0 and "check_runlog: OK" in check.stdout, \
        check.stderr
    assert report.summarize(records) == jreport.summarize(records)
    out = subprocess.run([sys.executable, "-m", "repro_torch.obs.report",
                          path], capture_output=True, text=True,
                         timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == jreport.format_report(
        jreport.summarize(records))
    assert "resumed at step(s): 2" in out.stdout
    health = subprocess.run([sys.executable, "-m", "repro_torch.obs.report",
                             path, "--health"], capture_output=True,
                            text=True, timeout=120, env=env)
    assert health.returncode == 0, health.stderr
    assert health.stdout.strip() == (jreport.format_report(
        jreport.summarize(records)) + "\n" + jreport.format_health(
        jreport.summarize(records))).strip()


MEMSTATS_CASES = [["--memstats", "--health"],
                  ["--memstats", "--metrics-port", "0"],
                  ["--memstats"],
                  ["--memstats", "--arch", "mamba2-130m", "--model-parallel",
                   "2", "--sharding", "tp"]]
# the CPU trainer's second step differs in its last bits from run to run
# (~1.4e-7 relative seen: the order of threaded reductions), so the flag's
# losses are held to the run without it within 1e-5
MEMSTATS_RTOL = 1e-5


# the ids of the refusals these cases turned from (health, metrics-port,
# alone, Mamba-2 under tp)
@pytest.mark.parametrize("flags", MEMSTATS_CASES,
                         ids=[f"flags{i}-tooling" for i in range(4)])
def test_refuses_what_later_slices_bring(flags, tmp_path):
    """``--memstats`` prints one row of ``launch.memstats`` for the first
    step, under the reference's columns, with a positive FLOP count, and
    the run's losses are the run's without the flag: with the health
    tier's flags, alone, and for Mamba-2 under ``tp`` at M 2 (a world of
    2 gloo ranks; rank 0 prints)."""
    from repro.launch import memstats as jmemstats
    base = CONTRASTIVE + ["--device", "cpu", "--steps", "2", "--quiet"]
    rest = flags[1:]
    if "--model-parallel" in flags:
        ranks = run_world(worker_train_printed, 2, str(tmp_path / "rdv"),
                          [base + flags, base + rest])
        (losses, text), (plain, _) = ranks[0]
        assert ranks[1][0][1] == ""          # rank 1 prints no row
        assert ranks[1][0][0] == losses
    else:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            losses = td.main(base + flags)
            plain = td.main(base + rest)
        text = buf.getvalue()
    head = jmemstats.format_rows([]).splitlines()
    lines = text.splitlines()
    at = lines.index(head[0])
    assert lines[at + 1] == head[1]
    label = lines[at + 2]
    gflops = float(label.split()[-2])
    arch = flags[flags.index("--arch") + 1] if "--arch" in flags \
        else "basic-s"
    assert label.startswith(f"{arch} B=16 ") and gflops > 0
    assert len(losses) == 2
    np.testing.assert_allclose(losses, plain, rtol=MEMSTATS_RTOL)


def test_needs_a_card_unless_told_cpu():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        td.main(CONTRASTIVE + ["--steps", "1"])
