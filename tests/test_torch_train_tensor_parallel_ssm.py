"""The port's trainer under ``--sharding tp`` for the SSM and hybrid
families (the Mamba-2 mixer split by heads) against the reference's
``tp`` run on the same (data, model) mesh.

The reference's ``repro.launch.train_distributed.train`` runs 4 steps
(checkpoints at 2 and 4) in a subprocess with four CPU devices, under
``sharding="tp"``: Mamba-2-130M smoke (``train_lm``, b 4 x s 64, two
32-token chunks) at (data 1, model 2) and (1, 4), and Jamba-1.5-Large
smoke (a mixer, an attention layer and expert-parallel MoE) at (1, 2). As
in ``tests/test_torch_train_tensor_parallel.py``, jax 0.9's Explicit-axis
mesh is swapped for the Auto-axis one the reference was written for. The
port resumes from each run's step-2 checkpoint on spawned gloo ranks at
the same grid (``tests/torch_spawn.py``), each rank computing its H/M
heads of every mixer, and must give the reference's losses for steps 2
and 3 within rtol 1e-4 and its step-4 parameters and AdaFactorW slots,
written back as whole leaves, within 1e-3 of the change steps 2-3 made.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.launch.spawn import run_world

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_train_distributed import (_assert_step4_matches,  # noqa: E402
                                          _from_step2)
from torch_spawn import worker_train  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SSM_LM = ["--smoke", "--batch", "4", "--seq", "64", "--lr", "3e-3"]
RUNS = {"mamba_1x2": ("mamba2-130m", 2), "mamba_1x4": ("mamba2-130m", 4),
        "jamba_1x2": ("jamba-1.5-large-398b", 2)}

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

base = dict(objective="auto", smoke=True, steps=4, seed=0, sharding="tp",
            remat="basic", log_every=100, ckpt_every=2, stop_after=None,
            quiet=True, run_dir=None, batch=4, seq=64, lr=3e-3)
out = {}
for name, (arch, model) in json.loads(sys.argv[2]).items():
    rtd.make_local_mesh = mesh_of(1)
    out[name] = rtd.train(types.SimpleNamespace(
        **base, arch=arch, model_parallel=model,
        ckpt_dir=f"{sys.argv[1]}/{name}"))
print("LOSSES " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """{run: (losses, checkpoint dir)} of the reference's three runs."""
    root = str(tmp_path_factory.mktemp("reference"))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS=os.environ.get("XLA_FLAGS", "")
               + " --xla_force_host_platform_device_count=4")
    proc = subprocess.run([sys.executable, "-c", _REFERENCE, root,
                           json.dumps(RUNS)],
                          capture_output=True, text=True, timeout=600,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("LOSSES "))
    return {k: (v, os.path.join(root, k))
            for k, v in json.loads(line[len("LOSSES "):]).items()}


def _resumed(reference, name, tmp_path):
    arch, model = RUNS[name]
    d = _from_step2(reference[name][1], str(tmp_path / name))
    return d, ["--arch", arch] + SSM_LM + [
        "--device", "cpu", "--steps", "4", "--quiet", "--model-parallel",
        str(model), "--sharding", "tp", "--ckpt-dir", d]


@pytest.mark.parametrize("model", [2, 4])
def test_resumes_the_references_checkpoints(reference, tmp_path, model):
    """M model ranks of one data shard, each with the whole batch: the
    smoke Mamba-2 (and at M 2 the smoke Jamba) from the reference's step
    2, its losses and step-4 state."""
    names = [n for n, (_, m) in RUNS.items() if m == model]
    runs = [_resumed(reference, n, tmp_path) for n in names]
    ranks = run_world(worker_train, model, str(tmp_path / "rdv"),
                      [argv for _, argv in runs], timeout=300)
    for got in ranks:
        for name, losses in zip(names, got):
            np.testing.assert_allclose(losses, reference[name][0][2:],
                                       rtol=1e-4, err_msg=name)
    for name, (d, _) in zip(names, runs):
        _assert_step4_matches(d, reference[name][1])
    with open(os.path.join(runs[0][0], "runlog.jsonl")) as f:
        meta = json.loads(f.readline())["meta"]
    assert (meta["ranks"], meta["data"], meta["model"], meta["sharding"]) \
        == (model, 1, model, "tp")
