"""The port's trainer under ``--sharding tp`` (Megatron execution) against
the reference's ``tp`` run on the same (data, model) mesh.

The reference's ``repro.launch.train_distributed.train`` runs 4 steps
(checkpoints at 2 and 4) in a subprocess with four CPU devices, under
``sharding="tp"``: BASIC-S smoke (f32, the chunked loss) at (data 1,
model 2) and (2, 2), Llama-3.2-1B smoke (``train_lm``) at (1, 2) and
Mixtral-8x22B smoke at (1, 2), whose 4 experts the rule splits 2 a rank
(expert parallelism). As in ``tests/test_torch_train_weight_sharding.py``,
jax 0.9's Explicit-axis mesh is swapped for the Auto-axis one the
reference was written for. The port resumes from each run's step-2
checkpoint on spawned gloo ranks at the same grid (``tests/torch_spawn.py``),
each rank computing with its parts, and must give the reference's losses
for steps 2 and 3 within rtol 1e-4 and its step-4 parameters and
AdaFactorW slots, written back as whole leaves, within 1e-3 of the change
steps 2-3 made. The refusals that remain under ``tp``: heads (attention
or SSD) that do not divide by the model extent; the SSM and hybrid
families under ``tp`` are held to the reference in
``tests/test_torch_train_tensor_parallel_ssm.py``.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro_torch.configs import get_arch, smoke_variant
from repro_torch.core import tensor_parallel as tpl
from repro_torch.launch import train_distributed as td
from repro_torch.launch.spawn import run_world

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_train_distributed import (CONTRASTIVE, LM,  # noqa: E402
                                          _assert_step4_matches,
                                          _from_step2)
from torch_spawn import worker_train  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOE = ["--arch", "mixtral-8x22b"] + LM[2:]

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
            remat="basic", model_parallel=2, log_every=100, ckpt_every=2,
            stop_after=None, quiet=True, run_dir=None)
contrastive = dict(arch="basic-s", batch=16, seq=16, lr=3e-4, num_micro=2,
                   loss="chunked", precision="f32")
lm = dict(arch="llama3.2-1b", batch=4, seq=32, lr=3e-3)
moe = dict(lm, arch="mixtral-8x22b")
out = {}
for name, n, kw in (("contrastive_1x2", 1, contrastive),
                    ("contrastive_2x2", 2, contrastive),
                    ("lm_1x2", 1, lm), ("moe_1x2", 1, moe)):
    rtd.make_local_mesh = mesh_of(n)
    out[name] = rtd.train(types.SimpleNamespace(
        **base, **kw, ckpt_dir=f"{sys.argv[1]}/{name}"))
print("LOSSES " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """{run: (losses, checkpoint dir)} of the reference's four runs."""
    root = str(tmp_path_factory.mktemp("reference"))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS=os.environ.get("XLA_FLAGS", "")
               + " --xla_force_host_platform_device_count=4")
    proc = subprocess.run([sys.executable, "-c", _REFERENCE, root],
                          capture_output=True, text=True, timeout=600,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("LOSSES "))
    return {k: (v, os.path.join(root, k))
            for k, v in json.loads(line[len("LOSSES "):]).items()}


def _resumed(ref_dir, d, argv):
    return argv + ["--device", "cpu", "--steps", "4", "--quiet",
                   "--model-parallel", "2", "--sharding", "tp",
                   "--ckpt-dir", _from_step2(ref_dir, d)]


def test_1x2_resumes_the_references_checkpoints(reference, tmp_path):
    """Two model ranks of one data shard, each with the whole batch: the
    contrastive run, the dense LM and the MoE LM (2 of 4 experts a rank)
    from the reference's step 2, its losses and step-4 state."""
    runs = (("contrastive_1x2", CONTRASTIVE), ("lm_1x2", LM),
            ("moe_1x2", MOE))
    dirs = {name: str(tmp_path / name) for name, _ in runs}
    ranks = run_world(worker_train, 2, str(tmp_path / "rdv"),
                      [_resumed(reference[name][1], dirs[name], argv)
                       for name, argv in runs], timeout=300)
    for got in ranks:
        for (name, _), losses in zip(runs, got):
            np.testing.assert_allclose(losses, reference[name][0][2:],
                                       rtol=1e-4, err_msg=name)
    for name, _ in runs:
        _assert_step4_matches(dirs[name], reference[name][1])
    with open(os.path.join(dirs["moe_1x2"], "runlog.jsonl")) as f:
        meta = json.loads(f.readline())["meta"]
    assert (meta["ranks"], meta["data"], meta["model"], meta["sharding"]) \
        == (2, 1, 2, "tp")


def test_2x2_resumes_the_references_checkpoint(reference, tmp_path):
    """Four ranks, two data shards of two model ranks: each shard's model
    ranks share the loader's whole host block, and the chunked loss runs
    over the two data shards."""
    losses, ref_dir = reference["contrastive_2x2"]
    d = str(tmp_path / "c")
    ranks = run_world(worker_train, 4, str(tmp_path / "rdv"),
                      [_resumed(ref_dir, d, CONTRASTIVE)], timeout=300)
    for (got,) in ranks:
        np.testing.assert_allclose(got, losses[2:], rtol=1e-4)
    _assert_step4_matches(d, ref_dir)


@pytest.mark.parametrize("arch,model,error,match", [
    ("mamba2-130m", 3, ValueError, "its 16 SSD heads to divide by 3"),
    ("jamba-1.5-large-398b", 3, ValueError,
     "its 16 SSD heads to divide by 3"),
    ("llama3.2-1b", 4, ValueError, "2 kv heads do not both divide by 4")])
def test_refuses_what_tp_cannot_split(arch, model, error, match):
    """The smoke Mamba-2's and the smoke Jamba's 16 SSD heads do not
    divide over 3 model ranks, the smoke Llama's 2 kv heads not over 4.
    The trainer refuses each before it builds a mesh."""
    with pytest.raises(error, match=match):
        tpl.check(smoke_variant(get_arch(arch)), model)
    with pytest.raises(error, match=match):
        td.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps",
                 "1", "--model-parallel", str(model), "--sharding", "tp"])
