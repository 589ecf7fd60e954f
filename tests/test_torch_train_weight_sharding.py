"""The port's trainer with a model axis (paper §5.1 weight sharding)
against the reference's on the same (data, model) mesh.

The reference's ``repro.launch.train_distributed.train`` runs 4 steps
(checkpoints at 2 and 4) in a subprocess with four CPU devices, under
``--sharding basic_ws``: BASIC-S smoke (f32, the chunked loss) at (data 1,
model 2) and (2, 2), and Llama-3.2-1B smoke (``train_lm``) at (1, 2). As
in ``tests/test_torch_train_distributed.py``, jax 0.9's Explicit-axis
mesh is swapped for the Auto-axis one the reference was written for. The
port resumes from each run's step-2 checkpoint on spawned gloo ranks at
the same (data, model) grid (``tests/torch_spawn.py``), each rank keeping
1/M of every split leaf, and must give the reference's losses for steps 2
and 3 within rtol 1e-4 and its step-4 parameters and AdaFactorW slots,
written back as whole leaves, within 1e-3 of the change steps 2-3 made.
Under ``--sharding replicated`` at (1, 2) (every rank the whole model, the
batch split over both) the port resumes the reference's step-2 checkpoint
the same way. The refusals that remain: ``--sharding tp`` for heads that
do not divide by the model axis (Megatron execution itself is held to the
reference in ``tests/test_torch_train_tensor_parallel.py`` and
``tests/test_torch_train_tensor_parallel_ssm.py``), a world that does not
divide by the model axis, and a batch that does not divide over every
rank.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import sharding as shd
from repro_torch.launch import train_distributed as td
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.spawn import run_world

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_train_distributed import (CONTRASTIVE, LM,  # noqa: E402
                                          _assert_step4_matches,
                                          _from_step2)
from torch_spawn import worker_refusals, worker_train  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

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
            sharding="basic_ws", remat="basic", model_parallel=2,
            log_every=100, ckpt_every=2, stop_after=None, quiet=True,
            run_dir=None)
contrastive = dict(arch="basic-s", batch=16, seq=16, lr=3e-4, num_micro=2,
                   loss="chunked", precision="f32")
lm = dict(arch="llama3.2-1b", batch=4, seq=32, lr=3e-3)
replicated = dict(sharding="replicated")
out = {}
for name, n, kw in (("contrastive_1x2", 1, contrastive),
                    ("contrastive_2x2", 2, contrastive),
                    ("lm_1x2", 1, lm),
                    ("replicated_contrastive_1x2", 1,
                     dict(contrastive, **replicated)),
                    ("replicated_lm_1x2", 1, dict(lm, **replicated))):
    rtd.make_local_mesh = mesh_of(n)
    out[name] = rtd.train(types.SimpleNamespace(
        **dict(base, **kw), ckpt_dir=f"{sys.argv[1]}/{name}"))
print("LOSSES " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """{run: (losses, checkpoint dir)} of the reference's five runs."""
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


def _resumed(ref_dir, d, argv, sharding="basic_ws"):
    return argv + ["--device", "cpu", "--steps", "4", "--quiet",
                   "--model-parallel", "2", "--sharding", sharding,
                   "--ckpt-dir", _from_step2(ref_dir, d)]


def test_1x2_resumes_the_references_checkpoints(reference, tmp_path):
    """Two model ranks of one data shard: the contrastive run and the LM
    run from the reference's step 2, its losses and step-4 state."""
    c_losses, c_dir = reference["contrastive_1x2"]
    l_losses, l_dir = reference["lm_1x2"]
    c, lm = str(tmp_path / "c"), str(tmp_path / "lm")
    ranks = run_world(worker_train, 2, str(tmp_path / "rdv"),
                      [_resumed(c_dir, c, CONTRASTIVE),
                       _resumed(l_dir, lm, LM)], timeout=300)
    for got_c, got_lm in ranks:
        np.testing.assert_allclose(got_c, c_losses[2:], rtol=1e-4)
        np.testing.assert_allclose(got_lm, l_losses[2:], rtol=1e-4)
    _assert_step4_matches(c, c_dir)
    _assert_step4_matches(lm, l_dir)
    with open(os.path.join(c, "runlog.jsonl")) as f:
        meta = json.loads(f.readline())["meta"]
    assert (meta["ranks"], meta["data"], meta["model"]) == (2, 1, 2)


def test_replicated_1x2_resumes_the_references_checkpoints(reference,
                                                           tmp_path):
    """``replicated`` at (1, 2): each rank the whole model and its half of
    the batch; the contrastive run and the LM run from the reference's
    step 2 (so the AdaFactorW slots carried into steps 2-3 are the
    reference's), its losses and step-4 state."""
    runs = (("replicated_contrastive_1x2", CONTRASTIVE),
            ("replicated_lm_1x2", LM))
    dirs = {name: str(tmp_path / name) for name, _ in runs}
    ranks = run_world(worker_train, 2, str(tmp_path / "rdv"),
                      [_resumed(reference[name][1], dirs[name], argv,
                                "replicated") for name, argv in runs],
                      timeout=300)
    for got in ranks:
        for (name, _), losses in zip(runs, got):
            np.testing.assert_allclose(losses, reference[name][0][2:],
                                       rtol=1e-4, err_msg=name)
    for name, _ in runs:
        _assert_step4_matches(dirs[name], reference[name][1])
    with open(os.path.join(dirs["replicated_lm_1x2"], "runlog.jsonl")) as f:
        meta = json.loads(f.readline())["meta"]
    assert (meta["ranks"], meta["data"], meta["model"], meta["sharding"]) \
        == (2, 1, 2, "replicated")


def test_2x2_resumes_the_references_checkpoint(reference, tmp_path):
    """Four ranks, two data shards of two model ranks: the loader's two
    host blocks, each split over its shard's model ranks."""
    losses, ref_dir = reference["contrastive_2x2"]
    d = str(tmp_path / "c")
    ranks = run_world(worker_train, 4, str(tmp_path / "rdv"),
                      [_resumed(ref_dir, d, CONTRASTIVE)], timeout=300)
    for (got,) in ranks:
        np.testing.assert_allclose(got, losses[2:], rtol=1e-4)
    _assert_step4_matches(d, ref_dir)


def test_refuses_tp_and_indivisible_worlds_and_batches(tmp_path):
    """``tp`` at a model axis of 3 for the smoke Mamba-2 and Jamba (16 SSD
    heads) and at 4 for the smoke Llama (2 kv heads), a world of 1 at a
    model axis of 2, and on two ranks (1 x 2) a batch of 15 and a
    per-rank block that does not divide into the microbatches: each raises
    naming the reason."""
    run = CONTRASTIVE + ["--device", "cpu", "--steps", "1"]
    for arch in ("mamba2-130m", "jamba-1.5-large-398b"):
        with pytest.raises(ValueError, match="16 SSD heads to divide by 3"):
            td.main(run + ["--arch", arch, "--model-parallel", "3",
                           "--sharding", "tp"])
    with pytest.raises(ValueError, match="kv heads do not both divide"):
        td.main(LM + ["--device", "cpu", "--steps", "1", "--model-parallel",
                      "4", "--sharding", "tp"])
    with pytest.raises(ValueError, match="does not divide"):
        td.main(run + ["--model-parallel", "2"])
    lm = LM + ["--device", "cpu", "--steps", "1", "--model-parallel", "2"]
    out = run_world(worker_refusals, 2, str(tmp_path / "rdv"),
                    [run + ["--model-parallel", "2", "--batch", "15"],
                     run + ["--model-parallel", "2", "--batch", "4",
                            "--num-micro", "4"],
                     lm + ["--batch", "3"]], timeout=120)
    for got in out:
        assert [k for k, _ in got] == ["SystemExit"] * 3
        assert "2 ranks (data 1 x model 2" in got[0][1]
        assert "--num-micro 4" in got[1][1]
        assert "2 ranks (data 1 x model 2" in got[2][1]


def test_lm_batch_placement_is_strict_over_every_rank():
    """The LM batch splits over (data, model) in rank order; a leaf that
    does not divide over every rank raises instead of being replicated
    over the model axis (the reference's ``batch_specs`` drops the axis)."""
    batch = {"tokens": torch.arange(16).reshape(8, 2)}
    for r in range(4):
        mesh = Mesh({"data": 2, "model": 2}, data_index=r // 2,
                    model_index=r % 2)
        specs = shd.batch_specs(batch, mesh, batch_axes=("data", "model"),
                                strict=True)
        assert specs["tokens"] == shd.P(("data", "model"), None)
        got = shd.shard(batch, specs, mesh)["tokens"]
        assert torch.equal(got, batch["tokens"][2 * r:2 * r + 2])
    odd = {"tokens": torch.zeros(6, 2)}
    assert shd.batch_specs(odd, mesh, batch_axes=("data", "model")) == \
        {"tokens": shd.P("data", None)}
    with pytest.raises(ValueError, match="does not divide"):
        shd.batch_specs(odd, mesh, batch_axes=("data", "model"), strict=True)


def test_moe_capacity_groups_must_fall_on_a_ranks_rows():
    """Capacity groups of min(4096, b·s) tokens: a split where a rank's
    rows would hold a different grouping than the whole batch raises."""
    from repro_torch.configs import get_arch
    cfg = get_arch("mixtral-8x22b")
    td._check_moe_groups(cfg, None, 8, 1024, 2)       # 4096-token groups
    td._check_moe_groups(cfg, {"dispatch": "dense"}, 2, 1024, 2)
    td._check_moe_groups(cfg, None, 2, 1024, 1)       # one rank: any batch
    for batch, seq, ranks in ((2, 1024, 2), (6, 1024, 2), (4, 4096, 8)):
        with pytest.raises(ValueError, match="capacity groups"):
            td._check_moe_groups(cfg, None, batch, seq, ranks)
