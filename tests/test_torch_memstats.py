"""The port's per-step accounting (``repro_torch.launch.memstats``) and the
kernel wrappers' ``meta`` branches, on the CPU.

- ``contrastive_report``'s ``argument_bytes_per_device`` for smoke BASIC-S
  against the reference's ``memstats.contrastive_report`` compiled over
  simulated JAX CPU devices (a subprocess with
  ``--xla_force_host_platform_device_count``), under ``basic_ws``: equal
  at (1, 1); at (1, 2) the params and the batch are equal leaf for leaf,
  and the whole difference is AdaFactorW's factored second moments,
  which the port cuts along its params' parts (``AdaFactorW.split_dims``)
  where the reference's rule cuts the slot trees by their own shapes.
- Each kernel wrapper's ``meta`` branch: the plain version's output
  shapes and dtypes, no launch counted, the kernel's work recorded by
  ``launch.roofline``'s formulas.
- ``step_stats``: the traced peak of live bytes, the products' FLOPs and
  the operations' bytes on a function whose numbers are known; a step
  traced on ``meta`` and run on the CPU count the same FLOPs and peak.
- The CLI's rows under the reference's columns; ``loss_kernel_smem``.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.launch import memstats as jmemstats
from repro_torch.configs import get_arch, smoke_dual_variant, smoke_variant
from repro_torch.configs.base import InputShape
from repro_torch.kernels import build as kbuild
from repro_torch.kernels.contrastive_loss import ops as cl_ops
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.similarity_topk import ops as topk_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch import memstats
from repro_torch.launch import roofline as rf
from repro_torch.launch import steps as st
from repro_torch.launch.mesh import fake_world
from repro_torch.tree import leaves

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_REFERENCE = r"""
import json, os, sys
n, m = int(sys.argv[1]), int(sys.argv[2])
os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n}"
import jax
import numpy as np
from jax.sharding import AxisType, PartitionSpec
from repro.configs import get_arch, smoke_dual_variant
from repro.core import sharding as shd
from repro.launch import memstats
from repro.launch import steps as st
from repro.models import dual_encoder as de
mesh = jax.make_mesh((n // m, m), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
rows = memstats.contrastive_report(
    "basic-s", smoke=True, mesh=mesh, sharding="basic_ws", batch=16,
    num_micro=2, seq=16, remats=["basic"], loss="chunked")
cfg = smoke_dual_variant(get_arch("basic-s"))
params = jax.eval_shape(lambda k: de.init_params(cfg, k), jax.random.key(0))
_, opt = st.make_contrastive_step(cfg, num_micro=2)
state = jax.eval_shape(opt.init, params)
parts = {}
for name, tree in (("params", params), ("state", state)):
    specs = shd.params_specs(tree, mesh, "basic_ws")
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    sflat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda z: isinstance(z, PartitionSpec))[0]
    for (path, x), (_, spec) in zip(flat, sflat):
        split = 1
        for axes in spec:
            for a in (axes if isinstance(axes, tuple) else (axes,)):
                if a is not None:
                    split *= mesh.shape[a]
        key = "/".join(str(getattr(k, "key", getattr(k, "idx",
                       getattr(k, "name", k)))) for k in path)
        parts[name + "/" + key] = int(np.prod(x.shape)) * x.dtype.itemsize \
            // split
print(json.dumps({"args": rows[0]["memory"]["argument_bytes_per_device"],
                  "parts": parts}))
"""


def _reference_report(n, m):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _REFERENCE, str(n), str(m)],
                         capture_output=True, text=True, timeout=600,
                         env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _port_parts(mesh):
    """{'params/<path>' | 'state/<field>/<path>': bytes} of this rank's
    parts of smoke BASIC-S's params and AdaFactorW state under basic_ws."""
    cfg = smoke_dual_variant(get_arch("basic-s"))
    params = st.abstract_params(cfg)
    state = st.make_optimizer().init(params)
    _, (p, s, _) = st.shardings_for(
        cfg, InputShape("r", 16, 16, "contrastive"), mesh, "basic_ws",
        params, state)
    out = {f"params/{k}": x.numel() * x.element_size()
           for k, x in leaves(p)}
    for field, slot in zip(s._fields, s):
        for k, x in leaves(slot):
            out[f"state/{field}/{k}".rstrip("/")] = \
                x.numel() * x.element_size()
    return out


@pytest.mark.parametrize("grid", [(1, 1), (1, 2)], ids=["1x1", "1x2"])
def test_argument_bytes_against_the_references_report(grid):
    want = _reference_report(grid[0] * grid[1], grid[1])
    with fake_world(grid) as mesh:
        rows = memstats.contrastive_report(
            "basic-s", smoke=True, mesh=mesh, sharding="basic_ws", batch=16,
            num_micro=2, seq=16, remats=["basic"], loss="chunked",
            device="meta")
        mine = _port_parts(mesh)
    got = rows[0]["memory"]["argument_bytes_per_device"]
    ref_parts = want["parts"]
    assert sorted(mine) == sorted(ref_parts)
    # the batch: what the arguments hold beside the params and the state
    assert got - sum(mine.values()) == want["args"] - sum(ref_parts.values())
    differ = {k for k in mine if mine[k] != ref_parts[k]}
    if grid == (1, 1):
        assert got == want["args"] and not differ
        return
    assert all(k.startswith(("state/v_row/", "state/v_col/"))
               for k in differ), differ
    assert got - want["args"] == sum(mine[k] - ref_parts[k] for k in differ)
    assert 0 < abs(got - want["args"]) < 0.01 * want["args"]


def _cpu_and_meta(make):
    """(the plain version's outputs on the CPU, the meta branch's, the
    launches counted by every wrapper, the work recorded) of ``make(device)
    -> (fn, args)``."""
    fn, args = make("cpu")
    cpu = fn(*args)
    counters = (fa_ops.COUNTER, fa_ops.BWD_COUNTER, cl_ops.FWD_COUNTER,
                cl_ops.BWD_COUNTER, dec_ops.COUNTER, topk_ops.COUNTER,
                ssd_ops.COUNTER, ssd_ops.BWD_COUNTER)
    for c in counters:
        c.reset()
    fn, args = make("meta")
    with kbuild.WorkCount() as work:
        meta = fn(*args)
    return cpu, meta, sum(c.count for c in counters), work


def _flash(dtype, bwd):
    def make(device):
        g = torch.Generator().manual_seed(0)
        q = torch.randn(6, 40, 64, generator=g).to(device, dtype)
        k = torch.randn(2, 40, 64, generator=g).to(device, dtype)
        if not bwd:
            return (lambda q, k: fa_ops.flash_fwd(q, k, k, causal=True,
                                                  window=17)), (q, k)
        o, lse = fa_ops.flash_fwd(q, k, k, causal=True)
        return (lambda *a: fa_ops.flash_bwd(*a, causal=True)), (
            q, k, k, None, o, lse, q)
    return make


def _contrastive(dtype, bwd):
    def make(device):
        x = torch.randn(24, 32, generator=torch.Generator().manual_seed(1)
                        ).to(device, dtype)
        if not bwd:
            return (lambda x: cl_ops.fwd_fused(x, x, 2.0)), (x,)
        r, c = cl_ops.fwd_fused(x, x, 2.0)
        return (lambda *a: cl_ops.bwd_fused(*a, b_norm=48)), (x, x, 2.0, r, c)
    return make


def _decode(dtype, _):
    def make(device):
        g = torch.Generator().manual_seed(2)
        q = torch.randn(3, 8, 64, generator=g).to(device, dtype)
        k = torch.randn(3, 2, 50, 64, generator=g).to(device, dtype)
        valid = (torch.arange(50)[None] < torch.tensor([[0], [7], [50]])
                 ).to(device)
        return dec_ops.decode_attention, (q, k, k, valid)
    return make


def _topk(dtype, _):
    def make(device):
        g = torch.Generator().manual_seed(3)
        x = torch.randn(5, 32, generator=g).to(device, dtype)
        c = torch.randn(70, 32, generator=g).to(device, dtype)
        return (lambda x, c: topk_ops.similarity_topk(x, c, 4, n_valid=60)
                ), (x, c)
    return make


def _ssd(dtype, bwd):
    def make(device):
        g = torch.Generator().manual_seed(4)
        x = (torch.randn(2, 64, 3, 16, generator=g) * 0.5).to(device, dtype)
        dt = torch.rand(2, 64, 3, generator=g).to(device)
        A = -torch.rand(3, generator=g).to(device)
        B = torch.randn(2, 64, 8, generator=g).to(device, dtype)
        if not bwd:
            return (lambda *a: ssd_ops.ssd_scan(*a, chunk=32)), (x, dt, A, B,
                                                                B)

        def grads(x, dt, A, B):
            x, dt, B = (t.detach().requires_grad_() for t in (x, dt, B))
            y, _ = ssd_ops.ssd_scan(x, dt, A, B, B, chunk=32)
            return torch.autograd.grad(y.sum(), (x, dt, B))
        return grads, (x, dt, A, B)
    return make


KERNELS = {"flash_fwd": (_flash, False), "flash_bwd": (_flash, True),
           "contrastive_fwd": (_contrastive, False),
           "contrastive_bwd": (_contrastive, True),
           "decode_attention": (_decode, False),
           "similarity_topk": (_topk, False), "ssd_scan": (_ssd, False),
           "ssd_scan_bwd": (_ssd, True)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(KERNELS))
def test_meta_branch_gives_the_plain_versions_shapes(name, dtype):
    case, bwd = KERNELS[name]
    cpu, meta, launches, work = _cpu_and_meta(case(dtype, bwd))
    flat_cpu = [t for t in (cpu if isinstance(cpu, tuple) else (cpu,))
                if t is not None]
    flat_meta = [t for t in (meta if isinstance(meta, tuple) else (meta,))
                 if t is not None]
    assert [(tuple(t.shape), t.dtype) for t in flat_meta] == \
        [(tuple(t.shape), t.dtype) for t in flat_cpu]
    assert all(t.is_meta for t in flat_meta)
    assert launches == 0                    # a meta call launches nothing
    # the scan's backward case runs its forward inside too
    want = {"ssd_scan": 1, name: 1} if name == "ssd_scan_bwd" else {name: 1}
    assert work.calls == want and work.flops[name] > 0


def test_recorded_work_is_the_rooflines():
    q = torch.empty(6, 40, 64, device="meta", dtype=torch.bfloat16)
    k = torch.empty(2, 40, 64, device="meta", dtype=torch.bfloat16)
    bias = torch.empty(2, 40, device="meta")
    with kbuild.WorkCount() as work:
        fa_ops.flash_fwd(q, k, k, bias, causal=False)
        x = torch.empty(24, 32, device="meta")
        cl_ops.fwd_fused(x, x, 1.0)
    assert (work.bytes["flash_fwd"], work.flops["flash_fwd"]) == \
        rf.flash_fwd_work(6, 2, 40, 40, 64, 2, causal=False, bias_rows=2)
    assert (work.bytes["contrastive_fwd"], work.flops["contrastive_fwd"]) \
        == rf.contrastive_fwd_work(24, 24, 32, 4)


def test_step_stats_counts_a_known_function():
    def fn(x, w):
        a = x * 2.0                     # 1 MiB more
        b = a + 1.0                     # and another, a still alive
        del a
        return b @ w                    # (256, 1024) @ (1024, 64)

    x = torch.ones(256, 1024)
    w = torch.ones(1024, 64)
    for device in ("cpu", "meta"):
        row = memstats.step_stats(fn, (x.to(device), w.to(device)),
                                  label="known")
        mem = row["memory"]
        assert mem["argument_bytes_per_device"] == (256 + 64) * 1024 * 4
        assert mem["peak_bytes_per_device"] == (3 * 256 + 64) * 1024 * 4
        assert mem["temp_bytes_per_device"] == 2 * 256 * 1024 * 4
        assert mem["output_bytes_per_device"] == 256 * 64 * 4
        assert row["flops_per_device"] == 2 * 256 * 1024 * 64
        assert row["bytes_accessed_per_device"] == \
            2 * (2 * 256 * 1024 * 4) + (256 + 64) * 1024 * 4 + 256 * 64 * 4
        assert row["collectives"]["total"] == 0


def test_meta_trace_and_cpu_run_count_alike():
    """An LM step (Llama smoke, naive attention, remat 'basic') traced on
    meta tensors and run on the CPU: the same FLOPs, bytes accessed and
    peak of live bytes."""
    cfg = smoke_variant(get_arch("llama3.2-1b"))
    fn, opt = st.make_train_step(cfg, remat="basic")
    shape = InputShape("t", 32, 2, "train")
    abstract = (st.abstract_params(cfg),)
    abstract += (opt.init(abstract[0]), st.input_specs(cfg, shape))
    from repro_torch import interop
    params = interop.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    real = (params, opt.init(params),
            {"tokens": torch.randint(0, cfg.vocab, (2, 32),
                                     dtype=torch.int32)})
    meta = memstats.step_stats(fn, abstract)
    cpu = memstats.step_stats(fn, real)
    assert meta["flops_per_device"] == cpu["flops_per_device"] > 0
    assert meta["bytes_accessed_per_device"] == \
        cpu["bytes_accessed_per_device"]
    assert meta["memory"] == dict(cpu["memory"])


def test_loss_kernel_smem_is_the_plans():
    ks = memstats.loss_kernel_smem(2048, 512)
    assert (ks["tile"], ks["tiles"]) == (128, 16)
    assert ks["lse_smem_bytes"] == 2 * (2 * 128 * 36) * 4 + 4 * 2 * 8 * 128
    assert ks["lse_smem_bytes"] <= fa_ops.SMEM_LIMIT
    assert ks["bwd_smem_bytes"] <= fa_ops.SMEM_LIMIT and ks["bwd_one_launch"]
    assert ks["bwd_scratch_bytes"] == 4 * cl_ops.bwd_plan(2048, 512
                                                          ).scratch_floats
    assert cl_ops.bwd_smem_bytes(cl_ops.MAX_D, 4) <= fa_ops.SMEM_LIMIT
    assert not memstats.loss_kernel_smem(256, cl_ops.MAX_D + 4)[
        "bwd_one_launch"]
    bf16 = memstats.loss_kernel_smem(2048, 512, itemsize=2)
    assert bf16["tile"] == 64            # bf16 tiles stop at 64


def test_cli_rows_have_the_references_columns(tmp_path, capsys):
    path = str(tmp_path / "rows.json")
    assert memstats.main(["--arch", "basic-s", "--smoke", "--devices", "4",
                          "--model-parallel", "2", "--batch", "16",
                          "--num-micro", "2", "--remat", "basic,none",
                          "--json", path]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[:2] == jmemstats.format_rows([]).splitlines()
    rows = json.load(open(path))
    assert [r["remat"] for r in rows] == ["basic", "none"]
    for r in rows:
        assert set(r["memory"]) >= {"argument_bytes_per_device",
                                    "output_bytes_per_device",
                                    "temp_bytes_per_device",
                                    "alias_bytes_per_device",
                                    "peak_gb_per_device"}
        assert r["flops_per_device"] > 0 and r["device"] == "meta"
        # (2, 2) under basic_ws: the weights' gathers and the gradients'
        # reduce-scatters over the model axis, the sums over the ranks
        assert r["collectives"]["all-gather"] > 0
        assert r["collectives"]["reduce-scatter"] > 0
    assert memstats.compiled_stats(rows[0], label="x")["label"] == "x"
    assert any(line.strip().startswith("loss kernel smem") for line in out)
    np.testing.assert_array_less(0, [r["memory"]["temp_bytes_per_device"]
                                     for r in rows])
