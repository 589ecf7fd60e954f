"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU: rank 0's
step of an (arch × input shape × mesh) traced on ``meta`` tensors over a
``fake`` process group.

- Llama-3.2-1B's ``train_4k`` on the pod mesh (16, 16) finishes with
  ``ok: true`` within ``POD_SECONDS``, under the reference's keys.
- A rank's params and optimizer-state bytes in a dry run equal the parts
  the trainer places on a rank of a gloo world (``tests/torch_spawn.py``)
  at (1, 2) and (2, 2) under ``basic_ws`` and at (1, 2) under ``tp`` and
  ``replicated`` (smoke BASIC-S); so do a serving step's params (smoke
  Llama-3.2-1B's prefill and decode under ``tp`` and ``basic_ws`` at (1,
  2)), whose peak is below the whole-weight trace's and whose decode
  caches are the rank's kv heads' under ``tp`` and its half of the
  sequence under ``basic_ws`` (the reference's ``cache_specs`` split a
  ring of 64 slots, the head dim's length, on its sequence).
- Llama-3.2-1B's ``long_500k`` decode (b 1) on a (4, 2) mesh under
  ``tp`` and ``basic_ws`` holds the rank's slice of the KV caches, 1/8 of
  them as the reference's ``cache_specs`` place them; under ``tp`` the
  step merges the slices' partial attentions with one all-gather a
  layer.
- Llama-3.2-1B's ``prefill_32k`` and ``decode_32k`` under ``tp`` and
  ``basic_ws`` on a (16, 8) mesh trace a rank's parts; a ``tp`` decode
  step's collectives are two all-reduces a block, the embedding's, and
  the logits' gather (the norm scales are held whole).
- With the flash kernels' backend the trace counts each flash call as the
  kernel's work (``launch.roofline``), not as the plain version's
  products.
- The CLI writes one JSON per combo under the reference's file names,
  skips a cached one, records ``--unroll``, and writes ``ok: false`` with
  the error for a combo that fails (its exit code 1).
"""
import dataclasses
import json
import os
import sys
import time

import pytest
import torch

from repro_torch.configs import get_arch, smoke_dual_variant, smoke_variant
from repro_torch.configs.base import InputShape
from repro_torch.core import sharding as shd
from repro_torch.interop import init_params
from repro_torch.launch import dryrun
from repro_torch.launch import memstats
from repro_torch.launch import roofline as rf
from repro_torch.launch.mesh import Mesh, fake_world
from repro_torch.launch.spawn import run_world
from repro_torch.tree import leaves

sys.path.insert(0, os.path.dirname(__file__))

from torch_spawn import worker_parts_bytes  # noqa: E402

# the trace takes ~5 s on one CPU core; the limit leaves room for a slower
# host under six test workers
POD_SECONDS = 120
# the reference's result keys (src/repro/launch/dryrun.py, run_one)
REFERENCE_KEYS = {
    "arch", "shape", "mesh", "chips", "sharding", "remat", "attn",
    "moe_group", "dispatch", "param_dtype", "batch_over", "ssm_chunk", "ok",
    "lower_s", "compile_s", "memory", "collectives", "roofline",
    "model_flops_global", "hlo_flops_global", "useful_flops_ratio"}


def test_llama_train_4k_on_the_pod_mesh():
    t0 = time.time()
    r = dryrun.run_one("llama3.2-1b", "train_4k", verbose=False)
    assert time.time() - t0 < POD_SECONDS
    assert r["ok"] and set(r) >= REFERENCE_KEYS
    assert (r["mesh"], r["chips"]) == ("16x16", 256)
    m = r["memory"]
    # basic_ws over 16 model ranks: ~1/16 of the 1.24G f32 params a rank
    n = get_arch("llama3.2-1b").param_counts()["total"]
    assert 4 * n / 16 <= m["params_bytes_per_device"] < 4 * n / 8
    assert m["peak_gb_per_device"] > m["argument_bytes_per_device"] / 2**30
    # the weights' gathers and the gradients' reduce-scatters a step
    c = r["collectives"]
    assert c["all-gather"] > 0 and c["reduce-scatter"] > 0
    assert r["hlo_flops_global"] == 256 * r["roofline"]["flops_per_device"]
    assert 0 < r["useful_flops_ratio"] < 1


# (grid, sharding, step kind): smoke BASIC-S's contrastive step, or smoke
# Llama-3.2-1B's serving step of that kind on the rank's parts
GRIDS = [((1, 2), "basic_ws", "contrastive"),
         ((2, 2), "basic_ws", "contrastive"), ((1, 2), "tp", "contrastive"),
         ((1, 2), "replicated", "contrastive"), ((1, 2), "tp", "decode"),
         ((1, 2), "basic_ws", "decode"), ((1, 2), "tp", "prefill"),
         ((1, 2), "basic_ws", "prefill")]


def _smoke_dry_run(grid, sharding, kind):
    """The dry run's memory of the smoke step of ``kind`` on ``grid``."""
    if kind == "contrastive":
        return dryrun.run_contrastive_dryrun(
            smoke_dual_variant(get_arch("basic-s")),
            InputShape("c", 16, 16, "contrastive"), mesh=grid,
            sharding=sharding, num_micro=2, verbose=False)["memory"]
    return dryrun.run_one(smoke_variant(get_arch("llama3.2-1b")),
                          InputShape(kind, 64, 4, kind), mesh=grid,
                          sharding=sharding, verbose=False)["memory"]


@pytest.fixture(scope="module")
def gloo_bytes(tmp_path_factory):
    """(grid, sharding, arch, serving) -> each rank's
    ``worker_parts_bytes`` on a spawned gloo world, one world per key."""
    done = {}

    def get(grid, sharding, arch, serving):
        key = (grid, sharding, arch, serving)
        if key not in done:
            done[key] = run_world(
                worker_parts_bytes, grid[0] * grid[1],
                str(tmp_path_factory.mktemp("rdv")), grid[1], arch, sharding,
                serving)
        return done[key]
    return get


@pytest.mark.parametrize(
    "grid,sharding,kind", GRIDS,
    ids=[f"{g[0]}x{g[1]}-{s}" + ("" if k == "contrastive" else f"-{k}")
         for g, s, k in GRIDS])
def test_parts_bytes_equal_a_gloo_worlds(grid, sharding, kind, gloo_bytes):
    r = _smoke_dry_run(grid, sharding, kind)
    ranks = gloo_bytes(grid, sharding, "basic-s" if kind == "contrastive"
                       else "llama3.2-1b", kind != "contrastive")
    assert all(rank == ranks[0] for rank in ranks)
    whole = _smoke_dry_run((1, 1), sharding, kind)
    if kind == "contrastive":
        assert [r["params_bytes_per_device"],
                r["opt_state_bytes_per_device"]] == ranks[0]
    else:                       # a serving step: its parts, no slots
        assert r["params_bytes_per_device"] == ranks[0][0]
        assert r["peak_bytes_per_device"] < whole["peak_bytes_per_device"]
    if sharding == "replicated":
        assert ranks[0][0] == whole["params_bytes_per_device"]
    else:
        assert ranks[0][0] < whole["params_bytes_per_device"]
    if kind == "decode":
        # tp: the rank's kv heads; basic_ws: its half of the sequence
        assert r["caches_bytes_per_device"] * 2 == \
            whole["caches_bytes_per_device"]


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
@pytest.mark.parametrize("sharding", ["tp", "basic_ws"])
def test_serving_combos_trace_a_ranks_parts(shape, sharding):
    """Llama-3.2-1B's serving combos at full size on a (16, 8) mesh: the
    rank's params are 1/8 of every split leaf plus the whole ones (under
    ``tp`` the norm scales held whole); under ``tp`` a decode step hands
    its collectives two all-reduces of the rows' (b, 1, d) bf16
    activations a block plus the embedding's, and all-gathers the logits'
    vocab slices once; under ``basic_ws`` it all-gathers weights and
    reduces nothing."""
    cfg = get_arch("llama3.2-1b")
    r = dryrun.run_one("llama3.2-1b", shape, mesh=(16, 8), sharding=sharding,
                       verbose=False)
    assert r["ok"] and set(r) >= REFERENCE_KEYS
    specs = dict(shd.spec_leaves(shd.params_specs(
        init_params(cfg, torch.Generator(), "meta"),
        Mesh({"data": 16, "model": 8}), sharding)))
    held = ("ln1", "ln2") if sharding == "tp" else ()
    want = sum(x.numel() * 4 // (8 if "model" in specs[p]
                                 and p.rsplit("/", 1)[-1] not in held else 1)
               for p, x in leaves(init_params(cfg, torch.Generator(),
                                              "meta")))
    assert r["memory"]["params_bytes_per_device"] == want
    c = r["collectives"]
    if sharding == "basic_ws":
        assert c["all-reduce"] == 0 and c["all-gather"] > 0
        return
    if shape == "decode_32k":
        rows, n, d = 128 // 16, cfg.n_layers, cfg.d_model
        assert c["all-reduce"] == (2 * n + 1) * rows * d * 2
        assert c["all-gather"] == rows * cfg.vocab // 8 * 4
        assert c["count"] == 2 * n + 2


@pytest.mark.parametrize("sharding", ["tp", "basic_ws"])
def test_long_500k_decode_holds_the_ranks_slice(sharding):
    cfg = get_arch("llama3.2-1b")
    r = dryrun.run_one("llama3.2-1b", "long_500k", mesh=(4, 2),
                       sharding=sharding, verbose=False)
    assert r["ok"], r.get("error")
    # the ring of the 8192-token window, b 1, bf16 k and v, over 8 ranks
    whole = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.sliding_window * \
        cfg.resolved_head_dim * 2
    assert r["memory"]["caches_bytes_per_device"] * 8 == whole
    if sharding == "tp":
        # a layer hands the all-gather its packed (b, 16 heads, d + 1) f32
        # partial, beside two all-reduces; then the logits' vocab slice
        n, c = cfg.n_layers, r["collectives"]
        assert c["all-gather"] == n * cfg.n_heads // 2 * (
            cfg.resolved_head_dim + 1) * 4 + cfg.vocab // 2 * 4
        assert c["count"] == 3 * n + 2


def test_a_flash_call_counts_as_the_kernels_work():
    cfg = smoke_variant(get_arch("llama3.2-1b"))
    shape = InputShape("t", 64, 2, "train")
    rows = {}
    for attn in ("naive", "pallas"):
        c = dataclasses.replace(cfg, attn_impl=attn)
        with fake_world((1, 1)) as mesh:
            fn, inputs = dryrun.lm_step(c, shape, mesh)
            rows[attn] = memstats.step_stats(fn, inputs)
    work = rows["pallas"]["kernel_work"]
    # remat 'basic': the forward, its recompute, then the backward
    h, kv, d = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    assert work["calls"] == {"flash_fwd": 2 * cfg.n_layers,
                             "flash_bwd": cfg.n_layers}
    fwd = rf.flash_fwd_work(2 * h, 2 * kv, 64, 64, d, 2, causal=True,
                            window=cfg.sliding_window)
    assert work["flops"]["flash_fwd"] == 2 * cfg.n_layers * fwd[1]
    # the naive trace counts q·kᵀ and p·v as products where the kernel's
    # work stands in the pallas trace: the rest of the step is the same
    naive = rows["naive"]["flops_per_device"]
    pallas = rows["pallas"]["flops_per_device"]
    assert pallas != naive and abs(pallas - naive) < 0.5 * naive


def test_cli_writes_caches_and_records_failures(tmp_path, capsys):
    out = str(tmp_path / "out")
    argv = ["--arch", "llama3.2-1b", "--shape", "decode_32k", "--out", out,
            "--unroll", "2"]
    with pytest.raises(SystemExit) as e:
        dryrun.main(argv)
    assert e.value.code == 0
    path = os.path.join(out, "llama3.2-1b_decode_32k_16x16_basic_ws_basic"
                             ".json")
    res = json.load(open(path))
    assert res["ok"] and res["unroll"] == 2 and set(res) >= REFERENCE_KEYS
    assert res["roofline"]["bottleneck"] in ("compute", "memory",
                                            "collective")
    with pytest.raises(SystemExit) as e:
        dryrun.main(argv)
    assert e.value.code == 0 and "[skip cached]" in capsys.readouterr().out
    # tp splits heads over the 16 model ranks: Llama-3.2-1B's 8 kv heads
    # do not divide, so the trainer refuses and the combo fails
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "llama3.2-1b", "--shape", "train_4k",
                     "--sharding", "tp", "--out", out])
    assert e.value.code == 1
    bad = json.load(open(os.path.join(
        out, "llama3.2-1b_train_4k_16x16_tp_basic.json")))
    assert not bad["ok"] and bad["error"].startswith("ValueError")
