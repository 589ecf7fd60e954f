"""Port parity: checkpoints (``repro_torch.checkpoint``) on the CPU.

- The port of each of ``tests/test_checkpoint.py``'s 21 cases, on the
  port's trees: round trip, wrong structure, missing step and leaf,
  latest, optimizer state, the index's hash and size, a truncated leaf, a
  flipped byte, a tampered hash, a missing leaf and index, the latest
  verified step skipping bad steps and collecting tmp dirs, a legacy
  index, retention, and the async manager (async = sync, join, deferred
  error, retry, retention).
- The format across packages, both ways: a BASIC smoke dual encoder's
  params and its ``AdaFactorWState`` (bf16 first moment, 0-d int32 step)
  saved by the reference and restored by the port bit for bit, and the
  reverse through the reference's ``restore`` and ``verify``; for the same
  tree, identical ``index.json`` leaf records and treedef.
- The registry's disk cache across packages, both ways, and
  ``params_fingerprint`` equal to the reference's on one tree.
"""
import json
import os
import threading

import jax
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs import get_arch as jax_get_arch
from repro.configs import smoke_dual_variant as jax_smoke_dual
from repro.models import dual_encoder as jde
from repro.optim import AdaFactorW as JAdaFactorW
from repro.serving.embed import registry as jreg
from repro_torch import checkpoint as ckpt
from repro_torch import interop
from repro_torch.checkpoint import faults
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.configs import get_arch, smoke_variant
from repro_torch.optim import AdaFactorW, AdaFactorWState
from repro_torch.serving.embed import registry as treg
from repro_torch.tree import leaves, treedef_str, unflatten

torch.set_num_threads(1)


def _steps_on_disk(d):
    return sorted(int(x.split("_")[1]) for x in os.listdir(d)
                  if x.startswith("step_"))


def _bits(t):
    """A tensor's bytes, for equality bit for bit (bf16 included)."""
    t = t.detach().cpu().contiguous()
    return (t.dtype, tuple(t.shape), t.view(torch.uint8).numpy().tobytes()
            if t.dim() else t.reshape(1).view(torch.uint8).numpy().tobytes())


def _assert_trees_equal(got, ref):
    g, r = list(leaves(got)), list(leaves(ref))
    assert [p for p, _ in g] == [p for p, _ in r]
    for (path, a), (_, b) in zip(g, r):
        assert _bits(a) == _bits(b), path


def _meta_like(tree):
    """Meta-device stand-ins of ``tree``'s leaves, NamedTuples kept."""
    return unflatten(tree, [torch.empty(x.shape, dtype=x.dtype, device="meta")
                            for _, x in leaves(tree)])


def _lm_params(arch, seed):
    return interop.init_params(smoke_variant(get_arch(arch)),
                               torch.Generator().manual_seed(seed), "cpu")


def test_roundtrip(tmp_path):
    params = _lm_params("qwen3-32b", 0)
    path = ckpt.save(str(tmp_path), 7, params)
    assert os.path.isdir(path)
    assert ckpt.latest_step(str(tmp_path)) == 7
    assert ckpt.latest_verified_step(str(tmp_path)) == 7
    restored = ckpt.restore(str(tmp_path), 7, _meta_like(params),
                            device="cpu")
    _assert_trees_equal(restored, params)


def test_restore_rejects_wrong_structure(tmp_path):
    """Validation raises CheckpointError naming the leaf and the count,
    shape or dtype mismatch."""
    tree = {"a": torch.ones(3), "b": torch.zeros(2, 2)}
    ckpt.save(str(tmp_path), 1, tree)
    with pytest.raises(ckpt.CheckpointError, match="2 leaves.*has 1"):
        ckpt.restore(str(tmp_path), 1, {"a": torch.ones(3)}, device="cpu")
    with pytest.raises(ckpt.CheckpointError, match="leaf 0 shape mismatch"):
        ckpt.restore(str(tmp_path), 1,
                     {"a": torch.ones(4), "b": torch.zeros(2, 2)},
                     device="cpu")
    with pytest.raises(ckpt.CheckpointError, match="leaf 1 dtype mismatch"):
        ckpt.restore(str(tmp_path), 1,
                     {"a": torch.ones(3),
                      "b": torch.zeros(2, 2, dtype=torch.bfloat16)},
                     device="cpu")


def test_restore_missing_step_and_leaf_raise_checkpoint_error(tmp_path):
    tree = {"a": torch.ones(3)}
    ckpt.save(str(tmp_path), 1, tree)
    with pytest.raises(ckpt.CheckpointError, match="no checkpoint"):
        ckpt.restore(str(tmp_path), 9, tree, device="cpu")
    os.remove(tmp_path / "step_00000001" / "arr_0.npy")
    with pytest.raises(ckpt.CheckpointError, match="leaf 0 unreadable"):
        ckpt.restore(str(tmp_path), 1, tree, device="cpu")


def test_multiple_steps_latest(tmp_path):
    tree = {"w": torch.ones(2)}
    ckpt.save(str(tmp_path), 1, tree)
    ckpt.save(str(tmp_path), 10, tree)
    ckpt.save(str(tmp_path), 5, tree)
    assert ckpt.latest_step(str(tmp_path)) == 10


def test_optimizer_state_roundtrip(tmp_path):
    params = _lm_params("llama3.2-1b", 1)
    st = AdaFactorW().init(params)
    tree = {"params": params, "opt": st}
    ckpt.save(str(tmp_path), 2, tree)
    restored = ckpt.restore(str(tmp_path), 2, _meta_like(tree),
                            device="cpu")
    assert isinstance(restored["opt"], AdaFactorWState)
    assert restored["opt"].m["final_norm"].dtype == torch.bfloat16
    assert restored["opt"].step.dtype == torch.int32
    _assert_trees_equal(restored, tree)


def test_snapshot_copies_and_refuses_none(tmp_path):
    """The snapshot owns its bytes: an in-place step after it (as the
    optimizer's next update) does not reach what is written; a None leaf,
    which JAX reads as an empty subtree, is refused."""
    w = torch.arange(6, dtype=torch.float32)
    arrs, treedef = ckpt_io.snapshot({"w": w})
    w.add_(100.0)
    ckpt_io.write_snapshot(str(tmp_path), 1, arrs, treedef)
    got = ckpt.restore(str(tmp_path), 1, {"w": w}, device="cpu")
    assert torch.equal(got["w"], torch.arange(6, dtype=torch.float32))
    with pytest.raises(ckpt.CheckpointError, match="leaf 1 .*None"):
        ckpt.save(str(tmp_path), 2, {"a": torch.ones(1), "b": None})


# ---------------------------------------------------------------------------
# integrity: verify / latest_verified_step on corrupted checkpoints
# ---------------------------------------------------------------------------


_TREE = {"a": torch.arange(64, dtype=torch.float32).reshape(8, 8),
         "b": torch.ones(16)}


def test_index_records_hash_and_size(tmp_path):
    ckpt.save(str(tmp_path), 1, _TREE)
    with open(tmp_path / "step_00000001" / "index.json") as f:
        index = json.load(f)
    assert index["format"] == 2
    for i, leaf in enumerate(index["leaves"]):
        path = tmp_path / "step_00000001" / f"arr_{i}.npy"
        assert leaf["bytes"] == os.path.getsize(path)
        assert len(leaf["sha256"]) == 64


def test_verify_rejects_truncated_leaf(tmp_path):
    ckpt.save(str(tmp_path), 1, _TREE)
    faults.truncate_leaf(str(tmp_path), 1, leaf=0)
    with pytest.raises(ckpt.CheckpointError, match="leaf 0 truncated"):
        ckpt.verify(str(tmp_path), 1)


def test_verify_rejects_flipped_byte(tmp_path):
    """Bit rot keeps the size right: only the sha256 catches it."""
    ckpt.save(str(tmp_path), 1, _TREE)
    assert ckpt.verify(str(tmp_path), 1)["n"] == 2
    faults.flip_byte(str(tmp_path), 1, leaf=1)
    with pytest.raises(ckpt.CheckpointError, match="leaf 1 content hash"):
        ckpt.verify(str(tmp_path), 1)


def test_verify_rejects_tampered_index_hash(tmp_path):
    ckpt.save(str(tmp_path), 1, _TREE)
    faults.tamper_index_hash(str(tmp_path), 1, leaf=0)
    with pytest.raises(ckpt.CheckpointError, match="leaf 0 content hash"):
        ckpt.verify(str(tmp_path), 1)


def test_verify_rejects_missing_leaf_and_index(tmp_path):
    ckpt.save(str(tmp_path), 1, _TREE)
    os.remove(tmp_path / "step_00000001" / "arr_1.npy")
    with pytest.raises(ckpt.CheckpointError, match="leaf 1 missing"):
        ckpt.verify(str(tmp_path), 1)
    os.remove(tmp_path / "step_00000001" / "index.json")
    with pytest.raises(ckpt.CheckpointError, match="missing index.json"):
        ckpt.verify(str(tmp_path), 1)
    with pytest.raises(ckpt.CheckpointError, match="no checkpoint dir"):
        ckpt.verify(str(tmp_path), 42)


def test_latest_verified_skips_bad_newest_to_good_older(tmp_path):
    """Resume lands on the newest good checkpoint: a corrupt newest step
    and a truncated middle step are both skipped."""
    for s in (1, 2, 3):
        ckpt.save(str(tmp_path), s, _TREE)
    faults.flip_byte(str(tmp_path), 3)
    assert ckpt.latest_verified_step(str(tmp_path)) == 2
    faults.truncate_leaf(str(tmp_path), 2)
    assert ckpt.latest_verified_step(str(tmp_path)) == 1
    faults.tamper_index_hash(str(tmp_path), 1)
    assert ckpt.latest_verified_step(str(tmp_path)) is None


def test_latest_verified_gcs_leftover_tmp_dirs(tmp_path):
    """A crash mid-save leaks ``.tmp_ckpt_*``; resume collects it and never
    mistakes it for a checkpoint."""
    ckpt.save(str(tmp_path), 4, _TREE)
    tmp = faults.leftover_tmp(str(tmp_path))
    assert os.path.isdir(tmp)
    assert ckpt.latest_verified_step(str(tmp_path)) == 4
    assert not os.path.isdir(tmp)
    # gc=False leaves such dirs alone (an in-flight writer may own them)
    tmp2 = faults.leftover_tmp(str(tmp_path))
    assert ckpt.latest_verified_step(str(tmp_path), gc=False) == 4
    assert os.path.isdir(tmp2)


def test_verify_accepts_legacy_index_without_hashes(tmp_path):
    """Format-1 checkpoints (no hashes) verify on existence and leaf
    count."""
    ckpt.save(str(tmp_path), 1, _TREE)
    ipath = tmp_path / "step_00000001" / "index.json"
    with open(ipath) as f:
        index = json.load(f)
    for leaf in index["leaves"]:
        leaf.pop("sha256"), leaf.pop("bytes")
    index.pop("format")
    with open(ipath, "w") as f:
        json.dump(index, f)
    assert ckpt.verify(str(tmp_path), 1)["n"] == 2
    assert ckpt.latest_verified_step(str(tmp_path)) == 1


def test_write_faults_leave_no_torn_step(tmp_path):
    """A write that fails mid-save publishes nothing and leaves no tmp
    dir; the next save works."""
    with faults.failing_writes(1) as fired:
        with pytest.raises(OSError, match="injected"):
            ckpt.save(str(tmp_path), 1, _TREE)
    assert fired["fired"] == 1
    assert os.listdir(tmp_path) == []
    ckpt.save(str(tmp_path), 1, _TREE)
    assert ckpt.latest_verified_step(str(tmp_path)) == 1


# ---------------------------------------------------------------------------
# retention / GC keep policy
# ---------------------------------------------------------------------------


def test_gc_keep_last_k(tmp_path):
    for s in range(1, 7):
        ckpt.save(str(tmp_path), s, _TREE)
    removed = ckpt.gc_steps(str(tmp_path), keep_last=2)
    assert removed == [1, 2, 3, 4]
    assert _steps_on_disk(tmp_path) == [5, 6]


def test_gc_keep_last_1_never_removes_newest(tmp_path):
    """K=1: everything but the newest goes; K=0 is rejected."""
    for s in (3, 9):
        ckpt.save(str(tmp_path), s, _TREE)
    assert ckpt.gc_steps(str(tmp_path), keep_last=1) == [3]
    assert _steps_on_disk(tmp_path) == [9]
    assert ckpt.gc_steps(str(tmp_path), keep_last=1) == []
    with pytest.raises(ckpt.CheckpointError, match="keep_last"):
        ckpt.gc_steps(str(tmp_path), keep_last=0)


def test_gc_keep_every_n_boundary(tmp_path):
    """Multiples of N survive, step N itself included; other steps outside
    the last K go."""
    for s in range(1, 11):
        ckpt.save(str(tmp_path), s, _TREE)
    ckpt.gc_steps(str(tmp_path), keep_last=2, keep_every=5)
    assert _steps_on_disk(tmp_path) == [5, 9, 10]
    ckpt.save(str(tmp_path), 11, _TREE)
    ckpt.gc_steps(str(tmp_path), keep_last=2, keep_every=5)
    assert _steps_on_disk(tmp_path) == [5, 10, 11]


# ---------------------------------------------------------------------------
# async manager
# ---------------------------------------------------------------------------


def test_manager_async_save_matches_sync(tmp_path):
    """Async and sync paths agree byte for byte: same index hashes, same
    restored values, meta riding the same atomic rename."""
    a = ckpt.AsyncCheckpointManager(str(tmp_path / "a"))
    a.save_async(1, _TREE, meta={"k": 1})
    a.close()
    s = ckpt.AsyncCheckpointManager(str(tmp_path / "s"), sync=True)
    s.save(1, _TREE, meta={"k": 1})
    with open(tmp_path / "a" / "step_00000001" / "index.json") as f:
        ia = json.load(f)
    with open(tmp_path / "s" / "step_00000001" / "index.json") as f:
        ib = json.load(f)
    assert [x["sha256"] for x in ia["leaves"]] == \
        [x["sha256"] for x in ib["leaves"]]
    assert ckpt.load_meta(str(tmp_path / "a"), 1) == {"k": 1}
    got = ckpt.restore(str(tmp_path / "a"), 1, _TREE, device="cpu")
    assert torch.equal(got["a"], _TREE["a"])
    assert a.stats["async_saves"] == 1 and s.stats["sync_saves"] == 1
    assert a.metrics.gauge("ckpt/last_stall_s").value >= 0.0
    assert a.metrics.histogram("ckpt/write_latency_s").count == 1


def test_manager_joins_inflight_write_before_next_save(tmp_path):
    """A second save (or shutdown) joins the in-flight write: step dirs
    appear in order and at most one background writer exists."""
    gate = threading.Event()
    orig = ckpt_io.write_snapshot

    def slow(directory, step, arrs, treedef, meta=None):
        if step == 1:
            gate.wait(timeout=10.0)
        return orig(directory, step, arrs, treedef, meta=meta)

    m = ckpt.AsyncCheckpointManager(str(tmp_path))
    ckpt_io.write_snapshot = slow
    try:
        m.save_async(1, _TREE)
        assert m.in_flight
        gate.set()
        m.save_async(2, _TREE)  # joins step 1 first
        assert ckpt.verify(str(tmp_path), 1)
        m.close()
        assert not m.in_flight
        assert ckpt.verify(str(tmp_path), 2)
    finally:
        ckpt_io.write_snapshot = orig


def test_manager_surfaces_write_error_on_next_call_then_heals(tmp_path):
    """A failed background write raises on the next wait()/save; transient
    OSErrors are retried with backoff first, and the manager works again
    once the fault clears."""
    m = ckpt.AsyncCheckpointManager(str(tmp_path), max_retries=2,
                                    backoff_s=0.005)
    with faults.failing_writes(100) as fired:
        m.save_async(1, _TREE)
        with pytest.raises(ckpt.CheckpointError, match="step 1 failed"):
            m.wait()
    assert fired["fired"] == 3          # 1 try + 2 retries
    assert m.stats["retried_writes"] == 2 and m.stats["failed_writes"] == 1
    assert ckpt.latest_verified_step(str(tmp_path)) is None
    m.save_async(2, _TREE)
    m.close()
    assert ckpt.latest_verified_step(str(tmp_path)) == 2


def test_manager_transient_fault_retries_through(tmp_path):
    """A fault that clears within the retry budget never surfaces."""
    m = ckpt.AsyncCheckpointManager(str(tmp_path), max_retries=3,
                                    backoff_s=0.005)
    with faults.failing_writes(2):
        m.save_async(1, _TREE)
        m.wait()
    assert m.stats["retried_writes"] == 2
    assert ckpt.verify(str(tmp_path), 1)


def test_manager_retention_rides_saves(tmp_path):
    m = ckpt.AsyncCheckpointManager(str(tmp_path), keep_last=2,
                                    keep_every=4)
    for s in range(1, 7):
        m.save(s, _TREE)
    m.close()
    assert _steps_on_disk(tmp_path) == [4, 5, 6]
    assert m.stats["gc_removed"] == 3


def test_manager_degrade_to_sync(tmp_path):
    m = ckpt.AsyncCheckpointManager(str(tmp_path))
    m.degrade_to_sync()
    m.degrade_to_sync()
    m.save(3, _TREE)
    assert m.stats["degraded"] == 1 and m.stats["sync_saves"] == 1
    assert not m.in_flight and ckpt.verify(str(tmp_path), 3)


# ---------------------------------------------------------------------------
# the format across packages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dual_tree():
    """A BASIC smoke dual encoder's params and AdaFactorW state: the
    reference's (numpy, bf16 first moment under ml_dtypes) and the same
    tree in the port."""
    jcfg = jax_smoke_dual(jax_get_arch("basic-s"))
    jparams = jde.init_params(jcfg, jax.random.key(0))
    jst = JAdaFactorW().init(jparams)
    # a non-zero step and first moment, so their bits are exercised
    jst = jst._replace(step=jst.step + 3, m=jax.tree.map(
        lambda p, m: (0.01 * p).astype(m.dtype), jparams, jst.m))
    jtree = jax.device_get({"params": jparams, "opt": jst})
    ttree = {"params": interop.from_numpy(jtree["params"], "cpu"),
             "opt": interop.opt_state_from_numpy(jtree["opt"], "cpu")}
    return jtree, ttree


def _np_bits(a):
    a = np.asarray(a)
    return str(a.dtype), a.shape, a.tobytes()


def test_reference_checkpoint_restores_in_the_port(tmp_path, dual_tree):
    jtree, ttree = dual_tree
    jckpt.save(str(tmp_path), 5, jtree)
    assert ckpt.verify(str(tmp_path), 5)["n"] == len(list(leaves(ttree)))
    got = ckpt.restore(str(tmp_path), 5, _meta_like(ttree), device="cpu")
    assert isinstance(got["opt"], AdaFactorWState)
    assert got["opt"].step.dtype == torch.int32 and \
        int(got["opt"].step) == 3
    assert got["opt"].m["log_tau"].dtype == torch.bfloat16
    _assert_trees_equal(got, ttree)


def test_port_checkpoint_restores_in_the_reference(tmp_path, dual_tree):
    jtree, ttree = dual_tree
    ckpt.save(str(tmp_path), 6, ttree)
    assert jckpt.verify(str(tmp_path), 6)["n"] == len(jax.tree.leaves(jtree))
    assert jckpt.latest_verified_step(str(tmp_path)) == 6
    got = jckpt.restore(str(tmp_path), 6, jax.eval_shape(lambda: jtree))
    assert type(got["opt"]).__name__ == "AdaFactorWState"
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jtree)):
        assert _np_bits(a) == _np_bits(b)


def test_both_packages_write_the_same_index(tmp_path, dual_tree):
    jtree, ttree = dual_tree
    jckpt.save(str(tmp_path / "j"), 1, jtree)
    ckpt.save(str(tmp_path / "t"), 1, ttree)
    with open(tmp_path / "j" / "step_00000001" / "index.json") as f:
        ij = json.load(f)
    with open(tmp_path / "t" / "step_00000001" / "index.json") as f:
        it = json.load(f)
    assert it["treedef"] == ij["treedef"] == \
        str(jax.tree_util.tree_structure(jtree))
    assert it["leaves"] == ij["leaves"]
    assert {r["dtype"] for r in it["leaves"]} == {"float32", "bfloat16",
                                                  "int32"}


@pytest.mark.parametrize("tree", [
    {"b": [{"x": 1, "y": 2}, {"x": 3}], "a": 0},
    {"p": (1, 2), "q": None, "e": {}, "l": [], "t": (5,)},
    [None, {"k": ()}],
    7,
])
def test_treedef_str_is_jax_s(tree):
    assert treedef_str(tree) == str(jax.tree_util.tree_structure(tree))


def test_params_fingerprint_equals_the_reference(dual_tree):
    jtree, ttree = dual_tree
    assert treg.params_fingerprint(ttree["params"]) == \
        jreg.params_fingerprint(jtree["params"])
    # the bf16 first moment and the int32 step hash as the reference's
    assert treg.params_fingerprint(ttree["opt"]) == \
        jreg.params_fingerprint(jtree["opt"])
    bumped = dict(ttree["params"], log_tau=ttree["params"]["log_tau"] + 1)
    assert treg.params_fingerprint(bumped) != \
        treg.params_fingerprint(ttree["params"])


_CLASSES = ("cat", "dog", "bird")
_TEMPLATES = ("a photo of a {}.", "a {}.")


def _unit_rows(seed, n=3, d=8):
    m = np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)
    return m / np.linalg.norm(m, axis=1, keepdims=True)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_registry_disk_cache_crosses_packages(tmp_path, writer):
    """A matrix one package's registry computed and persisted under a key
    is read back by the other's as ``source == 'disk'``, equal bit for
    bit; ``refresh`` then writes version 2 that the first reads back."""
    mat = _unit_rows(0)
    computed = {"reference": jreg.ClassEmbeddingRegistry(
                    lambda c, t: mat, cache_dir=str(tmp_path)),
                "port": treg.ClassEmbeddingRegistry(
                    lambda c, t: torch.from_numpy(mat),
                    cache_dir=str(tmp_path))}
    first = computed[writer].get(_CLASSES, _TEMPLATES, "ck", embed_dim=8)
    assert first.source == "computed" and first.version == 1
    reader = "port" if writer == "reference" else "reference"
    other = {"reference": jreg.ClassEmbeddingRegistry(
                 cache_dir=str(tmp_path)),
             "port": treg.ClassEmbeddingRegistry(
                 cache_dir=str(tmp_path))}[reader]
    got = other.get(_CLASSES, _TEMPLATES, "ck", embed_dim=8)
    assert got.source == "disk" and got.version == 1
    assert got.key == first.key
    np.testing.assert_array_equal(np.asarray(got.matrix), mat)
    assert other.stats["disk_hits"] == 1
    assert other.get(_CLASSES, _TEMPLATES, "ck",
                     embed_dim=8).source == "memory"


def test_registry_refresh_bumps_the_version_on_disk(tmp_path):
    mats = iter([_unit_rows(1), _unit_rows(2)])
    reg = treg.ClassEmbeddingRegistry(lambda c, t: next(mats),
                                      cache_dir=str(tmp_path))
    v1 = reg.get(_CLASSES, _TEMPLATES, "ck", embed_dim=8)
    v2 = reg.refresh(_CLASSES, _TEMPLATES, "ck", embed_dim=8)
    assert (v1.version, v2.version) == (1, 2)
    fresh = treg.ClassEmbeddingRegistry(cache_dir=str(tmp_path))
    got = fresh.get(_CLASSES, _TEMPLATES, "ck", embed_dim=8)
    assert got.source == "disk" and got.version == 2
    np.testing.assert_array_equal(got.matrix, v2.matrix)
    ref = jreg.ClassEmbeddingRegistry(cache_dir=str(tmp_path))
    assert ref.get(_CLASSES, _TEMPLATES, "ck", embed_dim=8).version == 2


def test_recipe_chains_through_a_checkpoint(tmp_path):
    """``--ckpt-dir`` in the recipe's modes saves the final params at step
    ``--steps``: phase 1 its {'tower', 'head'}, phase 2 the dual encoder,
    started from the tower restored from phase 1's checkpoint; both read
    back bit for bit, and the reference verifies them."""
    from repro_torch.launch import train as ttrain
    common = ["--arch", "basic-s", "--smoke", "--device", "cpu",
              "--batch", "8", "--num-micro", "2", "--classes", "16",
              "--steps", "2"]
    pre = ttrain.main(["--mode", "pretrain", *common, "--ckpt-dir",
                       str(tmp_path / "p1")])
    assert pre["ckpt_path"] == str(tmp_path / "p1" / "step_00000002")
    tower = ckpt.restore(str(tmp_path / "p1"), 2, _meta_like(pre["params"]),
                         device="cpu")
    _assert_trees_equal(tower, pre["params"])
    args = ttrain.parse_args(["--mode", "contrastive", *common,
                              "--ckpt-dir", str(tmp_path / "p2")])
    p2 = ttrain.run_contrastive(args, image_tower_init=tower["tower"])
    back = ckpt.restore(str(tmp_path / "p2"), 2, _meta_like(p2["params"]),
                        device="cpu")
    _assert_trees_equal(back, p2["params"])
    for d in ("p1", "p2"):
        assert jckpt.latest_verified_step(str(tmp_path / d)) == 2
