"""The port's boundary with the reference: parameter conversion, the init
law, and the rule that ``repro_torch`` imports neither JAX, nor
``ml_dtypes``, nor anything of the ``repro`` package (its copies of
configs, data and obs stand alone; its checkpoints read and write bf16
without ``ml_dtypes``).
"""
import dataclasses
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import smoke_dual_variant as jax_smoke_dual
from repro.configs import smoke_variant as jax_smoke_variant
from repro.models import dual_encoder as jde
from repro.models import transformer as jtf
from repro_torch import interop
from repro_torch.configs import (get_arch, list_archs, smoke_dual_variant,
                                 smoke_variant)

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
PORT = os.path.join(ROOT, "src", "repro_torch")


def _jax_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    out = {}
    for path, leaf in flat:
        keys = [str(getattr(p, "key", getattr(p, "idx", p))) for p in path]
        out["/".join(keys)] = np.asarray(leaf)
    return out


@pytest.mark.parametrize("arch", ["basic-s", "basic-m"])
def test_params_round_trip_keeps_every_leaf(arch):
    jparams = jax.device_get(jde.init_params(
        jax_smoke_dual(jax_get_arch(arch)), jax.random.key(1)))
    tparams = interop.from_numpy(jparams, "cpu")
    ref = _jax_paths(jparams)
    got = dict(interop.leaves(tparams))
    assert set(got) == set(ref)
    for path, arr in ref.items():
        assert got[path].dtype == torch.float32, path
        np.testing.assert_array_equal(got[path].numpy(), arr, err_msg=path)
    back = _jax_paths(interop.to_numpy(tparams))
    for path, arr in ref.items():
        np.testing.assert_array_equal(back[path], arr, err_msg=path)


@pytest.mark.parametrize("arch", ["basic-s", "basic-l"])
def test_init_params_has_the_reference_layout_and_law(arch):
    jshapes = jax.eval_shape(lambda: jde.init_params(
        jax_smoke_dual(jax_get_arch(arch)), jax.random.key(0)))
    ref = {p: a.shape for p, a in _jax_paths(jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype), jshapes)).items()}
    tparams = interop.init_params(smoke_dual_variant(get_arch(arch)),
                                  torch.Generator().manual_seed(0), "cpu")
    got = dict(interop.leaves(tparams))
    assert {p: tuple(t.shape) for p, t in got.items()} == ref
    assert float(got["log_tau"]) == pytest.approx(np.log(0.07), rel=1e-7)
    for path, t in got.items():
        if path.endswith(("ln1", "ln2", "final_norm")):
            assert bool((t == 1).all()), path
        elif path.endswith("embed"):
            sigma = t.shape[-1] ** -0.5
            assert float(t.abs().max()) <= 2 * sigma
        elif t.dim() >= 2:           # dense: σ = d_in^-0.5, cut at ±2σ
            sigma = t.shape[-2] ** -0.5
            assert float(t.abs().max()) <= 2 * sigma, path
            assert abs(float(t.std()) / sigma - 0.8796) < 0.05, path


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen3-32b", "mamba2-130m"])
def test_lm_params_have_the_reference_layout_and_round_trip(arch):
    """An ArchConfig goes to the transformer's init: the reference LM's
    leaf paths and shapes, and the reference's weights carried over as
    they are."""
    jcfg = jax_smoke_variant(jax_get_arch(arch))
    jparams = jax.device_get(jtf.init_params(jcfg, jax.random.key(0)))
    ref = _jax_paths(jparams)
    tparams = interop.init_params(smoke_variant(get_arch(arch)),
                                  torch.Generator().manual_seed(0), "cpu")
    got = dict(interop.leaves(tparams))
    assert {p: tuple(t.shape) for p, t in got.items()} == \
        {p: a.shape for p, a in ref.items()}
    carried = dict(interop.leaves(interop.from_numpy(jparams, "cpu")))
    for path, arr in ref.items():
        np.testing.assert_array_equal(carried[path].numpy(), arr,
                                      err_msg=path)
    with pytest.raises(TypeError):
        interop.init_params(object(), torch.Generator(), "cpu")


def test_ssm_caches_round_trip():
    """A list holding the reference's ``SSMCache`` (ssm (L, b, h, p, n)
    f32, conv (L, b, cw-1, d_conv) bf16) comes over as the port's
    ``SSMCache`` on the named device, dtypes kept, and goes back as the
    same arrays; a ``KVCache`` list still does."""
    from repro.models.attention import KVCache as JKV
    from repro.models.ssm import SSMCache as JSSM
    from repro_torch.models.attention import KVCache
    from repro_torch.models.ssm import SSMCache
    jcfg = jax_smoke_variant(jax_get_arch("mamba2-130m"))
    caches = jax.device_get(jtf.init_caches(jcfg, 2, 16, jax.numpy.bfloat16))
    rng = np.random.default_rng(0)
    caches = [JSSM(ssm=rng.standard_normal(caches[0].ssm.shape).astype(
        np.float32), conv=jax.device_get(jax.numpy.asarray(
            rng.standard_normal(caches[0].conv.shape),
            jax.numpy.bfloat16)))]
    got = interop.caches_from_numpy(caches, "cpu")
    assert isinstance(got[0], SSMCache)
    assert got[0].ssm.dtype == torch.float32
    assert got[0].conv.dtype == torch.bfloat16
    assert tuple(got[0].ssm.shape) == (2, 2, 16, 32, 16)
    back = interop.caches_to_numpy(got)
    assert isinstance(back[0], SSMCache)
    np.testing.assert_array_equal(back[0].ssm, caches[0].ssm)
    np.testing.assert_array_equal(back[0].conv,
                                  np.asarray(caches[0].conv, np.float32))
    kv = [JKV(k=np.ones((1, 2, 3), np.float32),
              v=np.zeros((1, 2, 3), np.float32))]
    (kvt,) = interop.caches_from_numpy(kv, "cpu")
    assert isinstance(kvt, KVCache) and bool((kvt.k == 1).all())
    with pytest.raises(TypeError, match="KVCache or SSMCache"):
        interop.caches_from_numpy([(np.ones(2),)], "cpu")


def test_from_numpy_names_its_device():
    """No default device: a conversion onto torch always says where."""
    tree = {"a": np.ones((2, 3), np.float32), "b": [np.zeros(4, np.int32)]}
    with pytest.raises(TypeError):
        interop.from_numpy(tree)
    got = interop.from_numpy(tree, "cpu")
    assert got["a"].device.type == "cpu" and got["b"][0].dtype == torch.int32
    bf16 = jax.device_get(jax.numpy.ones((3,), jax.numpy.bfloat16) * 1.5)
    t = interop.from_numpy(bf16, "cpu")
    assert t.dtype == torch.bfloat16 and bool((t == 1.5).all())
    back = interop.to_numpy(t)
    assert back.dtype == np.float32 and bool((back == 1.5).all())


def test_init_params_is_seeded():
    cfg = smoke_dual_variant(get_arch("basic-s"))
    a, b, c = (interop.init_params(cfg, torch.Generator().manual_seed(s),
                                   "cpu") for s in (3, 3, 4))
    la, lb, lc = (dict(interop.leaves(t)) for t in (a, b, c))
    assert all(torch.equal(la[p], lb[p]) for p in la)
    assert not torch.equal(la["text/proj"], lc["text/proj"])


LM_FIELDS = ("family", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
             "vocab", "resolved_head_dim", "qk_norm", "sliding_window",
             "causal", "tie_embeddings", "rope_theta", "norm_eps",
             "attn_every", "source")


def test_configs_copy_the_reference():
    lms = ["arctic-480b", "hubert-xlarge", "internlm2-20b",
           "internvl2-76b", "jamba-1.5-large-398b", "llama3.2-1b",
           "mamba2-130m", "minitron-4b", "mixtral-8x22b", "qwen3-32b"]
    assert list_archs() == sorted(["basic-l", "basic-m", "basic-s"] + lms)
    for arch in lms:
        j, t = jax_get_arch(arch), get_arch(arch)
        for cj, ct in ((j, t), (jax_smoke_variant(j), smoke_variant(t))):
            for f in LM_FIELDS:
                if f == "resolved_head_dim" and not cj.n_heads:
                    continue            # attention-free: no head dim
                assert getattr(ct, f) == getattr(cj, f), (arch, f)
            assert ct.attention_free == cj.attention_free, arch
            assert ct.layer_kinds() == cj.layer_kinds(), arch
            assert ct.param_counts() == cj.param_counts(), arch
            assert (ct.ssm is None) == (cj.ssm is None), arch
            if cj.ssm is not None:
                assert dataclasses.asdict(ct.ssm) == dataclasses.asdict(
                    cj.ssm), arch
            assert (ct.moe is None) == (cj.moe is None), arch
            if cj.moe is not None:
                assert dataclasses.asdict(ct.moe) == dataclasses.asdict(
                    cj.moe), arch
                assert ct.moe_layer_mask() == cj.moe_layer_mask(), arch
    from repro.configs.llama3_2_1b import FULL_ATTENTION_VARIANT as jfull
    from repro_torch.configs.llama3_2_1b import FULL_ATTENTION_VARIANT
    assert FULL_ATTENTION_VARIANT.sliding_window is None
    assert FULL_ATTENTION_VARIANT.name == jfull.name
    for arch in ("basic-l", "basic-m", "basic-s"):
        j, t = jax_get_arch(arch), get_arch(arch)
        for tower in ("image_tower", "text_tower"):
            jt, tt = getattr(j, tower), getattr(t, tower)
            for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                      "vocab", "resolved_head_dim", "causal", "rope_theta",
                      "frontend_len", "image_size", "patch_size"):
                assert getattr(tt, f) == getattr(jt, f), (arch, tower, f)
        assert t.embed_dim == j.embed_dim
        assert t.init_temperature == j.init_temperature


def test_import_leaves_out_jax_and_the_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'ml_dtypes', 'repro')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 30      # every module was imported


_FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|ml_dtypes|repro)(\.|\s|$)", re.MULTILINE)


def _port_sources():
    for dirpath, _, files in os.walk(PORT):
        for f in files:
            if f.endswith((".py", ".cu")):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_no_source_imports_jax_or_the_reference():
    offenders = []
    for path in _port_sources():
        with open(path, encoding="utf-8") as f:
            text = f.read()
        offenders += [f"{path}: {m.group(0).strip()}"
                      for m in _FORBIDDEN.finditer(text)]
        if path.endswith(".py") and "chip_smoke" not in path:
            # no library kernel stands in for the port's own
            for call in ("scaled_dot_product_attention(", "torch.compile(",
                         "conv2d("):
                if call in text:
                    offenders.append(f"{path}: calls {call}")
    assert not offenders, offenders


_DISTRIBUTED = ("core/distributed_loss.py", "core/sharding.py",
                "launch/mesh.py", "launch/train_distributed.py",
                "data/pipeline.py", "data/sharded/__init__.py",
                "data/sharded/artifact.py", "data/sharded/augment.py",
                "data/sharded/loader.py", "obs/runlog.py", "obs/report.py")


@pytest.mark.parametrize("part", ["checkpoint", "chip_smoke.py",
                                  "distributed"])
def test_new_modules_are_in_the_scan(part):
    """The scan reaches the checkpoint package, chip_smoke.py and the
    distributed tier (mesh, sharding, the cross-shard loss, the sharded
    data subsystem, the runlog, the trainer), and the pattern catches each
    forbidden import as it would be written there."""
    scanned = [os.path.relpath(p, ROOT) for p in _port_sources()]
    if part == "checkpoint":
        want = {os.path.join("src", "repro_torch", "checkpoint", f) for f in
                ("__init__.py", "io.py", "faults.py", "manager.py")}
    elif part == "distributed":
        want = {os.path.join("src", "repro_torch", *f.split("/"))
                for f in _DISTRIBUTED}
    else:
        want = {part}
    assert want <= set(scanned)
    for line in ("import ml_dtypes", "from repro.checkpoint import io",
                 "import jax.numpy as jnp", "    import ml_dtypes"):
        assert _FORBIDDEN.search(line), line
    for line in ("from repro_torch.checkpoint import io",
                 "import numpy as np"):
        assert not _FORBIDDEN.search(line), line


def test_port_modules_are_documented():
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    try:
        import check_docs
    finally:
        sys.path.pop(0)
    missing = []
    for path in _port_sources():
        if path.endswith(".py"):
            missing += check_docs.missing_docstrings(path, ROOT)
    assert not missing, missing
