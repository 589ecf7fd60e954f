"""The port's boundary with the reference: parameter conversion, the init
law, and the rule that ``repro_torch`` imports neither JAX nor anything of
the ``repro`` package (its copies of configs, data and obs stand alone).
"""
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
from repro.models import dual_encoder as jde
from repro_torch import interop
from repro_torch.configs import get_arch, list_archs, smoke_dual_variant

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


def test_configs_copy_the_reference():
    assert list_archs() == ["basic-l", "basic-m", "basic-s"]
    for arch in list_archs():
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
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 30      # every module was imported


_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)",
                        re.MULTILINE)


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
