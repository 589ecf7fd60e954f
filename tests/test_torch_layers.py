"""Port parity: primitive layers, the precision policy and the vision
frontend of ``repro_torch`` against the JAX reference on the CPU.

Inputs are drawn with numpy from a seed and handed to both packages.
Tolerance: fp32 elementwise ops and small matmuls agree to 1e-6 abs /
1e-5 rel (XLA and PyTorch sum in other orders); bf16 outputs to one bf16
ulp of the values compared (2e-2).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import smoke_variant as jax_smoke_variant
from repro.models import frontends as jfe
from repro.models import layers as jL
from repro_torch.configs import get_arch, smoke_variant
from repro_torch.models import frontends as tfe
from repro_torch.models import layers as tL
from repro_torch.models import precision as tprec

torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-6)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 7, 32), (2, 64)])
def test_rms_norm(shape, dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape).astype(np.float32) * 3
    scale = rng.standard_normal(shape[-1]).astype(np.float32)
    out_j = jL.rms_norm(jnp.asarray(x, dtype), jnp.asarray(scale), 1e-5)
    out_t = tL.rms_norm(torch.tensor(x).to(getattr(torch, dtype)),
                        torch.tensor(scale), 1e-5)
    assert str(out_t.dtype) == f"torch.{dtype}"
    tol = F32 if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(_np(out_t), _np(out_j), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope(theta, dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9), (2, 9)).astype(np.int32)
    out_j = jL.apply_rope(jnp.asarray(x, dtype), jnp.asarray(pos), theta)
    out_t = tL.apply_rope(torch.tensor(x).to(getattr(torch, dtype)),
                          torch.tensor(pos), theta)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" \
        else dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(_np(out_t), _np(out_j), **tol)
    np.testing.assert_allclose(tL.rope_freqs(16, theta).numpy(),
                               np.asarray(jL.rope_freqs(16, theta)), **F32)


def test_swiglu_and_dense():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 5, 32)).astype(np.float32)
    wi, wg = (rng.standard_normal((32, 48)).astype(np.float32) * 0.2
              for _ in range(2))
    wo = rng.standard_normal((48, 32)).astype(np.float32) * 0.2
    out_j = jL.swiglu(*(jnp.asarray(a) for a in (x, wi, wg, wo)))
    out_t = tL.swiglu(*(torch.tensor(a) for a in (x, wi, wg, wo)))
    np.testing.assert_allclose(_np(out_t), _np(out_j), **F32)
    np.testing.assert_allclose(
        _np(tL.dense(torch.tensor(x), torch.tensor(wi))),
        _np(jL.dense(jnp.asarray(x), jnp.asarray(wi))), **F32)


@pytest.mark.parametrize("arch", ["basic-s", "basic-m"])
def test_patchify_and_patch_embed(arch):
    jcfg = jax_smoke_variant(jax_get_arch(arch).image_tower)
    tcfg = smoke_variant(get_arch(arch).image_tower)
    assert (tcfg.image_size, tcfg.patch_size, tcfg.frontend_len) == \
        (jcfg.image_size, jcfg.patch_size, jcfg.frontend_len)
    rng = np.random.default_rng(3)
    images = rng.standard_normal(
        (3, tcfg.image_size, tcfg.image_size, 3)).astype(np.float32)
    proj = rng.standard_normal(
        (tcfg.patch_size ** 2 * 3, tcfg.d_model)).astype(np.float32) * 0.1
    np.testing.assert_array_equal(
        tfe.patchify(torch.tensor(images), tcfg.patch_size).numpy(),
        np.asarray(jfe.patchify(jnp.asarray(images), jcfg.patch_size)))
    out_t = tfe.patch_embed({"patch_proj": torch.tensor(proj)}, tcfg,
                            torch.tensor(images), torch.float32)
    out_j = jfe.patch_embed({"patch_proj": jnp.asarray(proj)}, jcfg,
                            jnp.asarray(images), jnp.float32)
    assert out_t.shape == (3, tcfg.frontend_len, tcfg.d_model)
    np.testing.assert_allclose(_np(out_t), _np(out_j), rtol=1e-5, atol=1e-5)


def test_patch_embed_rejects_wrong_geometry():
    cfg = smoke_variant(get_arch("basic-s").image_tower)
    images = torch.zeros((1, cfg.image_size * 2, cfg.image_size * 2, 3))
    with pytest.raises(ValueError, match="patches"):
        tfe.patch_embed({"patch_proj": torch.zeros(
            (cfg.patch_size ** 2 * 3, cfg.d_model))}, cfg, images,
            torch.float32)


def test_precision_policies_mirror_reference():
    from repro.models import precision as jprec
    assert tprec.list_policies() == jprec.list_policies()
    for name in tprec.list_policies():
        t, j = tprec.resolve(name), jprec.resolve(name)
        assert str(t.compute_dtype).removeprefix("torch.") == \
            jnp.dtype(j.compute_dtype).name
        assert t.fp32_projections == j.fp32_projections
    assert tprec.resolve(None).name == "f32"
    assert tprec.resolve(None, torch.bfloat16) is tprec.POLICIES["bf16"]
    assert tprec.resolve(torch.float32) is tprec.POLICIES["f32"]
    with pytest.raises(KeyError):
        tprec.resolve("fp8")


def test_trunc_normal_law():
    g = torch.Generator().manual_seed(0)
    w = tL.dense_init(g, 256, 512)
    sigma = 256 ** -0.5
    assert w.shape == (256, 512) and w.dtype == torch.float32
    assert float(w.abs().max()) <= 2 * sigma
    # a standard normal truncated at ±2 has std 0.8796
    assert abs(float(w.std()) / sigma - 0.8796) < 0.01
