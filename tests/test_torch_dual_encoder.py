"""Port parity: the BASIC dual encoder (``encode_image``, ``encode_text``)
against the JAX reference on the same weights and inputs, at smoke size
(``smoke_dual_variant``: 2 layers, d <= 256, 16 patches).

The reference's parameters go through ``repro_torch.interop``. Tolerance:
f32, 1e-5 abs / 1e-4 rel; bf16, 2e-2, the reference's own bf16 tolerance
(tests/test_fused_contrastive.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import smoke_dual_variant as jax_smoke_dual
from repro.models import dual_encoder as jde
from repro.models import transformer as jtf
from repro_torch import interop
from repro_torch.configs import get_arch, smoke_dual_variant
from repro_torch.models import dual_encoder as tde
from repro_torch.models import transformer as ttf

torch.set_num_threads(1)

TOL = {"f32": dict(rtol=1e-4, atol=1e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}


def _cfgs(impl):
    def tower(c, attn):
        return dataclasses.replace(c, image_tower=dataclasses.replace(
            c.image_tower, attn_impl=attn), text_tower=dataclasses.replace(
            c.text_tower, attn_impl=attn))
    return (tower(jax_smoke_dual(jax_get_arch("basic-s")), impl),
            tower(smoke_dual_variant(get_arch("basic-s")),
                  "flash" if impl == "pallas" else impl))


@pytest.fixture(scope="module")
def setup():
    jcfg, _ = _cfgs("naive")
    jparams = jde.init_params(jcfg, jax.random.key(0))
    rng = np.random.default_rng(0)
    it, tt = jcfg.image_tower, jcfg.text_tower
    images = rng.standard_normal(
        (3, it.image_size, it.image_size, it.channels)).astype(np.float32)
    tokens = rng.integers(4, tt.vocab, (3, 16)).astype(np.int32)
    mask = np.arange(16)[None, :] < np.array([[16], [4], [9]])
    return jparams, interop.from_numpy(jax.device_get(jparams), "cpu"), \
        images, tokens, mask


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("impl", ["naive", "pallas"])
def test_encode_image_matches_reference(setup, impl, precision):
    jparams, tparams, images, _, _ = setup
    jcfg, tcfg = _cfgs(impl)
    out_j = jde.encode_image(jcfg, jparams, {"image": jnp.asarray(images)},
                             precision=precision)
    out_t = tde.encode_image(tcfg, tparams, {"image": torch.tensor(images)},
                             precision=precision)
    assert out_t.dtype == torch.float32 and out_t.shape == (3, 32)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                               **TOL[precision])


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("impl", ["naive", "pallas"])
def test_encode_text_matches_reference(setup, impl, precision):
    jparams, tparams, _, tokens, mask = setup
    jcfg, tcfg = _cfgs(impl)
    out_j = jde.encode_text(jcfg, jparams, {"tokens": jnp.asarray(tokens),
                                            "attn_mask": jnp.asarray(mask)},
                            precision=precision)
    out_t = tde.encode_text(tcfg, tparams, {"tokens": torch.tensor(tokens),
                                            "attn_mask": torch.tensor(mask)},
                            precision=precision)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                               **TOL[precision])
    np.testing.assert_allclose(np.linalg.norm(out_t.numpy(), axis=1), 1.0,
                               rtol=1e-5)


def test_tower_encode_unpooled_paths_match(setup):
    """transformer.encode without a mask (plain mean pool) and
    embed_inputs' token path, tower level."""
    jparams, tparams, _, tokens, _ = setup
    jcfg, tcfg = _cfgs("naive")
    out_j = jtf.encode(jcfg.text_tower, jparams["text"]["tower"],
                       {"tokens": jnp.asarray(tokens)})
    out_t = ttf.encode(tcfg.text_tower, tparams["text"]["tower"],
                       {"tokens": torch.tensor(tokens)})
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                               **TOL["f32"])


def test_temperature_and_log_tau(setup):
    jparams, tparams, _, _, _ = setup
    assert float(tde.temperature(tparams)) == pytest.approx(
        float(jde.temperature(jparams)), rel=1e-7)
    fresh = tde.init_params(_cfgs("naive")[1],
                            torch.Generator().manual_seed(0), "cpu")
    assert float(tde.temperature(fresh)) == pytest.approx(0.07, rel=1e-6)


def test_bf16_keeps_fp32_islands(setup):
    _, tparams, images, _, _ = setup
    _, tcfg = _cfgs("flash")
    x32 = tde.encode_image(tcfg, tparams, {"image": torch.tensor(images)},
                           precision="f32")
    x16 = tde.encode_image(tcfg, tparams, {"image": torch.tensor(images)},
                           precision="bf16")
    assert x16.dtype == torch.float32
    assert float((x16 - x32).abs().max()) < 0.05
