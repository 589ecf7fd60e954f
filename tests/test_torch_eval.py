"""Port parity: zero-shot evaluation against the JAX reference on the CPU,
at smoke size, f32.

- ``classification_prompts``: the same arrays; ``classify_ref``: the same
  top-1 ids, ties to the lower class.
- ``classify``, ``evaluate_benchmark`` and ``evaluate_with_service`` on
  the same (converted) weights and the same images: equal predictions and
  rows, logits within 1e-5. The reference's service runs its Pallas kernel
  in interpret mode with a registry in ``tmp_path``, the port's its plain
  version.
- The zero-shot table (``repro_torch.eval.zero_shot_table``): a few steps
  of its recipe from the reference's weights give the reference's three
  rows, computed the reference's way (``benchmarks/zero_shot.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import smoke_dual_variant as jax_smoke_dual
from repro.core.gradaccum import contrastive_step as jax_ga_step
from repro.data import classification_prompts as jax_prompts
from repro.data import contrastive_batch as jax_contrastive_batch
from repro.data import load_tokenizer as jax_load_tokenizer
from repro.data import world_for_tower as jax_world_for_tower
from repro.data.synthetic import render_images as jax_render_images
from repro.eval import zero_shot as jzs
from repro.kernels.similarity_topk.ref import classify_ref as jax_classify_ref
from repro.models import dual_encoder as jde
from repro.optim import AdaFactorW as JaxAdaFactorW
from repro.optim import apply_updates as jax_apply_updates
from repro.serving import ZeroShotService as JaxService
from repro_torch import eval as teval
from repro_torch import interop
from repro_torch.configs import get_arch, smoke_dual_variant
from repro_torch.data import (classification_prompts, load_tokenizer,
                              render_images, world_for_tower)
from repro_torch.eval import zero_shot_table
from repro_torch.kernels.similarity_topk import classify_ref
from repro_torch.models import dual_encoder as tde
from repro_torch.serving import ZeroShotService
from repro_torch.tree import tree_map

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    """Reference and port configs (embed 32), the reference's weights and
    their conversion, a 12-class world and 40 of its images."""
    jcfg = jax_smoke_dual(jax_get_arch("basic-s"))
    tcfg = smoke_dual_variant(get_arch("basic-s"))
    jparams = jde.init_params(jcfg, jax.random.key(0))
    tparams = interop.from_numpy(jax.device_get(jparams), "cpu")
    rng = np.random.default_rng(0)
    world = world_for_tower(rng, tcfg.image_tower, n_classes=12, noise=0.2)
    cls = rng.integers(0, world.n_classes, 40)
    images = render_images(world, cls, rng)
    return jcfg, tcfg, jparams, tparams, world, cls, images


def test_classification_prompts_match_reference():
    tcfg = smoke_dual_variant(get_arch("basic-s"))
    jcfg = jax_smoke_dual(jax_get_arch("basic-s"))
    tworld = world_for_tower(np.random.default_rng(7), tcfg.image_tower,
                             n_classes=30)
    jworld = jax_world_for_tower(np.random.default_rng(7), jcfg.image_tower,
                                 n_classes=30)
    for kw in ({}, {"text_len": 8, "template": "the {} {}"}):
        got = classification_prompts(tworld, load_tokenizer(), **kw)
        ref = jax_prompts(jworld, jax_load_tokenizer(), **kw)
        assert set(got) == set(ref) == {"tokens", "attn_mask"}
        for k in ref:
            assert got[k].dtype == ref[k].dtype
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_classify_ref_matches_reference():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((9, 16)).astype(np.float32)
    c = rng.standard_normal((20, 16)).astype(np.float32)
    c[7] = c[3]          # exact ties go to the lower class id
    x[0] = c[3]
    for inv_tau in (1.0, 1 / 0.07):
        got = classify_ref(torch.from_numpy(x), torch.from_numpy(c), inv_tau)
        ref = np.asarray(jax_classify_ref(jnp.asarray(x), jnp.asarray(c),
                                          inv_tau))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)
    assert int(got[0]) == 3


def test_classify_matches_reference():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((11, 8)).astype(np.float32)
    c = rng.standard_normal((6, 8)).astype(np.float32)
    c[4] = c[1]
    x[2] = c[1]
    pred, logits = teval.classify(torch.from_numpy(x), torch.from_numpy(c))
    jpred, jlogits = jzs.classify(jnp.asarray(x), jnp.asarray(c))
    np.testing.assert_array_equal(pred.numpy(), np.asarray(jpred))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-6, atol=1e-6)
    assert int(pred[2]) == 1


@pytest.mark.parametrize("metric", ["accuracy", "recall"])
def test_evaluate_benchmark_matches_reference(setup, metric):
    jcfg, tcfg, jparams, tparams, world, cls, images = setup
    ref = jzs.evaluate_benchmark(
        lambda im: jde.encode_image(jcfg, jparams,
                                    {"image": jnp.asarray(im)}),
        lambda tx: jde.encode_text(jcfg, jparams, tx),
        jax_load_tokenizer(), world.class_names, images, cls, metric=metric)
    got = teval.evaluate_benchmark(
        lambda im: tde.encode_image(tcfg, tparams,
                                    {"image": torch.from_numpy(im)}),
        lambda tx: tde.encode_text(tcfg, tparams, tree_map(
            torch.from_numpy, tx)),
        load_tokenizer(), world.class_names, images, cls, metric=metric)
    assert got == ref
    assert got["headline"] == (got["top1"] if metric == "accuracy"
                               else got["mean_per_class_recall"])


def test_evaluate_with_service_matches_reference(setup, tmp_path):
    jcfg, tcfg, jparams, tparams, world, cls, images = setup
    with JaxService(jcfg, jparams, jax_load_tokenizer(),
                    registry_dir=str(tmp_path), max_delay_ms=1.0,
                    interpret=True) as js:
        ref = jzs.evaluate_with_service(js, world.class_names, images, cls)
    with ZeroShotService(tcfg, tparams, load_tokenizer(), device="cpu",
                         max_delay_ms=1.0) as ts:
        got = teval.evaluate_with_service(ts, world.class_names, images, cls)
        again = teval.evaluate_with_service(ts, world.class_names, images,
                                            cls, metric="recall")
        stats = ts.stats()
    assert got == ref
    assert again["headline"] == got["mean_per_class_recall"]
    assert stats["registry"] == {"mem_hits": 1, "disk_hits": 0,
                                 "computes": 1, "index_hits": 0,
                                 "index_builds": 0}
    # the served row and the materialised row agree on the same weights
    bench = teval.evaluate_benchmark(
        lambda im: tde.encode_image(tcfg, tparams,
                                    {"image": torch.from_numpy(im)}),
        lambda tx: tde.encode_text(tcfg, tparams, tree_map(
            torch.from_numpy, tx)),
        load_tokenizer(), world.class_names, images, cls)
    for k in ("top1", "top5", "mean_per_class_recall", "n"):
        assert got[k] == bench[k], k


def _jax_tiny_dual_cfg():
    """``benchmarks/common.py:tiny_dual_cfg`` on the reference."""
    return jax_smoke_dual(jax_get_arch("basic-s"), embed_dim=32)


def _jax_bench_world(cfg):
    """``benchmarks/common.py:world_and_tok(cfg, n_classes=24)``'s world and
    tokenizer on the reference."""
    world = jax_world_for_tower(np.random.default_rng(0), cfg.image_tower,
                                n_classes=24, noise=0.25)
    return world, jax_load_tokenizer()


def _reference_table(jparams, steps):
    """``benchmarks/zero_shot.py:run``'s rows, computed its way with
    ``steps`` training steps from ``jparams``."""
    cfg = _jax_tiny_dual_cfg()
    world, tok = _jax_bench_world(cfg)
    seen, unseen = np.arange(16), np.arange(16, 24)
    opt = JaxAdaFactorW()
    st = opt.init(jparams)
    enc_i = lambda p, im: jde.encode_image(cfg, p, im)   # noqa: E731
    enc_t = lambda p, tx: jde.encode_text(cfg, p, tx)    # noqa: E731

    @jax.jit
    def step(params, st, batch):
        _, _, g = jax_ga_step(enc_i, enc_t, params, batch, 2)
        up, st = opt.update(g, st, params, 2e-3)
        return jax_apply_updates(params, up), st

    rng = np.random.default_rng(11)
    params = jparams
    for _ in range(steps):
        batch, _ = jax_contrastive_batch(world, tok, 32, rng, classes=seen)
        params, st = step(params, st, jax.tree.map(jnp.asarray, batch))
    temb = np.asarray(enc_t(params, jax.tree.map(
        jnp.asarray, jax_prompts(world, tok))))

    def acc_on(pool, noise_mult=1.0):
        c = pool[rng.integers(0, len(pool), 128)]
        old = world.noise
        world.noise = old * noise_mult
        imgs = jax_render_images(world, c, rng)
        world.noise = old
        iemb = np.asarray(enc_i(params, {"image": jnp.asarray(imgs)}))
        return float(np.mean(np.argmax(iemb @ temb.T, axis=1) == c))

    return {"seen": acc_on(seen), "unseen_openvocab": acc_on(unseen),
            "shifted_robustness": acc_on(seen, 2.0)}


def test_zero_shot_table_matches_reference():
    jparams = jde.init_params(_jax_tiny_dual_cfg(), jax.random.key(3))
    ref = _reference_table(jparams, steps=4)
    got = zero_shot_table.run(
        "cpu", steps=4, attn="naive",
        params=interop.from_numpy(jax.device_get(jparams), "cpu"))
    for name, top1 in ref.items():
        assert got[name] == top1, name
    lines = zero_shot_table.csv_lines(got)
    assert [ln.split(",")[0] for ln in lines] == [
        "zeroshot/seen", "zeroshot/unseen_openvocab",
        "zeroshot/shifted_robustness"]
    assert all(ln.endswith(";chance=0.042") for ln in lines)
    assert 0.0 <= got["unseen_openvocab"] <= 1.0 and got["us"] > 0


def test_zero_shot_table_copies_its_bench_helpers():
    cfg = zero_shot_table.tiny_dual_cfg()
    assert cfg == smoke_dual_variant(get_arch("basic-s"), embed_dim=32)
    assert cfg.embed_dim == _jax_tiny_dual_cfg().embed_dim == 32
    jw, jtok = _jax_bench_world(_jax_tiny_dual_cfg())
    tw, tok, _ = zero_shot_table.world_and_tok(cfg, n_classes=24)
    np.testing.assert_array_equal(tw.concept_vecs, jw.concept_vecs)
    np.testing.assert_array_equal(tw.camera, jw.camera)
    assert tw.class_names == jw.class_names and tw.noise == jw.noise == 0.25
    assert tok.vocab_size == jtok.vocab_size
