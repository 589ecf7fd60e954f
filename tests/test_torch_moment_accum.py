"""Port parity: the paper's §4.2 moment accumulation, the per-microbatch
gradient stream, AdaFactorW's fold of that stream, and the §6 bound terms,
against the JAX reference on the CPU.

- ``core.moment_accum``: every function at the cases of
  ``tests/test_moment_accum.py``, equal to the reference's at rtol 1e-6
  (fp32 sums in the same order).
- ``core.gradaccum.microbatch_grads``: the stream equals the reference's
  at rtol 2e-5 (``tests/test_gradaccum.py:43``, absolute part at each
  leaf's scale), and its mean over K is ``contrastive_step``'s gradient.
- ``AdaFactorW.update_from_microbatches`` at the shapes of
  ``tests/test_optimizer.py:55-73``: updates and slots equal the
  reference's (rtol 1e-5, as ``test_adafactorw_update_matches_reference``).
- ``core.theory``: ``norm_product``, ``bound_terms`` and ``empirical_gap``
  equal the reference's at rtol 1e-6 (the gap, a difference of two ~unit
  fp32 means, at 1e-6 of those means).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import smoke_dual_variant as jax_smoke_dual
from repro.core import gradaccum as jga
from repro.core import moment_accum as jma
from repro.core import theory as jth
from repro.models import dual_encoder as jde
from repro.optim import adafactorw as jopt
from repro_torch import interop
from repro_torch.configs import get_arch, smoke_dual_variant
from repro_torch.core import gradaccum as tga
from repro_torch.core import moment_accum as tma
from repro_torch.core import theory as tth
from repro_torch.data import contrastive_batch, load_tokenizer, \
    world_for_tower
from repro_torch.launch.train import batch_to
from repro_torch.models import dual_encoder as tde
from repro_torch.optim import adafactorw as topt

torch.set_num_threads(1)

GA_RTOL = 2e-5


def _np_stream(seed=0, K=6, shape=(5, 4)):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((K, *shape)).astype(np.float32)}


def _both(tree):
    """A numpy tree as (jax arrays, torch tensors on the CPU)."""
    return (jax.tree.map(jnp.asarray, tree), interop.from_numpy(tree, "cpu"))


def _close(got, ref, rtol=1e-6, atol=1e-7):
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(ref["w"]),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("beta1", [0.9, 0.5])
def test_first_moment_exact_and_matches_reference(beta1):
    c = _np_stream()
    v1 = {"w": np.random.default_rng(1).standard_normal((5, 4)).astype(
        np.float32)}
    (jc, tc), (jv, tv) = _both(c), _both(v1)
    got = tma.accumulate_first_moment(tv, tc, beta1)
    _close(got, jma.accumulate_first_moment(jv, jc, beta1))
    want = beta1 * v1["w"] + (1 - beta1) * c["w"].mean(0)
    np.testing.assert_allclose(got["w"].numpy(), want, rtol=1e-6, atol=1e-7)


def _replica_case():
    rng = np.random.default_rng(2)
    K, R, shape = 8, 4, (6, 3)
    g_true = rng.standard_normal(shape).astype(np.float32)
    d = g_true + rng.standard_normal((K, R, *shape)).astype(np.float32) * 0.5
    return {"w": d.mean(axis=1)}, {"w": d}, R, shape


def test_second_moment_matches_reference_and_correction_reduces_bias():
    c, d, R, shape = _replica_case()
    (jc, tc), (jd, td) = _both(c), _both(d)
    (jv, tv) = _both({"w": np.zeros(shape, np.float32)})
    exact = tma.exact_second_moment(tv, tc, 0.9)
    unc = tma.accumulate_second_moment(tv, tc, 0.9)
    var_hat = tma.replica_variance(td, R)
    cor = tma.accumulate_second_moment(tv, tc, 0.9, var_hat=var_hat)
    jvh = jma.replica_variance(jd, R)
    _close(exact, jma.exact_second_moment(jv, jc, 0.9))
    _close(unc, jma.accumulate_second_moment(jv, jc, 0.9))
    _close(var_hat, jvh)
    _close(cor, jma.accumulate_second_moment(jv, jc, 0.9, var_hat=jvh))
    err_unc = float(torch.mean(torch.abs(unc["w"] - exact["w"])))
    err_cor = float(torch.mean(torch.abs(cor["w"] - exact["w"])))
    assert err_cor < err_unc


def test_uncorrected_overestimates_as_the_reference():
    c = _np_stream(seed=3)
    (jc, tc), (jv, tv) = _both(c), _both({"w": np.zeros((5, 4), np.float32)})
    exact = tma.exact_second_moment(tv, tc, 0.9)
    unc = tma.accumulate_second_moment(tv, tc, 0.9)
    assert bool(torch.all(unc["w"] >= exact["w"] - 1e-7))
    _close(unc, jma.accumulate_second_moment(jv, jc, 0.9))


def test_replica_variance_identity_and_reference():
    rng = np.random.default_rng(4)
    K, R = 200, 8
    d = {"w": rng.standard_normal((K, R, 2)).astype(np.float32)}
    jd, td = _both(d)
    vh = tma.replica_variance(td, R)
    _close(vh, jma.replica_variance(jd, R))
    np.testing.assert_allclose(vh["w"].numpy(),
                               d["w"].mean(axis=1).var(axis=0), rtol=0.35)


@pytest.fixture(scope="module")
def dual():
    jcfg = jax_smoke_dual(jax_get_arch("basic-s"))
    tcfg = smoke_dual_variant(get_arch("basic-s"))
    jparams = jax.device_get(jde.init_params(jcfg, jax.random.key(0)))
    rng = np.random.default_rng(0)
    world = world_for_tower(rng, tcfg.image_tower, n_classes=16)
    batch, _ = contrastive_batch(world, load_tokenizer(), 8, rng)
    return jcfg, tcfg, jparams, batch


def _paths(tree):
    return {p: np.asarray(v, np.float32)
            for p, v in interop.leaves(interop.to_numpy(tree))}


@pytest.mark.parametrize("num_micro", [2, 4])
def test_microbatch_grads_match_reference_stream(dual, num_micro):
    jcfg, tcfg, jparams, batch = dual
    tparams = interop.from_numpy(jparams, "cpu")
    flags = {p: t.requires_grad for p, t in interop.leaves(tparams)}
    loss, metrics, c = tga.microbatch_grads(
        lambda p, im: tde.encode_image(tcfg, p, im),
        lambda p, tx: tde.encode_text(tcfg, p, tx),
        tparams, batch_to(batch, "cpu"), num_micro)
    jloss, _, jc = jga.microbatch_grads(
        lambda p, im: jde.encode_image(jcfg, p, im),
        lambda p, tx: jde.encode_text(jcfg, p, tx),
        jax.tree.map(jnp.asarray, jparams),
        jax.tree.map(jnp.asarray, batch), num_micro)
    assert float(loss) == pytest.approx(float(jloss), rel=1e-6)
    assert "i2t_top1" in metrics
    got, ref = _paths(c), {p: np.asarray(v, np.float32) for p, v in
                           interop.leaves(jax.device_get(jc))}
    assert set(got) == set(ref)
    for path, r in ref.items():
        assert got[path].shape[0] == num_micro
        np.testing.assert_allclose(got[path], r, rtol=GA_RTOL,
                                   atol=GA_RTOL * np.abs(r).max(),
                                   err_msg=path)
    # mean over K is the exact full-batch gradient
    _, _, g = tga.contrastive_step(
        lambda p, im: tde.encode_image(tcfg, p, im),
        lambda p, tx: tde.encode_text(tcfg, p, tx),
        tparams, batch_to(batch, "cpu"), num_micro)
    for path, full in _paths(g).items():
        mean = got[path].mean(axis=0)
        np.testing.assert_allclose(mean, full, rtol=GA_RTOL,
                                   atol=GA_RTOL * np.abs(full).max(),
                                   err_msg=path)
    for path, t in interop.leaves(tparams):
        assert t.requires_grad == flags[path] and t.grad is None, path


def _opt_case(seed=0):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((192, 160)).astype(np.float32),
              "b": rng.standard_normal((160,)).astype(np.float32)}
    gmean = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in params.items()}
    c = {k: (g[None] + 0.01 * rng.standard_normal((4, *g.shape))).astype(
        np.float32) for k, g in gmean.items()}
    return params, c


@pytest.mark.parametrize("store_m_bf16", [False, True])
@pytest.mark.parametrize("with_var_hat", [False, True])
def test_update_from_microbatches_matches_reference(store_m_bf16,
                                                    with_var_hat):
    params, c = _opt_case()
    var_hat = {k: np.full(v.shape[1:], 1e-4, np.float32)
               for k, v in c.items()} if with_var_hat else None
    jo = jopt.AdaFactorW(weight_decay=0.0025, store_m_bf16=store_m_bf16)
    to = topt.AdaFactorW(weight_decay=0.0025, store_m_bf16=store_m_bf16)
    jp, tp = _both(params)
    jc, tc = _both(c)
    jvh, tvh = _both(var_hat) if var_hat else (None, None)
    jstate, tstate = jo.init(jp), to.init(tp)
    for lr in (1e-3, 5e-4):
        jupd, jstate = jo.update_from_microbatches(jc, jstate, jp, lr,
                                                   var_hat=jvh)
        tupd, tstate = to.update_from_microbatches(tc, tstate, tp, lr,
                                                   var_hat=tvh)
        for k in params:
            np.testing.assert_allclose(tupd[k].numpy(),
                                       np.asarray(jupd[k]), rtol=1e-5,
                                       atol=1e-10, err_msg=k)
            for field in ("v_row", "v_col"):
                np.testing.assert_allclose(
                    getattr(tstate, field)[k].numpy(),
                    np.asarray(getattr(jstate, field)[k]), rtol=1e-5,
                    atol=1e-30, err_msg=f"{field}/{k}")
            m_ref = np.asarray(jstate.m[k], np.float32)
            np.testing.assert_allclose(tstate.m[k].float().numpy(), m_ref,
                                       rtol=2 ** -7 if store_m_bf16
                                       else 1e-6, atol=0, err_msg=k)
            assert tstate.m[k].dtype == (torch.bfloat16 if store_m_bf16
                                         else torch.float32)
        assert int(tstate.step) == int(jstate.step)
        jp = jopt.apply_updates(jp, jupd)
        tp = topt.apply_updates(tp, tupd)


def test_update_from_microbatches_first_moment_is_update_s():
    """The first step's first moment is exactly ``update``'s on the mean
    gradient, and the update close to it (tests/test_optimizer.py:55-73)."""
    params, c = _opt_case(1)
    opt = topt.AdaFactorW(weight_decay=0.0, store_m_bf16=False)
    tp = interop.from_numpy(params, "cpu")
    tc = interop.from_numpy(c, "cpu")
    up_ref, st_ref = opt.update({k: v.mean(0) for k, v in tc.items()},
                                opt.init(tp), tp, 1e-3)
    up_mb, st_mb = opt.update_from_microbatches(tc, opt.init(tp), tp, 1e-3)
    for k in params:
        np.testing.assert_allclose(st_mb.m[k].numpy(), st_ref.m[k].numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
        rel = float(torch.mean(torch.abs(up_mb[k] - up_ref[k]))) / (
            float(torch.mean(torch.abs(up_ref[k]))) + 1e-12)
        assert rel < 0.05, (k, rel)


def _theory_params():
    rng = np.random.default_rng(0)
    return {"blocks": [{"w": rng.standard_normal((4, 16, 16))}],
            "proj": rng.standard_normal((16, 8))}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_norm_product_matches_reference(dtype):
    p = jax.tree.map(lambda x: x.astype(dtype), _theory_params())
    got = tth.norm_product(interop.from_numpy(p, "cpu"))
    ref = jth.norm_product(p)
    assert got["depth"] == ref["depth"] == 5
    assert got["log_prod"] == pytest.approx(ref["log_prod"], rel=1e-6)


@pytest.mark.parametrize("m,B", [(1000, 64), (1000, 1024), (16000, 64)])
def test_bound_terms_match_reference(m, B):
    p = _theory_params()
    tp = interop.from_numpy(p, "cpu")
    got = tth.bound_terms(None, tp, tp, m=m, B=B)
    ref = jth.bound_terms(None, p, p, m=m, B=B)
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert got[k] == pytest.approx(v, rel=1e-6), k
    small = tth.bound_terms(None, tp, tp, m=m, B=2 * B,
                            c_consts={"c2": 3.0})
    assert small["term_1_over_sqrt_2B"] < got["term_1_over_sqrt_2B"]
    assert small["term_conf"] == pytest.approx(
        jth.bound_terms(None, p, p, m=m, B=2 * B,
                        c_consts={"c2": 3.0})["term_conf"], rel=1e-6)


def test_empirical_gap_matches_reference():
    rng = np.random.default_rng(1)

    def unit(n, d):
        z = rng.standard_normal((n, d)).astype(np.float32)
        return z / np.linalg.norm(z, axis=1, keepdims=True)

    x, y, xt, yt = unit(256, 16), unit(256, 16), unit(128, 16), \
        unit(128, 16)
    # the gap is the difference of two fp32 means of ~unit size: rtol 1e-6
    # is taken of those terms, so it is an absolute 1e-6 on the gap
    for args in ((x, y, x, y), (x, y, xt, yt)):
        got = tth.empirical_gap(*(torch.from_numpy(a) for a in args))
        ref = jth.empirical_gap(*(jnp.asarray(a) for a in args))
        assert got == pytest.approx(ref, rel=1e-6, abs=1e-6)
    assert abs(tth.empirical_gap(*(torch.from_numpy(a)
                                   for a in (x, y, x, y)))) < 0.2
