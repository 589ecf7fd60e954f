"""Port parity: the contrastive training path against the JAX reference on
the CPU, at smoke size (``smoke_dual_variant``: 2 layers per tower,
d <= 256, 16 patches).

- GradAccum (Algorithm 1): the port's ``contrastive_step`` equals the
  reference's gradient and the port's own monolithic gradient for
  ``num_micro`` in {1, 2, 4} (rtol 2e-5, tests/test_gradaccum.py:43), and
  once on the kernel path (flash attention, fused loss; their plain
  versions here) against the reference's Pallas path in interpret mode.
- Remat: every policy gives the same gradients.
- AdaFactorW: updates and state match the reference leaf by leaf.
- Schedules, the non-finite step guard, the step factory's first losses
  against the reference's, the trainer's command line, and the synthetic
  batches (one seed, the same arrays in both packages).

The reference's weights cross over through ``repro_torch.interop``; inputs
come from numpy with a seed.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import smoke_dual_variant as jax_smoke_dual
from repro.core import contrastive as jcl
from repro.core import gradaccum as jga
from repro.data import contrastive_batch as jax_contrastive_batch
from repro.data import jft_batch as jax_jft_batch
from repro.data import load_tokenizer as jax_load_tokenizer
from repro.data import world_for_tower as jax_world_for_tower
from repro.launch import steps as jsteps
from repro.models import dual_encoder as jde
from repro.optim import adafactorw as jopt
from repro.optim import schedules as jsched
from repro_torch import interop
from repro_torch.configs import get_arch, smoke_dual_variant
from repro_torch.core import contrastive as tcl
from repro_torch.core import gradaccum as tga
from repro_torch.core import remat
from repro_torch.data import (contrastive_batch, jft_batch, load_tokenizer,
                              world_for_tower)
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import dual_encoder as tde
from repro_torch.optim import adafactorw as topt
from repro_torch.optim import schedules as tsched
from repro_torch.tree import tree_map

torch.set_num_threads(1)

# rtol 2e-5, the reference's GradAccum tolerance (tests/test_gradaccum.py:43),
# with the absolute part taken at each leaf's scale: an fp32 gradient summed
# in another order (microbatches against the whole batch, XLA against
# PyTorch) carries an absolute error that scales with the leaf's largest
# entries, not with each element
GA_RTOL = 2e-5


def _with_attn(cfg, attn):
    return dataclasses.replace(
        cfg, image_tower=dataclasses.replace(cfg.image_tower, attn_impl=attn),
        text_tower=dataclasses.replace(cfg.text_tower, attn_impl=attn))


@pytest.fixture(scope="module")
def setup():
    """Reference params (numpy), the same params in the port, and a numpy
    contrastive batch of 8 pairs drawn from the port's synthetic world."""
    jcfg = jax_smoke_dual(jax_get_arch("basic-s"))
    jparams = jax.device_get(jde.init_params(jcfg, jax.random.key(0)))
    tcfg = smoke_dual_variant(get_arch("basic-s"))
    rng = np.random.default_rng(0)
    world = world_for_tower(rng, tcfg.image_tower, n_classes=16)
    batch, _ = contrastive_batch(world, load_tokenizer(), 8, rng)
    return jcfg, tcfg, jparams, batch


def _jax_batch(batch):
    return jax.tree.map(jnp.asarray, batch)


def _torch_batch(batch):
    return ttrain.batch_to(batch, "cpu")


def _jax_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): np.asarray(leaf, np.float32)
            for path, leaf in flat}


def _port_paths(tree):
    return {p: np.asarray(v, np.float32)
            for p, v in interop.leaves(interop.to_numpy(tree))}


def _assert_trees_close(got, ref, **tol):
    assert set(got) == set(ref)
    for path in ref:
        np.testing.assert_allclose(got[path], ref[path], err_msg=path, **tol)


def _assert_grads_close(got, ref):
    assert set(got) == set(ref)
    for path, r in ref.items():
        np.testing.assert_allclose(got[path], r, rtol=GA_RTOL,
                                   atol=GA_RTOL * np.abs(r).max(),
                                   err_msg=path)


def _jax_ga(jcfg, jparams, batch, num_micro, attn="naive", fused=False):
    cfg = _with_attn(jcfg, attn)
    loss_fn = jcl.fused_kernel_loss if fused else jcl.contrastive_loss
    loss, _, grads = jga.contrastive_step(
        lambda p, im: jde.encode_image(cfg, p, im),
        lambda p, tx: jde.encode_text(cfg, p, tx),
        jax.tree.map(jnp.asarray, jparams), _jax_batch(batch), num_micro,
        loss_fn=loss_fn)
    return float(loss), _jax_paths(grads)


def _port_ga(tcfg, tparams, batch, num_micro, attn="naive", fused=False,
             policy=None, **kw):
    cfg = _with_attn(tcfg, attn)
    loss_fn = tcl.fused_kernel_loss if fused else tcl.contrastive_loss
    loss, _, grads = tga.contrastive_step(
        lambda p, im: tde.encode_image(cfg, p, im, remat_policy=policy),
        lambda p, tx: tde.encode_text(cfg, p, tx, remat_policy=policy),
        tparams, _torch_batch(batch), num_micro, loss_fn=loss_fn, **kw)
    return float(loss), _port_paths(grads)


@pytest.mark.parametrize("num_micro", [1, 2, 4])
def test_gradaccum_matches_reference_and_monolithic(setup, num_micro):
    jcfg, tcfg, jparams, batch = setup
    tparams = interop.from_numpy(jparams, "cpu")
    loss, grads = _port_ga(tcfg, tparams, batch, num_micro)
    ref_loss, ref = _jax_ga(jcfg, jparams, batch, num_micro)
    assert loss == pytest.approx(ref_loss, rel=1e-6)
    _assert_grads_close(grads, ref)

    # the port's monolithic gradient: autograd of the full-batch loss
    leaves = [p.requires_grad_() for _, p in interop.leaves(tparams)]
    tb = _torch_batch(batch)
    mono, _ = tcl.contrastive_loss(
        tde.encode_image(tcfg, tparams, tb["images"]),
        tde.encode_text(tcfg, tparams, tb["texts"]),
        torch.exp(tparams["log_tau"]))
    g = torch.autograd.grad(mono, leaves, allow_unused=True)  # lm_head
    assert loss == pytest.approx(float(mono.detach()), rel=1e-6)
    _assert_grads_close(grads, {
        path: np.zeros(p.shape, np.float32) if x is None else x.numpy()
        for (path, p), x in zip(interop.leaves(tparams), g)})


def test_gradaccum_on_the_kernel_path_matches_reference(setup):
    """attn 'flash' + fused loss in the port (their plain versions on the
    CPU) against the reference's 'pallas' + fused kernels (interpret)."""
    jcfg, tcfg, jparams, batch = setup
    loss, grads = _port_ga(tcfg, interop.from_numpy(jparams, "cpu"), batch,
                           2, attn="flash", fused=True)
    ref_loss, ref = _jax_ga(jcfg, jparams, batch, 2, attn="pallas",
                            fused=True)
    assert loss == pytest.approx(ref_loss, rel=1e-6)
    _assert_grads_close(grads, ref)


def test_gradaccum_refuses_what_waits_for_later_slices(setup):
    """``emb_sharding`` (the cross-shard loss's layout) is taken since the
    distributed slice and pins nothing: the step is unchanged with it."""
    from repro_torch.core import distributed_loss
    from repro_torch.launch.mesh import make_local_mesh
    _, tcfg, jparams, batch = setup
    shd = distributed_loss.emb_sharding(make_local_mesh())
    assert shd == ("data", None)
    loss, grads = _port_ga(tcfg, interop.from_numpy(jparams, "cpu"), batch,
                           2)
    loss_s, grads_s = _port_ga(tcfg, interop.from_numpy(jparams, "cpu"),
                               batch, 2, emb_sharding=shd)
    assert loss_s == loss
    assert grads_s.keys() == grads.keys()
    for path, g in grads.items():
        np.testing.assert_array_equal(grads_s[path], g, err_msg=path)
    with pytest.raises(ValueError, match="multiple"):
        tga.contrastive_step(None, None, {}, _torch_batch(batch), 3)


def test_every_remat_policy_gives_the_same_gradients(setup):
    from repro.core import remat as jremat
    assert remat.list_policies() == jremat.list_policies()
    assert remat.get_policy("off") is None and remat.get_policy(None) is None
    _, tcfg, jparams, batch = setup
    tparams = interop.from_numpy(jparams, "cpu")
    _, ref = _port_ga(tcfg, tparams, batch, 2, attn="flash")
    for name in remat.list_policies():
        _, got = _port_ga(tcfg, tparams, batch, 2, attn="flash",
                          policy=remat.get_policy(name))
        _assert_trees_close(got, ref, rtol=1e-6, atol=1e-9)


def _grads_like(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: (rng.standard_normal(np.shape(p)) * 1e-2).astype(
            np.float32), params)


def test_adafactorw_update_matches_reference(setup):
    """Two updates (the second reads the bf16 first moment) on the
    reference's params and grads: updates, m (bf16), factored rows and
    columns and the unfactored second moments, leaf by leaf. The state
    crosses both ways through interop."""
    _, _, jparams, _ = setup
    jo = jopt.AdaFactorW(weight_decay=0.0025)
    to = topt.AdaFactorW(weight_decay=0.0025)
    jstate = jo.init(jax.tree.map(jnp.asarray, jparams))
    tstate = interop.opt_state_from_numpy(jax.device_get(jstate), "cpu")
    tparams = interop.from_numpy(jparams, "cpu")
    assert tstate.m["text"]["proj"].dtype == torch.bfloat16
    factored = jstate.v_col["text"]["tower"]["embed"]
    assert factored.shape == (256,)              # (512, 256) is factored
    assert jstate.v_col["log_tau"].shape == ()   # a scalar is not
    jp = jax.tree.map(jnp.asarray, jparams)
    for step, lr in ((0, 1e-3), (1, 5e-4)):
        grads = _grads_like(jparams, seed=step)
        jupd, jstate = jo.update(jax.tree.map(jnp.asarray, grads), jstate,
                                 jp, lr)
        tupd, tstate = to.update(interop.from_numpy(grads, "cpu"), tstate,
                                 tparams, lr)
        _assert_trees_close(_port_paths(tupd), _jax_paths(jupd), rtol=1e-5,
                            atol=1e-10)
        back = interop.opt_state_to_numpy(tstate)
        assert int(back.step) == int(jstate.step) == step + 1
        for field in ("v_row", "v_col"):
            _assert_trees_close(_port_paths(getattr(tstate, field)),
                                _jax_paths(getattr(jstate, field)),
                                rtol=1e-5, atol=1e-30)
        # m is stored in bf16: both round the same fp32 moment; a crossing
        # of a rounding boundary moves it by one bf16 ulp (2^-7 relative)
        _assert_trees_close(dict(interop.leaves(back.m)),
                            _jax_paths(jstate.m), rtol=2 ** -7, atol=0)
        jp = jopt.apply_updates(jp, jupd)
        tparams = topt.apply_updates(tparams, tupd)
    _assert_trees_close(_port_paths(tparams), _jax_paths(jp), rtol=1e-6,
                        atol=1e-9)


@pytest.mark.parametrize("name", ["warmup_cosine", "warmup_linear"])
def test_schedules_match_reference(name):
    for args in ((1e-3, 1e-5, 10, 100), (3e-4, 0.0, 1, 7), (1.0, 0.1, 0, 5)):
        tf_, jf = getattr(tsched, name)(*args), getattr(jsched, name)(*args)
        for step in range(args[3] + 3):
            # fp32 rounding at the schedule's scale: near the end of the
            # cosine, 1 + cos(pi t) cancels
            assert float(tf_(step)) == pytest.approx(
                float(jf(step)), rel=1e-6, abs=1e-6 * args[0])


def test_skip_guard_keeps_state_on_a_poisoned_batch(setup):
    _, tcfg, jparams, batch = setup
    step, opt = tsteps.make_contrastive_step(
        tcfg, num_micro=2, precision="f32", loss="local",
        skip_nonfinite=True)
    params = interop.from_numpy(jparams, "cpu")
    state = opt.init(params)
    bad = tree_map(torch.clone, _torch_batch(batch))
    bad["images"]["image"][3, 0, 0, 0] = float("nan")
    new_p, new_s, loss, metrics = step(params, state, bad)
    assert not math.isfinite(float(loss))
    assert int(metrics["skipped"]) == 1
    assert not math.isfinite(float(metrics["grad_norm"]))
    for (path, a), (_, b) in zip(interop.leaves(new_p),
                                 interop.leaves(params)):
        assert torch.equal(a, b), path
    for new, old in zip(new_s[1:], state[1:]):
        for (path, a), (_, b) in zip(interop.leaves(new),
                                     interop.leaves(old)):
            assert torch.equal(a, b), path
    new_p, _, loss, metrics = step(params, state, _torch_batch(batch))
    assert math.isfinite(float(loss)) and int(metrics["skipped"]) == 0
    assert not torch.equal(new_p["text"]["proj"], params["text"]["proj"])


def test_step_factory_tracks_reference_losses(setup):
    """Three steps of ``make_contrastive_step`` (f32, local loss, remat
    basic, 2 microbatches) from the shared weights and batches: the losses
    track the reference's."""
    jcfg, tcfg, jparams, _ = setup
    rng = np.random.default_rng(1)
    world = world_for_tower(rng, tcfg.image_tower, n_classes=16)
    tok = load_tokenizer()
    batches = [contrastive_batch(world, tok, 8, rng)[0] for _ in range(3)]
    kw = dict(num_micro=2, precision="f32", loss="local", remat="basic",
              lr=1e-3)
    jstep, jo = jsteps.make_contrastive_step(jcfg, **kw)
    tstep, to = tsteps.make_contrastive_step(tcfg, **kw)
    jp = jax.tree.map(jnp.asarray, jparams)
    js = jo.init(jp)
    tp = interop.from_numpy(jparams, "cpu")
    ts = to.init(tp)
    jstep = jax.jit(jstep)
    for b in batches:
        jp, js, jl, _ = jstep(jp, js, _jax_batch(b))
        tp, ts, tl, _ = tstep(tp, ts, _torch_batch(b))
        assert float(tl) == pytest.approx(float(jl), rel=1e-4)


def test_step_factory_refuses_the_distributed_losses(setup):
    """The cross-shard losses need a mesh (since the distributed slice;
    tests/test_torch_train_distributed.py runs them)."""
    _, tcfg, _, _ = setup
    for loss in ("allgather", "chunked"):
        with pytest.raises(ValueError, match="needs a mesh"):
            tsteps.make_contrastive_step(tcfg, loss=loss)
    with pytest.raises(ValueError, match="unknown loss"):
        tsteps.make_contrastive_step(tcfg, loss="nope")


def test_trainer_runs_on_the_cpu_when_asked(capsys):
    rep = ttrain.main(["--mode", "contrastive", "--arch", "basic-s",
                       "--smoke", "--device", "cpu", "--steps", "3",
                       "--batch", "8", "--num-micro", "2"])
    out = capsys.readouterr().out
    assert len(rep["losses"]) == 3
    assert all(math.isfinite(v) for v in rep["losses"])
    assert out.count("contrastive step") == 3
    assert "pairs/s" in out and "steps/s" in out
    assert rep["device"] == "cpu"


def test_trainer_raises_without_a_card_or_for_later_slices():
    if torch.cuda.is_available():
        pytest.skip("checks the card-less host")
    argv = ["--mode", "contrastive", "--arch", "basic-s", "--smoke",
            "--steps", "1", "--batch", "4", "--num-micro", "2"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(argv)
    # LM training runs now, on the card unless asked for the CPU
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--mode", "lm", "--arch", "llama3.2-1b", "--smoke",
                     "--steps", "1", "--batch", "2", "--seq", "16"])
    # phase 1 runs now, on the card unless asked for the CPU
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(["--mode", "pretrain", "--arch", "basic-s", "--smoke",
                     "--steps", "1", "--batch", "4"])
    # checkpoints are ported: --ckpt-dir saves on the CPU when asked, and
    # without a card the run still raises before it trains or saves
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(argv + ["--ckpt-dir", "x"])


def test_synthetic_batches_match_reference():
    tcfg = smoke_dual_variant(get_arch("basic-s"))
    jcfg = jax_smoke_dual(jax_get_arch("basic-s"))
    trng, jrng = np.random.default_rng(5), np.random.default_rng(5)
    tworld = world_for_tower(trng, tcfg.image_tower, n_classes=40)
    jworld = jax_world_for_tower(jrng, jcfg.image_tower, n_classes=40)
    tb, tcls = contrastive_batch(tworld, load_tokenizer(), 12, trng)
    jb, jcls = jax_contrastive_batch(jworld, jax_load_tokenizer(), 12, jrng)
    np.testing.assert_array_equal(tcls, jcls)
    for path, ref in _jax_paths(jb).items():
        np.testing.assert_array_equal(dict(interop.leaves(
            tree_map(np.asarray, tb)))[path], ref, err_msg=path)
    tj, _ = jft_batch(tworld, 6, trng, classes=np.arange(5, 9))
    jj, _ = jax_jft_batch(jworld, 6, jrng, classes=np.arange(5, 9))
    np.testing.assert_array_equal(tj["image"], jj["image"])
    np.testing.assert_array_equal(tj["labels"], jj["labels"])


def test_caption_corpora_match_reference():
    """``caption_corpus`` draws the reference's captions from one seed, and
    ``grammar_corpus`` lists the reference's grammar in its order."""
    from repro.data import synthetic as jsyn
    from repro_torch.data import synthetic as tsyn
    tcfg = smoke_dual_variant(get_arch("basic-s"))
    jcfg = jax_smoke_dual(jax_get_arch("basic-s"))
    trng, jrng = np.random.default_rng(9), np.random.default_rng(9)
    tworld = world_for_tower(trng, tcfg.image_tower, n_classes=30)
    jworld = jax_world_for_tower(jrng, jcfg.image_tower, n_classes=30)
    got = tsyn.caption_corpus(tworld, trng, n=50)
    assert got == jsyn.caption_corpus(jworld, jrng, n=50)
    assert len(set(got)) > 1
    assert tsyn.grammar_corpus() == jsyn.grammar_corpus()
