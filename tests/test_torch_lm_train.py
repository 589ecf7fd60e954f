"""Port parity: LM training against the JAX reference on the CPU, at smoke
size (``smoke_variant``: 2 layers, d 256, 4 query heads over 2 kv heads,
a sliding window of 64; Mamba-2 with state 16 in chunks of 32).

- ``transformer.lm_loss`` and its gradients against ``jax.value_and_grad``
  of the reference's ``lm_loss``, for llama3.2-1b (naive attention and
  the flash path, here its plain version: causal, windowed, grouped-query)
  and mamba2-130m, with and without ``loss_mask``: the loss at rtol 2e-5
  and every gradient leaf at rtol 2e-5 with the absolute part at the
  leaf's largest entry (the reference's GradAccum tolerance,
  tests/test_gradaccum.py:43).
- ``make_train_step`` against the reference's: bf16 at the reference's
  bf16 tolerances (tests/test_fused_contrastive.py:82-87, 2e-2), and f32
  with each leaf's update within 1e-3 of its size.
- ``run_lm`` for 3 steps from the reference's ``init_params(cfg,
  key(seed))`` against the reference's own ``run_lm``: losses at rel 1e-4,
  params per leaf within 1e-3 of the change training made (the rule of
  tests/test_torch_recipe.py: both store the first moment in bf16); its
  ``--ckpt-dir`` checkpoint read back by the reference.
- ``synthetic_inputs`` draws the reference's batches from one seed;
  ``applicable_shapes``, ``input_specs``, ``abstract_params`` and
  ``abstract_opt_state`` give the reference's shapes and dtypes; the
  prefill and decode step factories match the reference's.

The reference's losses are read where its loop reads them: its module's
``float`` is wrapped to record each value it converts.
"""
import builtins
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs import base as jbase
from repro.configs import get_arch as jax_get_arch
from repro.configs import smoke_variant as jax_smoke_variant
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import frontends as jfe
from repro.models import transformer as jtf
from repro_torch import checkpoint as ckpt
from repro_torch import interop
from repro_torch.configs import (INPUT_SHAPES, applicable_shapes, get_arch,
                                 list_archs, smoke_variant)
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import frontends as tfe
from repro_torch.models import transformer as ttf
from repro_torch.tree import leaves

torch.set_num_threads(1)

GA_RTOL = 2e-5
BF16_TOL = 2e-2
# sequence lengths: past llama's smoke window (64), two Mamba-2 chunks
SEQ = {"llama3.2-1b": 80, "mamba2-130m": 64}


def _setup(arch):
    """(arch, reference cfg, port cfg, reference params as numpy, the same
    params in the port, a numpy token batch (2, SEQ[arch]))."""
    jcfg = jax_smoke_variant(jax_get_arch(arch))
    tcfg = smoke_variant(get_arch(arch))
    jparams = jax.device_get(jtf.init_params(jcfg, jax.random.key(0)))
    toks = np.random.default_rng(0).integers(
        0, jcfg.vocab, (2, SEQ[arch])).astype(np.int32)
    return arch, jcfg, tcfg, jparams, interop.from_numpy(jparams, "cpu"), \
        toks


@pytest.fixture(scope="module", params=["llama3.2-1b", "mamba2-130m"])
def lm(request):
    return _setup(request.param)


@pytest.fixture(scope="module")
def reference_grads():
    """The reference's (setup, loss, metrics, gradients) by (arch,
    masked), computed once for every attention backend of the port."""
    memo = {}

    def get(arch, masked):
        if (arch, masked) not in memo:
            setup = _setup(arch)
            jcfg, jparams, toks = setup[1], setup[3], setup[5]
            jbatch = {"tokens": jnp.asarray(toks)}
            if masked:
                jbatch["loss_mask"] = jnp.asarray(_loss_mask(toks))
            (jl, jm), jg = jax.value_and_grad(
                lambda p: jtf.lm_loss(jcfg, p, jbatch), has_aux=True)(
                    jax.tree.map(jnp.asarray, jparams))
            memo[arch, masked] = setup, jl, jm, jg
        return memo[arch, masked]
    return get


def _paths(tree):
    return {p: np.asarray(v, np.float32)
            for p, v in leaves(interop.to_numpy(tree))}


def _ref_paths(tree):
    return {p: np.asarray(v, np.float32)
            for p, v in leaves(jax.device_get(tree))}


def _assert_grads_close(got, ref):
    assert set(got) == set(ref)
    for path, r in ref.items():
        np.testing.assert_allclose(got[path], r, rtol=GA_RTOL,
                                   atol=GA_RTOL * np.abs(r).max(),
                                   err_msg=path)


def _assert_change_close(got, ref, init, rtol):
    """Per leaf, ||got - ref|| <= rtol·||ref - init||: the gap held
    against the change training made (tests/test_torch_recipe.py's rule
    for chained params)."""
    assert set(got) == set(ref)
    for path, r in ref.items():
        gap = np.linalg.norm(got[path] - r)
        assert gap <= rtol * np.linalg.norm(r - init[path]), path


def _loss_mask(toks):
    m = np.ones(toks.shape, bool)
    m[0, : toks.shape[1] // 3] = False      # a masked prompt
    m[1, -5:] = False                       # masked padding
    return m


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("arch,attn", [("llama3.2-1b", "naive"),
                                       ("llama3.2-1b", "pallas"),
                                       ("mamba2-130m", "naive")])
def test_lm_loss_and_grads_match_reference(reference_grads, arch, attn,
                                           masked):
    (_, _, tcfg, _, tparams, toks), jl, jm, jg = reference_grads(arch,
                                                                 masked)
    tbatch = {"tokens": torch.from_numpy(toks)}
    if masked:
        tbatch["loss_mask"] = torch.from_numpy(_loss_mask(toks))
    cfg = dataclasses.replace(tcfg, attn_impl=attn)
    loss, metrics, grads = tsteps.value_and_grad(
        lambda p: ttf.lm_loss(cfg, p, tbatch), tparams)
    assert float(loss) == pytest.approx(float(jl), rel=GA_RTOL)
    assert float(metrics["xent"]) == pytest.approx(float(jm["xent"]),
                                                   rel=GA_RTOL)
    assert float(metrics["aux"]) == float(jm["aux"]) == 0.0
    _assert_grads_close(_paths(grads), _ref_paths(jg))
    # the scan's plain version carries gradients into every mixer leaf
    assert all(np.abs(g).max() > 0 for g in _paths(grads).values())


def test_lm_loss_runs_the_encoder_family_s_masked_frame_loss():
    """The encoder family's loss is the masked-frame cross-entropy, also
    for a token tower (BASIC-S's text tower): its embeddings of
    ``tokens``, then the targets where ``mask`` is set, as the
    reference's ``lm_loss`` computes it."""
    jenc = jax_smoke_variant(jax_get_arch("basic-s").text_tower)
    enc = smoke_variant(get_arch("basic-s").text_tower)
    jparams = jax.device_get(jtf.init_params(jenc, jax.random.key(2)))
    rng = np.random.default_rng(2)
    batch = {"tokens": rng.integers(0, enc.vocab, (2, 16)).astype(np.int32),
             "targets": rng.integers(0, enc.vocab, (2, 16)).astype(np.int32),
             "mask": rng.random((2, 16)) < 0.3}
    jl, _ = jtf.lm_loss(jenc, jax.tree.map(jnp.asarray, jparams),
                        jax.tree.map(jnp.asarray, batch))
    loss, metrics = ttf.lm_loss(enc, interop.from_numpy(jparams, "cpu"),
                                interop.from_numpy(batch, "cpu"))
    assert float(loss) == pytest.approx(float(jl), rel=GA_RTOL)
    assert float(metrics["aux"]) == 0.0
    assert ttf.period_of(smoke_variant(get_arch("llama3.2-1b"))) == 1


def test_make_train_step_bf16_matches_reference(lm):
    arch, jcfg, tcfg, jparams, tparams, toks = lm
    jstep, jopt = jsteps.make_train_step(jcfg, remat="basic",
                                         moe_args={"dispatch": "dense"})
    jp = jax.tree.map(jnp.asarray, jparams)
    jnew, jst, jl, _ = jax.jit(jstep)(jp, jopt.init(jp),
                                      {"tokens": jnp.asarray(toks)})
    step, opt = tsteps.make_train_step(tcfg)
    new, st, loss, metrics = step(tparams, opt.init(tparams),
                                  {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(loss), float(jl), rtol=BF16_TOL,
                               atol=BF16_TOL)
    got, ref = _paths(new), _ref_paths(jnew)
    assert set(got) == set(ref)
    for path, r in ref.items():
        np.testing.assert_allclose(got[path], r, atol=BF16_TOL,
                                   err_msg=path)
    assert int(st.step) == int(jst.step) == 1
    assert st.m["final_norm"].dtype == torch.bfloat16
    # the input params are left as they were
    assert all(torch.equal(a, torch.from_numpy(np.array(b)))
               for (_, a), (_, b) in zip(leaves(tparams), leaves(jparams)))


def test_make_train_step_f32_matches_reference(lm):
    arch, jcfg, tcfg, jparams, tparams, toks = lm
    jstep, jopt = jsteps.make_train_step(jcfg, remat="basic",
                                         precision="f32",
                                         moe_args={"dispatch": "dense"})
    jp = jax.tree.map(jnp.asarray, jparams)
    jnew, _, jl, _ = jax.jit(jstep)(jp, jopt.init(jp),
                                    {"tokens": jnp.asarray(toks)})
    step, opt = tsteps.make_train_step(tcfg, precision="f32")
    new, _, loss, _ = step(tparams, opt.init(tparams),
                           {"tokens": torch.from_numpy(toks)})
    assert float(loss) == pytest.approx(float(jl), rel=GA_RTOL)
    _assert_change_close(_paths(new), _ref_paths(jnew), _ref_paths(jparams),
                         1e-3)


def _record_reference_floats(monkeypatch) -> list:
    seen = []

    def rec(x):
        v = builtins.float(x)
        seen.append(v)
        return v
    monkeypatch.setattr(jtrain, "float", rec, raising=False)
    return seen


def test_run_lm_matches_reference(lm, tmp_path, monkeypatch):
    arch, jcfg, tcfg, jparams, tparams, toks = lm
    args = ttrain.parse_args([
        "--mode", "lm", "--arch", arch, "--smoke", "--device", "cpu",
        "--steps", "3", "--batch", "2", "--seq", str(SEQ[arch]),
        "--log-every", "1", "--seed", "0", "--ckpt-dir",
        str(tmp_path / "port")])
    rep = ttrain.run_lm(args, params_init=tparams)
    seen = _record_reference_floats(monkeypatch)
    ref = jax.device_get(jtrain.run_lm(_ref_args(args, tmp_path)))
    assert rep["losses"] == pytest.approx(seen, rel=1e-4)
    assert all(math.isfinite(v) for v in rep["losses"])
    got, want = _paths(rep["params"]), _ref_paths(ref)
    _assert_change_close(got, want, _ref_paths(jparams), 1e-3)
    # the input is a copy: the caller's weights are left as they were
    assert torch.equal(tparams["final_norm"],
                       torch.from_numpy(np.array(jparams["final_norm"])))
    # both trainers saved their params at step 3; the reference restores
    # the port's bit for bit
    assert rep["ckpt_path"].endswith("step_00000003")
    assert jckpt.latest_verified_step(str(tmp_path / "port")) == 3
    back = jckpt.restore(str(tmp_path / "port"), 3,
                         jax.eval_shape(lambda: ref))
    for path, arr in leaves(jax.device_get(back)):
        np.testing.assert_array_equal(arr, got[path], err_msg=path)
    assert ckpt.verify(str(tmp_path / "ref"), 3)["n"] == len(got)


def _ref_args(args, tmp_path):
    """The same namespace for the reference's run_lm, saving apart."""
    import argparse
    ns = argparse.Namespace(**vars(args))
    ns.ckpt_dir = str(tmp_path / "ref")
    return ns


def test_lm_command_line(capsys):
    rep = ttrain.main(["--mode", "lm", "--arch", "llama3.2-1b", "--smoke",
                       "--device", "cpu", "--steps", "2", "--batch", "2",
                       "--seq", "16"])
    out = capsys.readouterr().out
    assert len(rep["losses"]) == 2 and rep["device"] == "cpu"
    assert "tokens/s" in out and rep["tokens_per_s"] > 0
    for flag in (["--precision", "bf16"], ["--remat", "basic"]):
        with pytest.raises(SystemExit):
            ttrain.parse_args(["--mode", "lm", "--arch", "llama3.2-1b",
                               *flag])
    assert "takes no --remat" in capsys.readouterr().err
    with pytest.raises(ValueError, match="dual encoder"):
        ttrain.main(["--mode", "lm", "--arch", "basic-s", "--smoke",
                     "--device", "cpu", "--steps", "1"])
    # the recipe's modes keep their defaults
    args = ttrain.parse_args(["--mode", "contrastive", "--arch", "basic-s"])
    assert (args.precision, args.remat) == ("bf16", "basic")


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-130m", "basic-s"])
def test_synthetic_inputs_are_the_reference_s(arch):
    cfgs = [(jax_smoke_variant(jax_get_arch(arch)),
             smoke_variant(get_arch(arch)))] if arch != "basic-s" else [
        (jax_smoke_variant(getattr(jax_get_arch(arch), t)),
         smoke_variant(getattr(get_arch(arch), t)))
        for t in ("image_tower", "text_tower")]
    for jcfg, tcfg in cfgs:
        jrng, trng = np.random.default_rng(3), np.random.default_rng(3)
        for _ in range(2):              # the generator advances alike
            ref = jax.device_get(jfe.synthetic_inputs(jcfg, 3, 24, jrng))
            got = tfe.synthetic_inputs(tcfg, 3, 24, trng, device="cpu")
            assert set(got) == set(ref)
            for k, r in ref.items():
                assert str(got[k].dtype).removeprefix("torch.") == \
                    str(r.dtype), k
                np.testing.assert_array_equal(got[k].numpy(), r, err_msg=k)


def _shape_tree(tree):
    return {p: (tuple(x.shape), str(x.dtype).removeprefix("torch."))
            for p, x in leaves(tree)}


def _port_lm_configs():
    for name in list_archs():
        cfg = get_arch(name)
        towers = ([cfg.image_tower, cfg.text_tower]
                  if hasattr(cfg, "image_tower") else [cfg])
        for t in towers:
            yield name, t


def test_applicable_shapes_and_input_specs_are_the_reference_s():
    assert {k: dataclasses.astuple(v) for k, v in INPUT_SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in jbase.INPUT_SHAPES.items()}
    for name, tcfg in _port_lm_configs():
        jarch = jax_get_arch(name)
        jcfg = (jarch if not hasattr(jarch, "image_tower") else
                jarch.image_tower if tcfg.frontend == "vision"
                else jarch.text_tower)
        shapes = applicable_shapes(tcfg)
        assert [s.name for s in shapes] == \
            [s.name for s in jbase.applicable_shapes(jcfg)], name
        for cut in (False, True):
            tc = smoke_variant(tcfg) if cut else tcfg
            jc = jax_smoke_variant(jcfg) if cut else jcfg
            for shape in shapes:
                ref = jsteps.input_specs(jc, jbase.INPUT_SHAPES[shape.name])
                ref_shapes = {p: (tuple(s.shape), str(s.dtype))
                              for p, s in leaves(ref)}
                got = _shape_tree(tsteps.input_specs(tc, shape))
                assert got == ref_shapes, (name, shape.name, cut)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-130m"])
def test_abstract_params_and_opt_state_are_the_reference_s(arch):
    tcfg, jcfg = get_arch(arch), jax_get_arch(arch)
    pa = tsteps.abstract_params(tcfg)
    assert all(x.device.type == "meta" for _, x in leaves(pa))
    ref = jsteps.abstract_params(jcfg)
    assert _shape_tree(pa) == {p: (tuple(s.shape), str(s.dtype))
                               for p, s in leaves(ref)}
    oa = tsteps.abstract_opt_state(tcfg, tsteps.make_optimizer(), pa)
    jopt = jsteps.make_optimizer()
    oref = jsteps.abstract_opt_state(jcfg, jopt, ref)
    assert _shape_tree(oa) == {p: (tuple(s.shape), str(s.dtype))
                               for p, s in leaves(oref)}


def test_prefill_and_serve_steps_match_reference(lm):
    arch, jcfg, tcfg, jparams, tparams, toks = lm
    prompt = toks[:, :32]
    jlogits = jsteps.make_prefill_step(jcfg, precision="f32",
                                       moe_args={"dispatch": "dense"})(
        jax.tree.map(jnp.asarray, jparams), {"tokens": jnp.asarray(prompt)})
    logits = tsteps.make_prefill_step(tcfg, precision="f32")(
        tparams, {"tokens": torch.from_numpy(prompt)})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-4)
    # one decode step from caches the reference's prefill built
    jl, jcaches = jtf.prefill(jcfg, jax.tree.map(jnp.asarray, jparams),
                              {"tokens": jnp.asarray(prompt)},
                              precision="f32", collect_cache_len=48)
    caches = interop.caches_from_numpy(jax.device_get(jcaches), "cpu")
    tok = toks[:, 32:33]
    jout, _ = jsteps.make_serve_step(jcfg, precision="f32")(
        jax.tree.map(jnp.asarray, jparams), jcaches, jnp.asarray(tok),
        jnp.asarray(32, jnp.int32))
    out, new = tsteps.make_serve_step(tcfg, precision="f32")(
        tparams, caches, torch.from_numpy(tok), 32)
    assert new is caches                # written in place
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-4,
                               atol=1e-4)
