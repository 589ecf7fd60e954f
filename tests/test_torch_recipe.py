"""Port parity: BASIC's three-phase recipe (paper §8) against the JAX
reference on the CPU, at smoke size (``smoke_dual_variant``, embed 64),
f32, the local loss and naive attention.

- Phase 1: the reference's own ``run_pretrain`` against the port's, from
  the reference's initial weights: losses at rel 1e-4 over 3 steps, and the
  params after the first step at rtol 1e-5.
- The chain: the reference's ``run_pretrain`` -> ``run_contrastive(...,
  train_image=False)`` -> ``run_contrastive(..., train_image=True)``
  against the port's from the same initial weights: each phase's losses at
  rel 1e-4, and each phase's params, per leaf, within 1e-3 of the change
  the chain made from its initial weights; the frozen tower equals the
  closed form p·Π(1 − lr_t·wd); the tower passed in is left as it was.
- One frozen-tower step of the step factory against the unfrozen one, the
  trainer's ``--mode pretrain`` command line and the three-phase example.

The reference's losses are read where its loop reads them: its module's
``float`` is wrapped to record each value it converts.
"""
import builtins
import math

import jax
import numpy as np
import pytest
import torch

from repro.launch import train as jtrain
from repro.models import dual_encoder as jde
from repro.models import transformer as jtf
from repro_torch import interop
from repro_torch.launch import train as ttrain
from repro_torch.optim import schedules as tsched

torch.set_num_threads(1)

WD = 0.0025     # the contrastive phases' weight decay (make_optimizer)


def _args(mode="pretrain", steps=3, lr=1e-3, batch=8):
    """One namespace for both trainers: the port's command line, plus the
    reference's name for the microbatch count."""
    args = ttrain.parse_args([
        "--mode", mode, "--arch", "basic-s", "--smoke", "--device", "cpu",
        "--steps", str(steps), "--batch", str(batch), "--num-micro", "2",
        "--classes", "16", "--lr", str(lr), "--seed", "0",
        "--log-every", "1", "--precision", "f32", "--loss", "local",
        "--attn", "naive", "--remat", "off"])
    args.micro = args.num_micro
    return args


def _record_reference_floats(monkeypatch) -> list:
    """Every value the reference trainer passes to ``float``, in order."""
    seen = []

    def rec(x):
        v = builtins.float(x)
        seen.append(v)
        return v
    monkeypatch.setattr(jtrain, "float", rec, raising=False)
    return seen


def _reference_inits(args):
    """The reference's initial weights, as numpy: phase 1's {'tower',
    'head'} (``run_pretrain``'s draw from ``key(seed)``) and the dual
    encoder's (``key(seed + 1)``)."""
    cfg, world, _, _ = jtrain._build_world(args)
    icfg = cfg.image_tower
    key = jax.random.key(args.seed)
    pre = {"tower": jtf.init_params(icfg, key),
           "head": jax.random.normal(key, (icfg.d_model, world.n_classes))
           * icfg.d_model ** -0.5}
    dual = jde.init_params(cfg, jax.random.key(args.seed + 1))
    return jax.device_get(pre), jax.device_get(dual)


@pytest.fixture(scope="module")
def inits():
    return _reference_inits(_args())


def _use_reference_inits(monkeypatch, inits):
    pre, dual = inits
    monkeypatch.setattr(ttrain, "init_pretrain_params",
                        lambda cfg, n, gen, dev: interop.from_numpy(pre,
                                                                    dev))
    monkeypatch.setattr(ttrain, "init_params",
                        lambda cfg, gen, dev: interop.from_numpy(dual, dev))


def _paths(tree):
    return {p: np.asarray(v, np.float32)
            for p, v in interop.leaves(interop.to_numpy(tree))}


def _ref_paths(tree):
    return {p: np.asarray(v, np.float32)
            for p, v in interop.leaves(jax.device_get(tree))}


def _assert_close(got, ref, rtol):
    assert set(got) == set(ref)
    for path, r in ref.items():
        np.testing.assert_allclose(got[path], r, rtol=rtol,
                                   atol=rtol * np.abs(r).max(),
                                   err_msg=path)


def _assert_change_close(got, ref, init, rtol):
    """Per leaf, ||got - ref|| <= rtol·||ref - init||: the gap held against
    the change that training made, not against the weights (a few steps at
    lr 1e-3 move a leaf by about 1e-2 of its norm). Both sides store the
    first moment in bf16; where an element's fp32 moment lies on a rounding
    boundary the two round it one bf16 ulp (2^-8) apart, and its next
    update moves by as much. Read on the CPU: the sound chain's worst leaf
    is at 1.8e-4 of its change (phase 3); planted faults give weight decay
    0.0026 for 0.0025: 4.2e-2, the update ×1.01: 1.2e-2, beta1 0.91 for
    0.9: 9.9e-2, the schedule one step ahead: 0.79."""
    assert set(got) == set(ref)
    for path, r in ref.items():
        err = np.linalg.norm(got[path] - r)
        assert err <= rtol * np.linalg.norm(r - init[path]), (path, err)


def test_pretrain_matches_reference(monkeypatch, inits):
    _use_reference_inits(monkeypatch, inits)
    ref_losses = _record_reference_floats(monkeypatch)
    ref1 = jtrain.run_pretrain(_args(steps=1))
    ref_losses.clear()
    jtrain.run_pretrain(_args(steps=3))
    got1 = ttrain.run_pretrain(_args(steps=1))
    got = ttrain.run_pretrain(_args(steps=3))
    assert len(ref_losses) == 3
    for g, r in zip(got["losses"], ref_losses):
        assert g == pytest.approx(r, rel=1e-4)
    assert got["losses"][0] == pytest.approx(got1["losses"][0], rel=0)
    assert set(got1["params"]) == {"tower", "head"}
    _assert_close(_paths(got1["params"]), _ref_paths(ref1), rtol=1e-5)
    assert got["device"] == "cpu" and got["images_per_s"] > 0


def _frozen_closed_form(tower, steps, lr):
    """p·Π(1 − lr_t·wd) over the phase's warmup-cosine schedule."""
    lr_fn = tsched.warmup_cosine(lr, lr / 100, steps // 10 or 1, steps)
    factor = math.prod(1.0 - float(lr_fn(t)) * WD for t in range(steps))
    return {p: v * factor for p, v in _paths(tower).items()}


def test_three_phase_chain_matches_reference(monkeypatch, inits):
    _use_reference_inits(monkeypatch, inits)
    seen = _record_reference_floats(monkeypatch)
    a1, a2, a3 = _args(steps=2), _args("contrastive"), \
        _args("finetune", steps=2, lr=5e-4)

    ref_losses = []
    jpre = jtrain.run_pretrain(a1)
    ref_losses.append(seen[:])
    seen.clear()
    jp2 = jtrain.run_contrastive(a2, image_tower_init=jpre["tower"],
                                 train_image=False)
    jp3 = jtrain.run_contrastive(a3, image_tower_init=jp2["image"]["tower"],
                                 train_image=True)
    # the contrastive loop converts the loss, then i2t@1, at every step
    ref_losses += [seen[:2 * a2.steps:2], seen[2 * a2.steps::2]]

    rep1 = ttrain.run_pretrain(a1)
    pre = rep1["params"]
    tower_before = _paths(pre["tower"])
    rep2 = ttrain.run_contrastive(a2, image_tower_init=pre["tower"],
                                  train_image=False)
    p2 = rep2["params"]
    rep3 = ttrain.run_contrastive(a3, image_tower_init=p2["image"]["tower"],
                                  train_image=True)

    # the tower passed in is not changed in place
    for path, v in _paths(pre["tower"]).items():
        np.testing.assert_array_equal(v, tower_before[path], err_msg=path)
    # phase 2 froze the tower: weight decay alone moved it
    _assert_close(_paths(p2["image"]["tower"]),
                  _frozen_closed_form(pre["tower"], a2.steps, a2.lr),
                  rtol=1e-6)
    # the projection and log_tau trained
    assert float(p2["log_tau"]) != float(interop.from_numpy(
        inits[1]["log_tau"], "cpu"))
    # and phase 3 trained the tower
    assert not np.allclose(_paths(rep3["params"]["image"]["tower"])[
        "blocks/0/attn/wq"], _paths(p2["image"]["tower"])["blocks/0/attn/wq"])

    for rep, ref in zip((rep1, rep2, rep3), ref_losses):
        assert len(rep["losses"]) == len(ref)
        for g, r in zip(rep["losses"], ref):
            assert g == pytest.approx(r, rel=1e-4)
    # the chain's initial weights: the pretrain draw's tower in the dual
    # encoder's draw
    init_pre = _ref_paths(inits[0])
    init_dual = {**_ref_paths(inits[1]),
                 **{f"image/{p}": v for p, v in init_pre.items()
                    if p.startswith("tower/")}}
    _assert_change_close(_paths(pre), _ref_paths(jpre), init_pre, 1e-3)
    _assert_change_close(_paths(p2), _ref_paths(jp2), init_dual, 1e-3)
    _assert_change_close(_paths(rep3["params"]), _ref_paths(jp3), init_dual,
                         1e-3)


def test_frozen_step_decays_the_tower_and_trains_the_rest(inits):
    """One phase-2 step of the step factory: the tower's update is the
    weight decay alone, its second-moment slots take in eps, and the rest
    of the update equals the unfrozen step's."""
    from repro_torch.configs import get_arch, smoke_dual_variant
    from repro_torch.data import contrastive_batch, load_tokenizer, \
        world_for_tower
    from repro_torch.launch import steps as tsteps
    cfg = smoke_dual_variant(get_arch("basic-s"), embed_dim=64)
    rng = np.random.default_rng(0)
    world = world_for_tower(rng, cfg.image_tower, n_classes=16)
    batch = ttrain.batch_to(contrastive_batch(world, load_tokenizer(), 8,
                                              rng)[0], "cpu")
    params = interop.from_numpy(inits[1], "cpu")
    out = {}
    for frozen in (False, True):
        step, opt = tsteps.make_contrastive_step(
            cfg, num_micro=2, precision="f32", loss="local", attn="naive",
            remat=None, lr=1e-3, freeze_image=frozen)
        out[frozen] = step(params, opt.init(params), batch)
    (p_on, s_on, l_on, _), (p_fz, s_fz, l_fz, _) = out[False], out[True]
    assert float(l_on) == float(l_fz)
    closed = {p: v * (1 - 1e-3 * WD)
              for p, v in _paths(params["image"]["tower"]).items()}
    _assert_close(_paths(p_fz["image"]["tower"]), closed, rtol=1e-6)
    eps_slot = 0.01 * 1e-30     # (1 - beta2) * (0 + eps)
    for _, v in interop.leaves(s_fz.v_row["image"]["tower"]):
        assert torch.allclose(v, torch.full_like(v, eps_slot), rtol=1e-6,
                              atol=0)
    for part in ("text", "log_tau"):
        for (path, a), (_, b) in zip(interop.leaves(p_fz[part]),
                                     interop.leaves(p_on[part])):
            assert torch.equal(a, b), path
    for (path, a), (_, b) in zip(interop.leaves(p_fz["image"]["proj"]),
                                 interop.leaves(p_on["image"]["proj"])):
        assert torch.equal(a, b), path


def test_pretrain_command_line_runs_on_the_cpu(capsys):
    rep = ttrain.main(["--mode", "pretrain", "--arch", "basic-s", "--smoke",
                       "--device", "cpu", "--steps", "3", "--batch", "8"])
    out = capsys.readouterr().out
    assert out.count("pretrain step") == 3
    assert "xent" in out and "images/s" in out
    assert len(rep["losses"]) == 3
    assert all(math.isfinite(v) for v in rep["losses"])
    assert set(rep["params"]) == {"tower", "head"}
    assert rep["params"]["head"].shape == (256, 64)


def test_contrastive_run_keeps_its_params_in_the_report():
    rep = ttrain.run_contrastive(_args("contrastive", steps=1))
    assert set(rep["params"]) == {"image", "text", "log_tau"}
    assert rep["opt_state"].step.item() == 1


def test_example_runs_the_three_phases(capsys):
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).parents[1] / "examples" / \
        "contrastive_pretrain_torch.py"
    spec = importlib.util.spec_from_file_location("cp_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    rep = mod.main(["--steps", "2", "--batch", "8", "--device", "cpu",
                    "--precision", "f32", "--attn", "naive"])
    out = capsys.readouterr().out
    for phase in ("phase 1", "phase 2", "phase 3"):
        assert phase in out
    assert len(rep["losses"]) == 10          # max(10, steps // 4)
    assert all(math.isfinite(v) for v in rep["losses"])
