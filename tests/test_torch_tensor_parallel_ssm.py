"""Megatron execution of the Mamba-2 mixer in the port
(``models.ssm.mamba_mixer`` with a model axis, ``core.tensor_parallel``),
on spawned gloo worlds, against the one-rank mixer and the reference's
functions.

- The smoke Mamba-2 mixer (16 heads of 32, state 16, conv over d_inner 512
  + 2 x 16 = 544 channels, so at M 4 ``conv_w``'s even split of 136
  channels a rank does not fall on a rank's 128 x channels) at M 2 and 4:
  its output, x's gradient and every leaf's gradient made whole match
  the one-rank mixer of the port and the reference's ``mamba_mixer`` on
  the same weights (f32, the limits of
  ``tests/test_torch_tensor_parallel.py``; against the reference the
  per-head leaves' gradients, sums over every position, within 1e-4 of
  their largest entry, the scan's rule in ``tests/test_torch_cuda_ssd.py``:
  the port's one-rank mixer is itself up to 3e-5 of it from the
  reference's autograd there, and the split mixer within 4e-7 of the
  one-rank one). ``in_B``, ``in_C`` and
  ``conv_w`` are named: every rank uses them whole and each rank's heads
  give a part of their gradient, which a backward that keeps the rank's
  slice (``tensor_parallel.whole``) would get wrong. Each rank's scan
  takes H/M heads.
- ``lm_loss`` of smoke Mamba-2-130M and smoke Jamba-1.5-Large (mixer,
  attention and expert-parallel MoE in one model) at M 2 against
  ``jax.value_and_grad`` of the reference's: only the norm scales are made
  whole, only the mixers' ``in_B``, ``in_C`` and ``conv_w`` are gathered
  with the summing backward (``weight_sharding``'s gather is refused
  otherwise), every scan takes H/M heads.
- The port's ``tp`` specs equal the reference's ``_tp_leaf_spec`` for
  every leaf of Mamba-2-130M and Jamba-1.5-Large, whole and smoke, at M 2
  and 4.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from repro.configs import get_arch as jax_get_arch
from repro.configs import smoke_variant as jax_smoke_variant
from repro.core import sharding as jshd
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro_torch.configs import get_arch, smoke_variant
from repro_torch.core import sharding as shd
from repro_torch.interop import init_params
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.spawn import run_world
from repro_torch.models import ssm
from repro_torch.tree import leaves

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_tensor_parallel import CAPACITY, _close, _joined  # noqa: E402
from torch_spawn import worker_tp_lm, worker_tp_mixer  # noqa: E402

MAMBA, JAMBA = "mamba2-130m", "jamba-1.5-large-398b"
# the leaves every rank uses whole and whose gradient the ranks' heads
# each give a part of
SUMMED = ("in_B", "in_C", "conv_w")
# the per-head leaves, whose gradients are sums over every position: the
# port's scan backward and the reference's autograd sum them in another
# order (tests/test_torch_cuda_ssd.py's GRAD_SUM_TOL_REL)
PER_HEAD, SUM_TOL_REL = ("A_log", "D", "dt_bias"), 1e-4


def _close_ref(got, want, what, leaf):
    """``_close`` for a gradient against the reference's; a per-head
    leaf's within SUM_TOL_REL of its largest entry."""
    if leaf.rsplit("/", 1)[-1] not in PER_HEAD:
        return _close(got, want, what, grad=True)
    np.testing.assert_allclose(got, want, rtol=0, atol=SUM_TOL_REL * float(
        np.abs(want).max()), err_msg=what)


def _mixer_case(seed):
    """One layer's whole mixer weights of the smoke Mamba-2 (each stacked
    on a layer axis of 1), x (2, 64, d) and the upstream gradient, drawn
    from a seed; dt_bias, A_log and D differ by head."""
    cfg = smoke_variant(get_arch(MAMBA))
    d, s = cfg.d_model, cfg.ssm
    d_in, h, c = ssm.dims(cfg)
    rng = np.random.default_rng(seed)

    def draw(*shape, scale=1.0):
        return (scale * rng.standard_normal((1, *shape))).astype(np.float32)
    w = {"in_z": draw(d, d_in, scale=d ** -0.5),
         "in_x": draw(d, d_in, scale=d ** -0.5),
         "in_B": draw(d, s.state_dim, scale=d ** -0.5),
         "in_C": draw(d, s.state_dim, scale=d ** -0.5),
         "in_dt": draw(d, h, scale=d ** -0.5),
         "conv_w": draw(s.conv_width, c, scale=s.conv_width ** -0.5),
         "dt_bias": draw(h, scale=0.5),
         "A_log": (np.log(np.linspace(1.0, 16.0, h))[None]
                   + draw(h, scale=0.1)).astype(np.float32),
         "D": 1.0 + draw(h, scale=0.5),
         "out": draw(d_in, d, scale=d_in ** -0.5)}
    x = rng.standard_normal((2, 64, d)).astype(np.float32)
    up = rng.standard_normal((2, 64, d)).astype(np.float32)
    return w, x, up


def _reference_mixer(w, x, up):
    """(out, dx, grads by leaf name) of the reference's ``mamba_mixer`` on
    one layer's weights, for loss = Σ up · out."""
    jcfg = jax_smoke_variant(jax_get_arch(MAMBA))

    def loss(p, xx):
        out, _ = jssm.mamba_mixer(p, jcfg, xx)
        return jnp.sum(out * up), out
    p = {k: jnp.asarray(v[0]) for k, v in w.items()}
    (_, out), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1),
                                            has_aux=True)(p, jnp.asarray(x))
    return np.asarray(out), np.asarray(gx), jax.tree.map(np.asarray, gp)


def _one_rank_mixer(w, x, up):
    """(out, dx, grads by leaf name) of the port's mixer on one rank."""
    cfg = smoke_variant(get_arch(MAMBA))
    p = {k: torch.from_numpy(v[0]).requires_grad_() for k, v in w.items()}
    xt = torch.from_numpy(x).requires_grad_()
    out, _ = ssm.mamba_mixer(p, cfg, xt)
    names = list(p)
    g = torch.autograd.grad(torch.sum(out * torch.from_numpy(up)),
                            [xt] + [p[k] for k in names])
    return (out.detach().numpy(), g[0].numpy(),
            {k: t.numpy() for k, t in zip(names, g[1:])})


@pytest.mark.parametrize("model", [2, 4])
def test_mixer_matches_one_rank_and_the_reference(model, tmp_path):
    w, x, up = _mixer_case(model)
    ranks = run_world(worker_tp_mixer, model, str(tmp_path / "rdv"), model,
                      MAMBA, w, x, up, timeout=180)
    cfg = smoke_variant(get_arch(MAMBA))
    _, h, c = ssm.dims(cfg)
    dims = ranks[0]["dims"]
    # z, x, dt by head, out by row, the per-head leaves by head; B, C on
    # the state dim and the conv on its channels, evenly
    assert dims == {"in_z": 1, "in_x": 1, "in_dt": 1, "out": 0,
                    "A_log": 0, "D": 0, "dt_bias": 0, "in_B": 1, "in_C": 1,
                    "conv_w": 1}
    assert ranks[0]["grads"]["conv_w"].shape[1] == c // model
    for name, (out, dx, grads) in (("reference", _reference_mixer(w, x, up)),
                                   ("one rank", _one_rank_mixer(w, x, up))):
        for r, rec in enumerate(ranks):
            assert rec["heads"] == [h // model], rec["heads"]
            _close(rec["out"], out, f"{name}: rank {r} out")
            _close(rec["dx"], dx, f"{name}: rank {r} dx", grad=True)
        check = _close_ref if name == "reference" else (
            lambda got, want, what, _: _close(got, want, what, grad=True))
        for k, want in grads.items():
            got = _joined([rec["grads"][k] for rec in ranks], dims[k])
            check(got, want, f"{name}: d{k}" + (
                " (used whole, summed over the ranks)" if k in SUMMED
                else ""), k)
        for k in SUMMED:
            assert np.abs(grads[k]).max() > 0, k


@pytest.mark.parametrize("arch", [MAMBA, JAMBA])
def test_lm_loss_is_the_references_with_the_mixer_split(arch, tmp_path):
    jcfg = jax_smoke_variant(jax_get_arch(arch))
    weights = jax.device_get(jtf.init_params(jcfg, jax.random.key(0)))
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 64)).astype(
        np.int32)
    margs = CAPACITY if jcfg.moe is not None else None

    def loss(p):
        return jtf.lm_loss(jcfg, p, {"tokens": jnp.asarray(toks)},
                           moe_args=margs)
    (want, metrics), grads = jax.value_and_grad(loss, has_aux=True)(
        jax.tree.map(jnp.asarray, weights))
    ranks = run_world(worker_tp_lm, 2, str(tmp_path / "rdv"), 2, arch,
                      weights, toks, margs, timeout=180)
    cfg = smoke_variant(get_arch(arch))
    d, s = cfg.d_model, cfg.ssm
    _, h, c = ssm.dims(cfg)
    mixers = sum(k == "mamba" for k in cfg.layer_kinds())
    for r, rec in enumerate(ranks):
        np.testing.assert_allclose(rec["loss"], float(want), rtol=1e-5)
        np.testing.assert_allclose(rec["xent"], float(metrics["xent"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(rec["aux"], float(metrics["aux"]),
                                   rtol=1e-5, atol=1e-6)
        # the block norms alone are made whole; each mixer gathers its B,
        # C and conv weights with the summing backward; each scan runs on
        # H/M heads
        assert rec["whole"] and set(rec["whole"]) == {((d // 2,), 0)}
        assert sorted(rec["summed"]) == sorted(
            [((d, s.state_dim // 2), 1)] * 2 * mixers
            + [((s.conv_width, c // 2), 1)] * mixers)
        assert rec["scan_heads"] == [h // 2] * mixers
        if cfg.moe is not None:
            assert set(rec["experts"]) == {cfg.moe.num_experts // 2}
    dims = ranks[0]["dims"]
    for path, want_g in leaves(jax.tree.map(np.asarray, grads)):
        got = _joined([rec["grads"][path] for rec in ranks], dims[path])
        _close_ref(got, want_g, path, path)


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", [MAMBA, JAMBA])
def test_tp_specs_are_the_references(arch, smoke, model):
    cfg = get_arch(arch)
    if smoke:
        cfg = smoke_variant(cfg)
    whole = init_params(cfg, torch.Generator(), "meta")
    got = dict(shd.spec_leaves(shd.params_specs(
        whole, Mesh({"data": 1, "model": model}), "tp")))
    mamba = 0
    for path, x in leaves(whole):
        skip = {0} if "blocks" in path.split("/") else set()
        spec = (jshd._tp_leaf_spec(path, tuple(x.shape), model, skip)
                if x.dim() > 1 else PartitionSpec())
        want = tuple(spec) + (None,) * (x.dim() - len(spec))
        assert tuple(got[path]) == want, (path, got[path], want)
        mamba += "/mamba/" in path
    assert mamba
