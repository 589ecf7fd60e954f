"""Megatron execution of the ``tp`` rule in the port
(``core.tensor_parallel``), on spawned gloo worlds, against whole-weight
autograd and the reference's own functions.

- The four operators (``copy_to_model``, ``reduce_from_model``,
  ``gather_from_model``, ``whole``) on M 2 and 4 ranks give the forward
  and the gradients of single-process autograd of the whole computation,
  f32 at rtol 1e-5.
- One layer each, on the reference's weights placed by ``params_specs(...,
  'tp')``, against the reference's function on the whole weights (f32,
  outputs rtol 1e-5 / atol 1e-6 of their largest entry, gradients rtol
  1e-5 / atol 1e-5 of theirs): attention with GQA and
  qk-norm (8 query heads over 4 kv heads, each rank H/M and KV/M of them),
  ``swiglu``, ``moe_ffn`` with the experts split (expert parallelism,
  capacity and dense dispatch) and with 3 experts over 2 ranks (the rule
  splits the ff dim instead).
- ``lm_loss`` of smoke Llama-3.2-1B (tied head) and smoke Mixtral-8x22B
  (``lm_head``, expert parallelism, capacity dispatch) at M 2 against
  ``jax.value_and_grad`` of the reference's: the vocab-parallel embedding
  and cross-entropy, every block. No rank gathers an attention, FFN or
  expert weight (only the norm scales are made whole, and
  ``weight_sharding``'s gather is refused), and each Mixtral rank's expert
  products run over its E/M experts.
- Each rank holds 1/M of every leaf the rule splits plus the whole ones,
  in bytes, and one GradAccum step's gradients come back as parts; a
  ``tp`` checkpoint is the file an M 1 checkpoint of the same state is,
  and restores under ``basic_ws`` and at M 1 bit for bit (and an M 1
  checkpoint under ``tp``).
"""
import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import smoke_variant as jax_smoke_variant
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro_torch import checkpoint as ckpt
from repro_torch.configs import get_arch, smoke_dual_variant
from repro_torch.core import sharding as shd
from repro_torch.interop import init_params
from repro_torch.launch import steps as st
from repro_torch.launch import train_distributed as td
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.spawn import run_world
from repro_torch.tree import leaves

sys.path.insert(0, os.path.dirname(__file__))

from torch_spawn import (worker_checkpoint, worker_resident,  # noqa: E402
                         worker_tp_layer, worker_tp_lm, worker_tp_ops)

RTOL, ATOL = 1e-5, 1e-6


def _close(got, want, what, grad=False):
    """rtol 1e-5 and atol 1e-6 of the largest entry (at least 1e-6): a
    rank's partial sums over its heads, ff columns or experts are added in
    another order than one device's, and an entry near zero keeps the
    rounding of its terms; a gradient's atol is 1e-5 of its largest entry,
    since the norm scales' and routers' gradients are sums over every
    position and head (the rule of ``tests/test_torch_lm_train.py``)."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    atol = RTOL * scale if grad else ATOL * scale
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol,
                               err_msg=what)


def _joined(parts, dim):
    return parts[0] if dim is None else np.concatenate(parts, axis=dim)


# ---------------------------------------------------------------------------
# the operators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model", [2, 4])
def test_operators_match_whole_autograd(model, tmp_path):
    rng = np.random.default_rng(model)

    def draw(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)
    d, f, e = 8, 16, 12
    case = {"x": draw(6, d), "n": draw(d), "A": draw(d, f, scale=d ** -.5),
            "B": draw(f, d, scale=f ** -.5), "C": draw(d, e, scale=d ** -.5),
            "uy": draw(6, d), "uz": draw(6, e)}
    out = run_world(worker_tp_ops, model, str(tmp_path / "rdv"), model,
                    case, timeout=120)
    w = {k: torch.from_numpy(v).requires_grad_() for k, v in case.items()
         if k not in ("uy", "uz")}
    h = w["x"] * w["n"]
    y = torch.relu(h @ w["A"]) @ w["B"]
    z = h @ w["C"]
    loss = torch.sum(torch.from_numpy(case["uy"]) * y) + torch.sum(
        torch.from_numpy(case["uz"]) * z)
    grads = torch.autograd.grad(loss, [w[k] for k in "xnABC"])
    dims = {"x": None, "n": 0, "A": 1, "B": 0, "C": 1}
    for r, (gy, gz, *gg) in enumerate(out):
        np.testing.assert_allclose(gy, y.detach().numpy(), rtol=RTOL)
        np.testing.assert_allclose(gz, z.detach().numpy(), rtol=RTOL)
        for k, got, want in zip("xnABC", gg, grads):
            want = want.numpy()
            if dims[k] is not None:
                b = want.shape[dims[k]] // model
                want = want.take(range(r * b, (r + 1) * b), axis=dims[k])
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                       err_msg=f"rank {r} d{k}")


# ---------------------------------------------------------------------------
# one layer each against the reference's functions
# ---------------------------------------------------------------------------

# GQA with qk-norm: 8 query heads over 4 kv heads, so M 4 keeps whole
# groups; 3 experts do not divide over 2 ranks (the ff dim is split)
ATTN = {"n_heads": 8, "n_kv_heads": 4, "head_dim": 32, "qk_norm": True}
MOE = "mixtral-8x22b"
CAPACITY = {"dispatch": "capacity", "group": 16, "capacity_factor": 1.0}
LAYERS = {
    2: ["attn", "ffn", "moe_ep_capacity", "moe_ep_dense", "moe_ff_capacity"],
    4: ["attn", "ffn", "moe_ep_capacity"],
}


def _jax_cfg(arch, changes):
    cfg = jax_smoke_variant(jax_get_arch(arch))
    changes = dict(changes)
    if "num_experts" in changes:
        changes["moe"] = dataclasses.replace(
            cfg.moe, num_experts=changes.pop("num_experts"))
    return dataclasses.replace(cfg, **changes)


def _layer_case(name):
    """(kind, arch, config changes, whole weights, x, upstream, moe
    keywords) of one layer case, drawn from a seed."""
    rng = np.random.default_rng(len(name))
    d = 256

    def dense(i, o, *extra):
        return (rng.standard_normal((*extra, i, o)) * i ** -0.5).astype(
            np.float32)
    x = rng.standard_normal((2, 16, d)).astype(np.float32)
    up = rng.standard_normal((2, 16, d)).astype(np.float32)
    if name == "attn":
        hd = ATTN["head_dim"]
        w = {"wq": dense(d, 8 * hd), "wk": dense(d, 4 * hd),
             "wv": dense(d, 4 * hd), "wo": dense(8 * hd, d),
             "q_norm": (1 + 0.1 * rng.standard_normal(hd)).astype(
                 np.float32),
             "k_norm": (1 + 0.1 * rng.standard_normal(hd)).astype(
                 np.float32)}
        return "attn", "llama3.2-1b", ATTN, {"attn": w}, x, up, {}
    if name == "ffn":
        w = {"wi": dense(d, 512), "wg": dense(d, 512), "wo": dense(512, d)}
        return "ffn", "llama3.2-1b", {}, {"ffn": w}, x, up, {}
    e = 3 if name == "moe_ff_capacity" else 4
    w = {"router": dense(d, e), "wi": dense(d, 512, e),
         "wg": dense(d, 512, e), "wo": dense(512, d, e)}
    kw = {"dispatch": "dense"} if name.endswith("dense") else CAPACITY
    return "moe", MOE, {"num_experts": e}, {"moe": w}, x, up, kw


def _reference_layer(kind, jcfg, weights, x, up, kw):
    """(out, aux, dx, grads by leaf name) of the reference's function on
    the whole weights, for loss = Σ up · out (+ aux)."""
    def f(p, xx):
        if kind == "attn":
            b, s = xx.shape[:2]
            pos = jnp.broadcast_to(jnp.arange(s), (b, s))
            return jattn.attention(p, jcfg, xx, pos, impl="naive"), 0.0
        if kind == "ffn":
            return jlayers.swiglu(xx, p["wi"], p["wg"], p["wo"]), 0.0
        return jmoe.moe_ffn(p, jcfg, xx, **kw)

    def loss(p, xx):
        out, aux = f(p, xx)
        return jnp.sum(out * up) + aux, (out, aux)
    p = {k: jnp.asarray(v) for k, v in weights[kind].items()}
    (_, (out, aux)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(p, jnp.asarray(x))
    return out, aux, gx, gp


@pytest.fixture(scope="module")
def layer_worlds(tmp_path_factory):
    """M -> {case: (the case, each rank's ``worker_tp_layer`` result)}: one
    spawned world of M ranks runs every case of ``LAYERS[M]``, on first
    use."""
    worlds = {}

    def world(model):
        if model not in worlds:
            cases = [_layer_case(n) for n in LAYERS[model]]
            out = run_world(worker_tp_layer, model,
                            str(tmp_path_factory.mktemp("rdv")), model,
                            cases, timeout=180)
            worlds[model] = {n: (c, [r[i] for r in out]) for i, (n, c) in
                             enumerate(zip(LAYERS[model], cases))}
        return worlds[model]
    return world


@pytest.mark.parametrize("model,name", [(m, n) for m in sorted(LAYERS)
                                        for n in LAYERS[m]])
def test_layer_matches_the_reference(layer_worlds, model, name):
    (kind, arch, changes, weights, x, up, kw), ranks = \
        layer_worlds(model)[name]
    jcfg = _jax_cfg(arch, changes)
    out, aux, gx, gp = _reference_layer(kind, jcfg, weights, x, up, kw)
    for r, rec in enumerate(ranks):
        _close(rec["out"], out, f"rank {r} out")
        _close(rec["dx"], gx, f"rank {r} dx", grad=True)
        if rec["aux"] is not None:
            np.testing.assert_allclose(rec["aux"], float(aux), rtol=RTOL)
    dims = ranks[0]["dims"]
    for k, want in gp.items():
        got = _joined([rec["grads"][k] for rec in ranks], dims[k])
        _close(got, want, f"d{k}", grad=True)
    if kind == "attn":          # column q/k/v, row o, whole norm scales
        assert dims == {"wq": 1, "wk": 1, "wv": 1, "wo": 0, "q_norm": None,
                        "k_norm": None}
    if kind == "moe":
        e = changes["num_experts"]
        if e % model == 0:      # expert parallel: E/M experts a rank
            assert dims["wi"] == 0 and [rec["experts"] for rec in ranks] == \
                [(r * e // model, e // model) for r in range(model)]
        else:                   # the ff dim: every rank every expert
            assert (dims["wi"], dims["wo"]) == (2, 1)
            assert all(rec["experts"] is None for rec in ranks)


# ---------------------------------------------------------------------------
# lm_loss: the vocab-parallel embedding and cross-entropy, every block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["llama3.2-1b", MOE])
def test_lm_loss_is_the_references_without_gathering_weights(arch,
                                                             tmp_path):
    jcfg = jax_smoke_variant(jax_get_arch(arch))
    weights = jax.device_get(jtf.init_params(jcfg, jax.random.key(0)))
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 32)).astype(
        np.int32)
    margs = CAPACITY if jcfg.moe is not None else None

    def loss(p):
        value, metrics = jtf.lm_loss(jcfg, p, {"tokens": jnp.asarray(toks)},
                                     moe_args=margs)
        return value, metrics
    (want, metrics), grads = jax.value_and_grad(loss, has_aux=True)(
        jax.tree.map(jnp.asarray, weights))
    ranks = run_world(worker_tp_lm, 2, str(tmp_path / "rdv"), 2, arch,
                      weights, toks, margs, timeout=180)
    want_grads = dict(leaves(jax.tree.map(np.asarray, grads)))
    for r, rec in enumerate(ranks):
        np.testing.assert_allclose(rec["loss"], float(want), rtol=RTOL)
        np.testing.assert_allclose(rec["xent"], float(metrics["xent"]),
                                   rtol=RTOL)
        np.testing.assert_allclose(rec["aux"], float(metrics["aux"]),
                                   rtol=RTOL, atol=ATOL)
        # only the norm scales are made whole: one (d/M,) part a block
        # norm, none of an attention, FFN, expert or embedding weight
        d = jcfg.d_model
        assert rec["whole"] and set(rec["whole"]) == {((d // 2,), 0)}
        if jcfg.moe is not None:
            e = jcfg.moe.num_experts
            assert rec["experts"] and set(rec["experts"]) == {e // 2}
    dims = ranks[0]["dims"]
    assert dims["embed"] == 0 and all(
        dims[k] is not None for k in dims if k.endswith(("wq", "wo", "wi")))
    for path, want_g in want_grads.items():
        got = _joined([rec["grads"][path] for rec in ranks], dims[path])
        _close(got, want_g, path, grad=True)


# ---------------------------------------------------------------------------
# the trainer's state and checkpoints
# ---------------------------------------------------------------------------


def _smoke():
    return smoke_dual_variant(get_arch("basic-s"))


def test_each_rank_holds_its_share_under_tp(tmp_path):
    """BASIC-S smoke at (1, 2): the params and the first moment are 1/M of
    every leaf ``params_specs(..., 'tp')`` splits plus the whole leaves,
    the optimizer state below the whole state, and one GradAccum step's
    gradients (the towers computing with their parts) come back as
    parts."""
    out = run_world(worker_resident, 2, str(tmp_path / "rdv"), 2, "tp",
                    timeout=180)
    whole = init_params(_smoke(), torch.Generator(), "meta")
    specs = dict(shd.spec_leaves(shd.params_specs(
        whole, Mesh({"data": 1, "model": 2}), "tp")))
    split = {p for p, s in specs.items() if "model" in s}
    want_params = sum(x.numel() * 4 // (2 if p in split else 1)
                      for p, x in leaves(whole))
    want_m = want_params // 2
    whole_state = sum(x.numel() * x.element_size()
                      for _, x in leaves(st.make_optimizer().init(whole)))
    assert {"image/proj", "text/tower/embed",
            "image/tower/blocks/0/attn/wq"} <= split
    for rec in out:
        assert set(rec["split"]) == split
        assert rec["params_bytes"] == want_params
        assert sum(int(np.prod(s)) * 2 for s in rec["m"].values()) == want_m
        assert want_m < rec["state_bytes"] < whole_state
        assert rec["grads"] == rec["params"] == rec["m"]


def _index(d):
    with open(os.path.join(d, "step_00000001", "index.json")) as f:
        return json.load(f)


def _parts_of(params, sharding, rank):
    specs = dict(shd.spec_leaves(shd.params_specs(
        params, Mesh({"data": 1, "model": 2}), sharding)))
    out = {}
    for path, x in leaves(params):
        want, spec = x.numpy(), specs[path]
        if "model" in spec:
            d = list(spec).index("model")
            b = x.shape[d] // 2
            want = want.take(range(rank * b, (rank + 1) * b), axis=d)
        out["0/" + path] = want
    return out


def test_tp_checkpoints_restore_under_basic_ws_and_at_m1(tmp_path):
    """The seeded state saved under ``tp`` at (1, 2) is the file the same
    state saved at M 1 is, leaf for leaf; restored under ``basic_ws`` at
    (1, 2) each rank gets its exact ``basic_ws`` parts, restored at M 1 the
    whole state, and the M 1 checkpoint restored under ``tp`` each rank's
    exact ``tp`` parts."""
    cfg = _smoke()
    opt = st.make_optimizer()
    params, state = td.build_state(cfg, opt, 0, "cpu")
    one, two = str(tmp_path / "m1"), str(tmp_path / "tp")
    ckpt.save(one, 1, (params, state))
    to_ws = run_world(worker_checkpoint, 2, str(tmp_path / "rdv1"), 2, two,
                      two, "tp", "basic_ws", timeout=120)
    to_tp = run_world(worker_checkpoint, 2, str(tmp_path / "rdv2"), 2,
                      str(tmp_path / "tp2"), one, "tp", timeout=120)
    assert _index(one) == _index(two)
    for i, _ in enumerate(_index(one)["leaves"]):
        a = np.load(os.path.join(one, "step_00000001", f"arr_{i}.npy"))
        b = np.load(os.path.join(two, "step_00000001", f"arr_{i}.npy"))
        assert a.tobytes() == b.tobytes(), i
    back = ckpt.restore(two, 1, (params, state), device="cpu")
    for (pa, a), (pb, b) in zip(leaves((params, state)), leaves(back)):
        assert pa == pb and torch.equal(a, b), pa
    for sharding, out in (("basic_ws", to_ws), ("tp", to_tp)):
        for rank, (start, parts) in enumerate(out):
            assert start == 1
            for path, want in _parts_of(params, sharding, rank).items():
                np.testing.assert_array_equal(parts[path], want,
                                              f"{sharding} {path}")
