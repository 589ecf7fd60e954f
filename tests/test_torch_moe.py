"""Port parity: the MoE family against the JAX reference on the CPU, from the
same weights (carried over with ``interop.from_numpy``) and the same
inputs, drawn with numpy from a seed.

- ``moe_ffn`` under dense and capacity dispatch, f32 and bf16: no drops
  (cf = E/k), drops (cf 0.25 and 1.25), groups of 8/16/32, the decode
  shape where the capacity rounds half to even (round(2.5) = 2), Arctic's
  dense residual; the load-balance term.
- Ties: a zeroed router ties every probability; the picks, the bucket
  places, which pairs are kept and the output equal the reference's
  under capacity dispatch with drops (``torch.topk`` breaks these ties
  otherwise).
- The transformer: ``param_counts`` of the full-size configs; for the
  Mixtral smoke variant ``lm_loss`` with its ``xent`` / ``aux`` and every
  gradient, ``prefill`` logits and caches and 8 ``decode_step``s under
  both dispatches (a linear cache, and a ring after a prompt longer than
  the window), and a MoE interleave of 2; the lockstep and continuous
  engines' tokens against the reference engines' under both dispatches;
  checkpoints of a MoE tree both ways.

Tolerances: f32 rtol 2e-4, atol 1e-5 (the reference's own,
tests/test_moe.py); bf16 2e-2 (both sides round the same fp32 sums to
bf16; one rounding-boundary crossing moves a value by 2^-8 of itself);
gradients per leaf within 1e-4 of the leaf's largest |gradient|.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.configs import get_arch as jax_get_arch
from repro.configs import smoke_variant as jax_smoke
from repro.launch import steps as jsteps
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.serving import ContinuousEngine as JaxContinuousEngine
from repro.serving import Engine as JaxEngine
from repro_torch import checkpoint as ckpt
from repro_torch import interop
from repro_torch.configs import get_arch, list_archs, smoke_variant
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.serving import ContinuousEngine, Engine
from repro_torch.tree import leaves
from test_torch_checkpoint import _assert_trees_equal, _meta_like, _np_bits
from test_torch_lm_train import _assert_change_close, _paths

torch.set_num_threads(1)

TOL = {"float32": dict(rtol=2e-4, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
GRAD_REL = 1e-4
CACHE_LEN = 32
DENSE = {"dispatch": "dense"}
CAPACITY = {"dispatch": "capacity"}


def _pair(arch="mixtral-8x22b", moe=None, **changes):
    """(reference cfg, port cfg): the smoke variant of ``arch`` with
    ``changes`` and the MoE fields in ``moe`` replaced."""
    jcfg = jax_smoke(jax_get_arch(arch))
    tcfg = smoke_variant(get_arch(arch))
    if moe:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                                 **moe))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe,
                                                                 **moe))
    return (dataclasses.replace(jcfg, **changes),
            dataclasses.replace(tcfg, **changes))


def _moe_weights(jcfg, seed):
    jp = jax.device_get(jmoe.init_moe_params(jax.random.key(seed), jcfg))
    return jp, interop.from_numpy(jp, "cpu")


def _lm_weights(jcfg, seed=0):
    jp = jax.device_get(jtf.init_params(jcfg, jax.random.key(seed)))
    return jp, interop.from_numpy(jp, "cpu")


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _both(x, dtype):
    """x as the reference's and the port's input in ``dtype`` (the same
    bf16 values: both round the f32 draw to nearest even)."""
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(getattr(torch, dtype))


def _np(t):
    return t.detach().float().numpy()


def _reference_positions(top_idx, E, cap):
    """(pos, keep) as the reference's capacity dispatch computes them
    (repro/models/moe.py:83-87), for top_idx (n, g, k)."""
    n, g, k = top_idx.shape
    flat = jax.nn.one_hot(jnp.asarray(top_idx), E,
                          dtype=jnp.int32).reshape(n, g * k, E)
    pos = jnp.cumsum(flat, axis=1) - 1
    pos = jnp.sum(pos * flat, axis=-1).reshape(n, g, k)
    return np.asarray(pos), np.asarray(pos < cap)


def _loop_positions(top_idx, E, cap):
    """The same by a plain loop: each pair's rank among its group's pairs
    for its expert, token-major."""
    n, g, k = top_idx.shape
    pos = np.zeros((n, g, k), np.int64)
    for i in range(n):
        seen = [0] * E
        for t in range(g):
            for j in range(k):
                e = int(top_idx[i, t, j])
                pos[i, t, j] = seen[e]
                seen[e] += 1
    return pos, pos < cap


# ---------------------------------------------------------------------------
# moe_ffn
# ---------------------------------------------------------------------------

# (label, moe changes, x shape, moe_ffn options); cf = E/k keeps every pair
FFN_CASES = [
    ("dense", {}, (2, 16), dict(dispatch="dense")),
    ("no_drops", {}, (2, 16), dict(group=32, capacity_factor=2.0)),
    ("drops_cf0.25", {}, (2, 16), dict(group=32, capacity_factor=0.25)),
    ("drops_cf1.25", {}, (2, 16), dict(group=32, capacity_factor=1.25)),
    ("group8", {}, (1, 32), dict(group=8, capacity_factor=2.0)),
    ("group16", {}, (1, 32), dict(group=16, capacity_factor=2.0)),
    ("group32", {}, (1, 32), dict(group=32, capacity_factor=2.0)),
    ("group8_drops", {}, (1, 32), dict(group=8, capacity_factor=1.25)),
    # decode over 8 slots of Mixtral's 8 experts: cap = round(2.5) = 2
    ("decode_half_even", {"num_experts": 8}, (8, 1), {}),
    ("default_group", {}, (2, 24), {}),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("label,moe,shape,opts", FFN_CASES,
                         ids=[c[0] for c in FFN_CASES])
def test_moe_ffn_matches_reference(label, moe, shape, opts, dtype):
    jcfg, tcfg = _pair(moe=moe)
    jp, tp = _moe_weights(jcfg, seed=len(label))
    jx, tx = _both(_x((*shape, tcfg.d_model), len(label)), dtype)
    want, jaux = jmoe.moe_ffn(jp, jcfg, jx, **opts)
    got, taux = tmoe.moe_ffn(tp, tcfg, tx, **opts)
    assert got.dtype == tx.dtype and taux.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **TOL[dtype])
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    _, ti, _, _ = jmoe._router(jp, jcfg, jx)
    _, tti, _ = tmoe._router(tp, tcfg, tx)
    np.testing.assert_array_equal(tti.numpy(), np.asarray(ti))


def test_decode_capacity_rounds_half_to_even_and_drops():
    """At 8 slots, 8 experts and top-2 the bucket holds round(2.5) = 2
    pairs (half up would give 3), and the case above does drop pairs."""
    assert tmoe.capacity(2, 8, 8, 1.25) == 2
    assert tmoe.capacity(2, 24, 8, 1.25) == 8       # round(7.5) = 8
    assert tmoe.capacity(2, 32, 4, 0.25) == 4       # round(4.0), >= k
    assert tmoe.capacity(2, 4, 4, 8.0) == 4         # clamped to the group
    jcfg, tcfg = _pair(moe={"num_experts": 8})
    jp, tp = _moe_weights(jcfg, seed=len("decode_half_even"))
    tx = torch.from_numpy(_x((8, 1, tcfg.d_model), len("decode_half_even")))
    _, ti, _ = tmoe._router(tp, tcfg, tx)
    _, keep = tmoe.bucket_positions(ti.reshape(1, 8, 2), 8, 2)
    assert not bool(keep.all())


@pytest.mark.parametrize("cf", [0.25, 1.25])
def test_zeroed_router_ties_break_toward_the_lower_index(cf):
    jcfg, tcfg = _pair()
    E, k = tcfg.moe.num_experts, tcfg.moe.top_k
    jp, tp = _moe_weights(jcfg, seed=11)
    jp["router"] = np.zeros_like(jp["router"])
    tp["router"] = torch.zeros_like(tp["router"])
    jx, tx = _both(_x((2, 16, tcfg.d_model), 12), "float32")
    _, jti, _, jaux = jmoe._router(jp, jcfg, jx)
    _, tti, taux = tmoe._router(tp, tcfg, tx)
    np.testing.assert_array_equal(tti.numpy(), np.asarray(jti))
    assert (tti.numpy() == np.arange(k)).all()     # every token: 0 and 1
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    np.testing.assert_allclose(float(taux), tcfg.moe.load_balance_coef,
                               rtol=1e-5)
    group = 32
    cap = tmoe.capacity(k, group, E, cf)
    ti = tti.reshape(1, group, k)
    pos, keep = tmoe.bucket_positions(ti, E, cap)
    for want_pos, want_keep in (_reference_positions(ti.numpy(), E, cap),
                                _loop_positions(ti.numpy(), E, cap)):
        np.testing.assert_array_equal(pos.numpy(), want_pos)
        np.testing.assert_array_equal(keep.numpy(), want_keep)
    assert not bool(keep.all())                    # pairs were dropped
    want, _ = jmoe.moe_ffn(jp, jcfg, jx, group=group, capacity_factor=cf)
    got, _ = tmoe.moe_ffn(tp, tcfg, tx, group=group, capacity_factor=cf)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL["float32"])


def test_top_k_matches_lax_top_k_on_ties():
    probs = np.array([[.25, .25, .25, .25], [.1, .3, .3, .3]], np.float32)
    vals, idx = tmoe.top_k_lower_index(torch.from_numpy(probs), 2)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(idx.numpy(), [[0, 1], [1, 2]])
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


@pytest.mark.parametrize("dispatch", ["dense", "capacity"])
def test_arctic_dense_residual_matches_reference(dispatch):
    jcfg, tcfg = _pair("arctic-480b")
    assert tcfg.moe.dense_residual and tcfg.moe.num_experts == 4
    jp, tp = _moe_weights(jcfg, seed=6)
    assert sorted(tp) == sorted(jp) and "dense_wi" in tp
    jx, tx = _both(_x((2, 8, tcfg.d_model), 7), "float32")
    want, jaux = jmoe.moe_ffn(jp, jcfg, jx, dispatch=dispatch)
    got, taux = tmoe.moe_ffn(tp, tcfg, tx, dispatch=dispatch)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL["float32"])
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    no_res, _ = tmoe.moe_ffn(
        {k: v for k, v in tp.items() if not k.startswith("dense_")},
        dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, dense_residual=False)), tx, dispatch=dispatch)
    assert float((got - no_res).abs().max()) > 1e-4


def test_unknown_dispatch_and_ragged_groups_raise():
    _, tcfg = _pair()
    tp = tmoe.init_moe_params(tcfg, torch.Generator().manual_seed(0))
    x = torch.zeros((1, 12, tcfg.d_model))
    with pytest.raises(ValueError, match="dispatch"):
        tmoe.moe_ffn(tp, tcfg, x, dispatch="bogus")
    with pytest.raises(ValueError, match="groups of 8"):
        tmoe.moe_ffn(tp, tcfg, x, group=8)


# ---------------------------------------------------------------------------
# the transformer
# ---------------------------------------------------------------------------


def test_param_counts_and_init_layout_are_the_reference_s():
    for name in list_archs():
        tcfg = get_arch(name)
        if not hasattr(tcfg, "param_counts"):
            continue                                  # dual encoders
        assert tcfg.param_counts() == jax_get_arch(name).param_counts(), \
            name
    mix = get_arch("mixtral-8x22b").param_counts()
    assert mix["total"] > 3 * mix["active"]
    # the smoke variant's leaves: shapes, dtypes and paths
    jcfg, tcfg = _pair()
    jp, _ = _lm_weights(jcfg)
    tp = ttf.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert {p: tuple(x.shape) for p, x in leaves(tp)} == \
        {p: tuple(x.shape) for p, x in leaves(jp)}
    assert tuple(tp["blocks"][0]["moe"]["wi"].shape) == (2, 4, 256, 512)
    assert ttf.period_of(tcfg) == 1
    assert tcfg.moe_layer_mask() == jcfg.moe_layer_mask() == (True, True)


def _grad_paths(tree):
    return dict(leaves(tree))


@pytest.mark.parametrize("dispatch", ["dense", "capacity"])
def test_lm_loss_and_grads_match_reference(dispatch):
    jcfg, tcfg = _pair()
    jp, tp = _lm_weights(jcfg, seed=1)
    toks = np.random.default_rng(2).integers(4, tcfg.vocab, (2, 32)).astype(
        np.int32)
    margs = {"dispatch": dispatch, "group": 32, "capacity_factor": 1.25}

    def jloss(p):
        return jtf.lm_loss(jcfg, p, {"tokens": jnp.asarray(toks)},
                           moe_args=margs)
    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    tl, tm, tg = tsteps.value_and_grad(
        lambda p: ttf.lm_loss(tcfg, p, {"tokens": torch.from_numpy(toks)},
                              moe_args=margs), tp)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tm["xent"]), float(jm["xent"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["aux"]), float(jm["aux"]),
                               rtol=1e-5)
    assert float(tm["aux"]) > 0
    got, want = _grad_paths(tg), _grad_paths(jax.device_get(jg))
    assert sorted(got) == sorted(want)
    for path, g in got.items():
        w = np.asarray(want[path])
        err = np.abs(g.numpy() - w).max()
        assert err <= GRAD_REL * np.abs(w).max(), (path, err)
    assert np.abs(got["blocks/0/moe/router"].numpy()).max() > 0


def _close_caches(tc, jc):
    for got, want in zip(interop.caches_to_numpy(tc), jc):
        np.testing.assert_allclose(got.k, np.asarray(want.k),
                                   **TOL["float32"])
        np.testing.assert_allclose(got.v, np.asarray(want.v),
                                   **TOL["float32"])


def _prefill_and_decode(jcfg, tcfg, jp, tp, toks, plen, clen, steps,
                        margs):
    """Prefill ``toks[:, :plen]`` into caches of ``clen`` and decode
    ``steps`` teacher-forced tokens on both sides, comparing logits at
    every step and the caches at the ends."""
    jl, jc = jtf.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :plen])},
                         dtype=jnp.float32, moe_args=margs,
                         collect_cache_len=clen)
    tl, tc = ttf.prefill(tcfg, tp, {"tokens": torch.tensor(toks[:, :plen])},
                         dtype=torch.float32, moe_args=margs,
                         collect_cache_len=clen)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL["float32"])
    _close_caches(tc, jc)
    for i in range(steps):
        tok = toks[:, plen + i:plen + i + 1]
        jl, jc = jtf.decode_step(jcfg, jp, jnp.asarray(tok),
                                 jnp.int32(plen + i), jc, dtype=jnp.float32,
                                 moe_args=margs)
        tl, tc = ttf.decode_step(tcfg, tp, torch.tensor(tok), plen + i, tc,
                                 dtype=torch.float32, moe_args=margs)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   **TOL["float32"])
    _close_caches(tc, jc)


# (label, config changes, moe changes, prompt, cache, batch)
LM_CASES = [
    ("linear", {}, {}, 12, CACHE_LEN, 4),
    # a prompt past the smoke window of 64 into a ring of 64: wrapped at
    # prefill and wrapping on while decoding
    ("ring", {}, {}, 70, 64, 2),
    ("pallas", dict(attn_impl="pallas"), {}, 12, CACHE_LEN, 4),
    # MoE on every other layer: a period of 2, a dense FFN at layer 0
    ("every2", {}, {"every": 2}, 12, CACHE_LEN, 4),
]


@pytest.mark.parametrize("margs", [DENSE, CAPACITY], ids=["dense",
                                                          "capacity"])
@pytest.mark.parametrize("label,changes,moe,plen,clen,b", LM_CASES,
                         ids=[c[0] for c in LM_CASES])
def test_prefill_and_decode_match_reference(label, changes, moe, plen, clen,
                                            b, margs):
    jcfg, tcfg = _pair(moe=moe, **changes)
    jp, tp = _lm_weights(jcfg, seed=len(label))
    if moe.get("every") == 2:
        assert ttf.period_of(tcfg) == 2 and "ffn" in tp["blocks"][0] \
            and "moe" in tp["blocks"][1]
    toks = np.random.default_rng(len(label)).integers(
        4, tcfg.vocab, (b, plen + 9)).astype(np.int32)
    _prefill_and_decode(jcfg, tcfg, jp, tp, toks, plen, clen, 8, margs)


@pytest.fixture(scope="module")
def shared():
    """(reference cfg, port cfg, reference params, port params) of the
    Mixtral smoke variant from one set of weights."""
    jcfg, tcfg = _pair()
    jp, tp = _lm_weights(jcfg, seed=5)
    return jcfg, tcfg, jp, tp


def _prompts(seed, vocab, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(4, vocab, (n,)).astype(np.int32) for n in lens]


@pytest.mark.parametrize("margs", [DENSE, CAPACITY], ids=["dense",
                                                          "capacity"])
def test_lockstep_engine_matches_reference(shared, margs):
    jcfg, tcfg, jp, tp = shared
    prompts = np.stack(_prompts(3, tcfg.vocab, [8, 8, 8]))
    want = JaxEngine(jcfg, jp, cache_len=CACHE_LEN, moe_args=margs
                     ).generate(prompts, 6, temperature=0.0)
    eng = Engine(tcfg, tp, cache_len=CACHE_LEN, moe_args=margs)
    assert eng.moe_args == margs
    np.testing.assert_array_equal(eng.generate(prompts, 6, temperature=0.0),
                                  want)


# Arctic's smoke variant served with an expert share, as a card of a
# deployment that splits each layer's experts holds it: the port draws
# and computes experts 1-2 of the 4 (``interop.cut_experts``); the
# reference, which has no share, computes the whole layer from the same
# weights with every expert outside the share giving zeros (its ``wo``
# zeroed), so that both route over all 4, count the capacity over all 4
# and add the dense residual once
ARCTIC_SHARE = (1, 2)


@pytest.fixture(scope="module")
def arctic_share():
    """(reference cfg, port cfg, reference params with the experts outside
    ``ARCTIC_SHARE`` silenced, the port's share of them) of Arctic's smoke
    variant."""
    jcfg, tcfg = _pair("arctic-480b")
    jp, _ = _lm_weights(jcfg, seed=6)
    first, count = ARCTIC_SHARE
    for block in jp["blocks"]:
        if "moe" in block:
            wo = np.array(block["moe"]["wo"])
            wo[:, :first] = 0
            wo[:, first + count:] = 0
            block["moe"]["wo"] = wo
    tp = interop.from_numpy(interop.cut_experts(jp, ARCTIC_SHARE), "cpu")
    return jcfg, tcfg, jp, tp


ENGINE_CASES = [("shared", DENSE), ("shared", CAPACITY),
                ("arctic_share", DENSE), ("arctic_share", CAPACITY)]


@pytest.mark.parametrize("model,margs", ENGINE_CASES,
                         ids=["dense", "capacity", "arctic-share-dense",
                              "arctic-share-capacity"])
def test_continuous_engine_matches_reference(model, margs, request):
    """Same arrivals and slots on both sides: 5 ragged requests through 2
    slots, so slots are reused and stand idle; under capacity dispatch an
    idle slot's token 0 and a batch-mate take bucket places. Mixtral's
    smoke variant, and Arctic's with an expert share (``arctic_share``:
    the port computes its 2 experts and the dense residual, the reference
    the whole layer whose other experts give zeros)."""
    jcfg, tcfg, jp, tp = request.getfixturevalue(model)
    share = {"experts": ARCTIC_SHARE} if model == "arctic_share" else {}
    if share:
        held = [b["moe"]["wo"].shape[1] for b in tp["blocks"] if "moe" in b]
        assert tcfg.moe.dense_residual and held and \
            set(held) == {ARCTIC_SHARE[1]}
    budgets = [5, 3, 6, 2, 4]
    reqs = [(p, m, i) for i, (p, m) in enumerate(zip(
        _prompts(4, tcfg.vocab, [8, 5, 8, 12, 5]), budgets))]
    want = JaxContinuousEngine(jcfg, jp, cache_len=CACHE_LEN, num_slots=2,
                               moe_args=margs).run(reqs)
    ce = ContinuousEngine(tcfg, tp, cache_len=CACHE_LEN, num_slots=2,
                          moe_args=dict(margs, **share))
    got = ce.run(reqs)
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid], err_msg=rid)


def test_engines_store_moe_args_as_the_reference():
    _, tcfg = _pair()
    tp = ttf.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert Engine(tcfg, tp, cache_len=8).moe_args == {}
    assert ContinuousEngine(tcfg, tp, cache_len=8, num_slots=1,
                            moe_args=None).moe_args == {}
    args = tserve.parse_args(["--arch", "mixtral-8x22b", "--smoke"])
    assert tserve.moe_args_for(args) == DENSE
    args = tserve.parse_args(["--arch", "mixtral-8x22b"])
    assert tserve.moe_args_for(args) is None


@pytest.mark.parametrize("engine", ["legacy", "continuous"])
def test_launcher_serves_mixtral_on_the_cpu(engine, capsys):
    rep = tserve.main(["--arch", "mixtral-8x22b", "--smoke", "--device",
                       "cpu", "--engine", engine, "--requests", "3",
                       "--slots", "2", "--batch", "2", "--prompt-len", "70",
                       "--max-new", "4", "--cache-len", "64", "--attn",
                       "pallas"])
    assert "tok/s" in capsys.readouterr().out and rep["device"] == "cpu"
    toks = (np.concatenate(list(rep["results"].values()))
            if engine == "continuous" else rep["tokens"])
    assert ((toks >= 0) & (toks < 512)).all()


def test_step_factories_default_dispatch():
    """Train and prefill steps default to capacity dispatch, the decode
    step to dense, as the reference's factories (f32: in bf16 the
    reference's jitted forward of this model is itself ~0.3 off its eager
    one on these logits, XLA rounding other intermediates)."""
    jcfg, tcfg = _pair()
    jp, tp = _lm_weights(jcfg, seed=8)
    toks = np.random.default_rng(9).integers(4, tcfg.vocab, (2, 24)).astype(
        np.int32)
    margs = dict(tsteps.DEFAULT_MOE_ARGS, group=16, capacity_factor=0.5)
    want = jtf.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                       precision="f32", moe_args=margs)
    got = tsteps.make_prefill_step(tcfg, precision="f32", moe_args=margs)(
        tp, {"tokens": torch.tensor(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **TOL["float32"])
    default = tsteps.make_prefill_step(tcfg, precision="f32")(
        tp, {"tokens": torch.tensor(toks)})
    np.testing.assert_allclose(default.numpy(), np.asarray(jtf.prefill(
        jcfg, jp, {"tokens": jnp.asarray(toks)}, precision="f32",
        moe_args=tsteps.DEFAULT_MOE_ARGS)), **TOL["float32"])
    assert float((default - got).abs().max()) > 1e-3   # drops at cf 0.5
    caches = ttf.init_caches(tcfg, 2, CACHE_LEN, torch.float32, device="cpu")
    jcaches = jtf.init_caches(jcfg, 2, CACHE_LEN, jnp.float32)
    tok = toks[:, :1]
    got, _ = tsteps.make_serve_step(tcfg, precision="f32")(
        tp, caches, torch.tensor(tok), 0)
    want, _ = jtf.decode_step(jcfg, jp, jnp.asarray(tok), jnp.int32(0),
                              jcaches, precision="f32", moe_args=DENSE)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **TOL["float32"])


def test_lm_command_line_trains_mixtral_smoke(capsys):
    from repro_torch.launch import train as ttrain
    rep = ttrain.main(["--mode", "lm", "--arch", "mixtral-8x22b", "--smoke",
                       "--device", "cpu", "--steps", "2", "--batch", "2",
                       "--seq", "16"])
    assert "loss" in capsys.readouterr().out
    assert all(np.isfinite(rep["losses"]))


# ---------------------------------------------------------------------------
# checkpoints of a MoE tree, both ways
# ---------------------------------------------------------------------------


def test_moe_checkpoint_crosses_packages(tmp_path, shared):
    jcfg, _, jp, tp = shared
    jckpt.save(str(tmp_path / "j"), 3, jp)
    got = ckpt.restore(str(tmp_path / "j"), 3, _meta_like(tp), device="cpu")
    _assert_trees_equal(got, tp)
    ckpt.save(str(tmp_path / "t"), 3, tp)
    back = jckpt.restore(str(tmp_path / "t"), 3,
                         jax.eval_shape(lambda: jp))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert _np_bits(a) == _np_bits(b)
    with open(tmp_path / "t" / "step_00000003" / "index.json") as f:
        it = json.load(f)
    with open(tmp_path / "j" / "step_00000003" / "index.json") as f:
        ij = json.load(f)
    assert it["treedef"] == ij["treedef"] == \
        str(jax.tree_util.tree_structure(jp))
    assert "'moe'" in it["treedef"] and it["leaves"] == ij["leaves"]


# ---------------------------------------------------------------------------
# Arctic's training: the dense residual's gradients, and the expert share
# ---------------------------------------------------------------------------

EXPERT_LEAVES = ("wi", "wg", "wo")


@pytest.fixture(scope="module")
def arctic_whole():
    """(reference cfg, port cfg, reference params, the same params in the
    port) of Arctic's smoke variant, every expert held; the weights are
    ``arctic_share``'s before its cut and its silencing."""
    jcfg, tcfg = _pair("arctic-480b")
    jp, tp = _lm_weights(jcfg, seed=6)
    return jcfg, tcfg, jp, tp


ARCTIC_MODELS = ["arctic_whole", "arctic_share"]


def _arctic(model, request):
    """The fixture ``model`` and its share (None for the whole layer)."""
    share = ARCTIC_SHARE if model == "arctic_share" else None
    return (*request.getfixturevalue(model), share)


def _cut(tree, share):
    """A reference tree (numpy) cut to ``share``; as it is without one."""
    return tree if share is None else interop.cut_experts(tree, share)


def _is_expert(path):
    return "/moe/" in path and path.rsplit("/", 1)[-1] in EXPERT_LEAVES


@pytest.mark.parametrize("dispatch", ["dense", "capacity"])
@pytest.mark.parametrize("model", ARCTIC_MODELS, ids=["whole", "share"])
def test_arctic_lm_loss_and_grads_match_reference(model, dispatch, request):
    """Arctic's ``lm_loss`` and every gradient leaf, the dense residual's
    included, against the reference's ``jax.value_and_grad``; under the
    share the port's gradients against the reference's cut to it (its
    silenced experts' ``wi`` and ``wg`` get no gradient, their ``wo`` do:
    the cut drops both), every leaf outside the experts (router,
    attention, dense residual, norms, embedding, head) whole."""
    jcfg, tcfg, jp, tp, share = _arctic(model, request)
    toks = np.random.default_rng(2).integers(4, tcfg.vocab, (2, 32)).astype(
        np.int32)
    margs = {"dispatch": dispatch, "group": 32, "capacity_factor": 1.25}
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jtf.lm_loss(jcfg, p, {"tokens": jnp.asarray(toks)},
                              moe_args=margs), has_aux=True)(jp)
    targs = margs if share is None else dict(margs, experts=share)
    tl, tm, tg = tsteps.value_and_grad(
        lambda p: ttf.lm_loss(tcfg, p, {"tokens": torch.from_numpy(toks)},
                              moe_args=targs), tp)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tm["xent"]), float(jm["xent"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["aux"]), float(jm["aux"]),
                               rtol=1e-5)
    got = _grad_paths(tg)
    want = _grad_paths(_cut(jax.device_get(jg), share))
    assert sorted(got) == sorted(want)
    for path, g in got.items():
        w = np.asarray(want[path])
        assert g.shape == w.shape, path
        err = np.abs(g.numpy() - w).max()
        assert err <= GRAD_REL * np.abs(w).max(), (path, err)
    held = ARCTIC_SHARE[1] if share else tcfg.moe.num_experts
    for i, block in enumerate(tg["blocks"]):
        assert block["moe"]["wi"].shape[1] == held
        for name in ("dense_wi", "dense_wg", "dense_wo", "router"):
            assert float(block["moe"][name].abs().max()) > 0, (i, name)


def _first_update(opt, grads, params, lr):
    """The reference's AdaFactorW update of ``params`` (numpy) from fresh
    slots by ``grads``: the new params, numpy."""
    jparams = jax.tree.map(jnp.asarray, params)
    upd, _ = opt.update(jax.tree.map(jnp.asarray, grads), opt.init(jparams),
                        jparams, 1e-3)
    return jax.device_get(jax.tree.map(lambda p, u: p + u, jparams, upd))


def _update_rms(grads, params):
    """Per expert leaf path, the RMS of the reference's first AdaFactorW
    update before its clip (``clip_threshold`` 1, which divides the update
    by max(1, RMS)): the update taken with the clip off, less its weight
    decay, over lr."""
    from repro.optim.adafactorw import AdaFactorW as JaxAdaFactorW
    wd = 0.0025
    unclipped = _first_update(JaxAdaFactorW(beta1=0.9, beta2=0.99,
                                            weight_decay=wd,
                                            clip_threshold=np.inf),
                              grads, params, 1e-3)
    new, old = _grad_paths(unclipped), _grad_paths(params)
    return {path: float(np.sqrt(np.mean(
        ((new[path] - old[path]) / -1e-3 - wd * old[path]) ** 2)))
        for path in new if _is_expert(path)}


@pytest.mark.parametrize("model", ARCTIC_MODELS, ids=["whole", "share"])
def test_arctic_make_train_step_f32_matches_reference(model, request,
                                                      monkeypatch):
    """One f32 ``make_train_step`` of smoke Arctic (capacity dispatch,
    remat 'basic') against the reference's: the loss, and every updated
    leaf within 1e-3 of the change the step made. The share reaches every
    MoE call, the remat recompute's included.

    Under the share, by design: AdaFactorW clips each update by its RMS
    over the whole leaf, and a share's ``wi``, ``wg``, ``wo`` hold 2 of the
    4 experts (the reference's silenced two give ``wi`` and ``wg`` zero
    updates, ``wo`` updates of their own). So the expert leaves are held
    to the reference's AdaFactorW on the reference's gradients cut to the
    share, and the reference's own whole-leaf update, cut, differs from it
    by the ratio of the two clips, max(1, RMS over the share) / max(1, RMS
    over the whole leaf), which this pins."""
    jcfg, tcfg, jp, tp, share = _arctic(model, request)
    toks = np.random.default_rng(3).integers(4, tcfg.vocab, (2, 32)).astype(
        np.int32)
    jbatch = {"tokens": jnp.asarray(toks)}
    jstep, jopt = jsteps.make_train_step(jcfg, remat="basic",
                                         precision="f32")
    jparams = jax.tree.map(jnp.asarray, jp)
    jnew, _, jl, _ = jax.jit(jstep)(jparams, jopt.init(jparams), jbatch)
    seen = []
    ffn = tmoe.moe_ffn

    def recorded(*args, **kw):
        seen.append(kw.get("experts"))
        return ffn(*args, **kw)
    monkeypatch.setattr(tmoe, "moe_ffn", recorded)
    margs = None if share is None else dict(tsteps.DEFAULT_MOE_ARGS,
                                            experts=share)
    step, opt = tsteps.make_train_step(tcfg, precision="f32", moe_args=margs)
    new, _, loss, _ = step(tp, opt.init(tp),
                           {"tokens": torch.from_numpy(toks)})
    # each layer's forward, then its recompute in the backward
    assert seen == [share] * (2 * tcfg.n_layers)
    assert float(loss) == pytest.approx(float(jl), rel=1e-5)
    got = _paths(new)
    ref = _grad_paths(_cut(jax.device_get(jnew), share))
    init = _grad_paths(_cut(jp, share))
    outside = {p for p in got if not _is_expert(p)}
    assert len(outside) < len(got)
    _assert_change_close({p: got[p] for p in outside},
                         {p: ref[p] for p in outside},
                         {p: init[p] for p in outside}, 1e-3)
    experts = set(got) - outside
    if share is None:
        _assert_change_close({p: got[p] for p in experts},
                             {p: ref[p] for p in experts}, init, 1e-3)
        return
    (_, _), jg = jax.value_and_grad(
        lambda p: jtf.lm_loss(jcfg, p, jbatch, precision="f32",
                              moe_args=tsteps.DEFAULT_MOE_ARGS),
        has_aux=True)(jparams)
    grads = jax.device_get(jg)
    cut_g, cut_p = _cut(grads, share), _cut(jp, share)
    want = _grad_paths(_first_update(jopt, cut_g, cut_p, 1e-3))
    _assert_change_close({p: got[p] for p in experts},
                         {p: want[p] for p in experts}, init, 1e-3)
    # the reference's whole leaf against the share: the clips' ratio
    rms_share, rms_whole = _update_rms(cut_g, cut_p), _update_rms(grads, jp)
    # on this step the clip binds over the share: the difference shows
    assert max(rms_share.values()) > 1 + 1e-2
    for path in experts:
        ratio = max(1.0, rms_share[path]) / max(1.0, rms_whole[path])
        step_share = want[path] - init[path]
        # the share's step with its update scaled by the ratio, its weight
        # decay (-lr·wd·p) as it is
        decay = -1e-3 * 0.0025 * init[path]
        rebuilt = init[path] + (step_share - decay) * ratio + decay
        gap = np.linalg.norm(ref[path] - rebuilt)
        assert gap <= 1e-3 * np.linalg.norm(ref[path] - init[path]), path
        print(f"{path}: update RMS over the share {rms_share[path]:.6f}, "
              f"over the whole leaf {rms_whole[path]:.6f}, clip ratio "
              f"{ratio:.6f}")
