"""Port parity: the hybrid family (Jamba-1.5-Large) and the MoE expert share
against the JAX reference on the CPU, from the same weights (carried over
with ``interop.from_numpy``) and the same inputs, drawn with numpy from a
seed.

- The config: fields, ``layer_kinds``, ``moe_layer_mask``, ``period_of``,
  ``param_counts``, ``smoke_variant`` and ``applicable_shapes`` are the
  reference's.
- Two small hybrid configs: the reference's smoke variant (attention every
  2 layers, MoE every 2: a period of 2, a Mamba block with a dense FFN and
  an attention block with the MoE FFN), and a 4-layer variant with
  attention every 4 (a period of 4, so Mamba blocks carry a MoE FFN too).
  On both, under dense and capacity dispatch: ``lm_loss`` and every
  gradient, ``prefill`` logits and the mixed caches (``SSMCache``s beside
  ``KVCache``s), teacher-forced ``decode_step`` logits, and both engines
  token for token against the reference's.
- The mixed cache list through ``caches_from_numpy`` / ``caches_to_numpy``;
  the launcher and the trainer at smoke size; Jamba's mixer widths keep
  the scan's input views in whole 16-byte units (no copy).
- The expert share: shares (0, 2) + (2, 2) and four shares of 1 sum to the
  reference's whole layer under both dispatches (Arctic's dense residual,
  which every share adds, counted once); a share of every expert is the
  unshared port bit for bit; ``interop.cut_experts`` of a reference tree
  is the share's weights; a wrong share raises.

The reference's Pallas calls (``attn_impl="pallas"``) run in interpret
mode, as its own tests run them. Tolerances: f32 rtol 2e-4, atol 1e-5
(the reference's MoE tolerance, tests/test_moe.py; fp32 sums in another
order, through the scan in another order too); gradients per leaf within
1e-4 of the leaf's largest |gradient| (the MoE parity tests' rule); the
shares' sum rtol 2e-4, atol 1e-5 against the reference (each share rounds
its own partial sum), and bit for bit where the arithmetic is the same.
Logits are compared in f32: in bf16 the reference's jitted MoE forward is
itself ~0.3 off its eager one on smoke logits (tests/test_torch_moe.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import smoke_variant as jax_smoke
from repro.configs.base import applicable_shapes as jax_applicable
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.serving import ContinuousEngine as JaxContinuousEngine
from repro.serving import Engine as JaxEngine
from repro_torch import interop
from repro_torch.configs import applicable_shapes, get_arch, smoke_variant
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttf
from repro_torch.models.attention import KVCache
from repro_torch.models.ssm import SSMCache
from repro_torch.serving import ContinuousEngine, Engine
from repro_torch.tree import leaves

torch.set_num_threads(1)

JAMBA = "jamba-1.5-large-398b"
TOL = dict(rtol=2e-4, atol=1e-5)
GRAD_REL = 1e-4
CACHE_LEN = 48
DENSE = {"dispatch": "dense"}
CAPACITY = {"dispatch": "capacity"}
DISPATCH = pytest.mark.parametrize("margs", [DENSE, CAPACITY],
                                   ids=["dense", "capacity"])
# (label, config changes): the reference's smoke variant (period 2) and
# a 4-layer variant with attention every 4 (period 4)
VARIANTS = [("smoke", {}), ("attn4", dict(n_layers=4, attn_every=4))]
VARIANT = pytest.mark.parametrize("label,changes", VARIANTS,
                                  ids=[v[0] for v in VARIANTS])


def _pair(arch=JAMBA, **changes):
    """(reference cfg, port cfg): the smoke variant of ``arch`` with
    ``changes``."""
    return (dataclasses.replace(jax_smoke(jax_get_arch(arch)), **changes),
            dataclasses.replace(smoke_variant(get_arch(arch)), **changes))


def _lm_weights(jcfg, seed=0):
    jp = jax.device_get(jtf.init_params(jcfg, jax.random.key(seed)))
    return jp, interop.from_numpy(jp, "cpu")


def _tokens(seed, vocab, shape):
    return np.random.default_rng(seed).integers(4, vocab, shape).astype(
        np.int32)


def _np(t):
    return t.detach().float().numpy()


# ---------------------------------------------------------------------------
# the config
# ---------------------------------------------------------------------------


def test_config_matches_the_reference():
    j, t = jax_get_arch(JAMBA), get_arch(JAMBA)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.layer_kinds() == j.layer_kinds()
    assert t.layer_kinds()[:8] == ("mamba",) * 7 + ("attn",)
    assert t.moe_layer_mask() == j.moe_layer_mask()
    assert t.moe_layer_mask()[:8] == (False, True) * 4
    assert ttf.period_of(t) == jtf.period_of(j) == 8
    assert t.param_counts() == j.param_counts()
    assert round(t.param_counts()["total"] / 1e9) == 398
    ts, js = smoke_variant(t), jax_smoke(j)
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    assert ts.attn_every == 2 and ttf.period_of(ts) == jtf.period_of(js) == 2
    assert ts.layer_kinds() == js.layer_kinds() == ("mamba", "attn")
    assert ts.param_counts() == js.param_counts()
    assert [s.name for s in applicable_shapes(t)] == \
        [s.name for s in jax_applicable(j)] == \
        ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
    for _, changes in VARIANTS:
        jc, tc = _pair(**changes)
        assert tc.layer_kinds() == jc.layer_kinds()
        assert tc.moe_layer_mask() == jc.moe_layer_mask()
        assert ttf.period_of(tc) == jtf.period_of(jc)
        assert tc.param_counts() == jc.param_counts()


def test_param_counts_count_two_per_head_leaves_as_the_reference():
    """The reference counts 2·heads per-head parameters of a Mamba mixer,
    though it holds three per-head leaves (A_log, D, dt_bias); the port
    reproduces the formula (ROADMAP.md Queue 3, reference behaviours)."""
    jcfg, tcfg = _pair()
    _, tp = _lm_weights(jcfg)
    held = sum(x.numel() for path, x in leaves(tp)
               if "/router" not in path)
    heads = tssm.dims(tcfg)[1]
    mamba_layers = tcfg.layer_kinds().count("mamba")
    assert tcfg.param_counts()["total"] == held - heads * mamba_layers


# ---------------------------------------------------------------------------
# the hybrid LM against the reference
# ---------------------------------------------------------------------------


@DISPATCH
@VARIANT
def test_params_and_lm_loss_and_grads_match_reference(label, changes,
                                                      margs):
    jcfg, tcfg = _pair(**changes)
    jp, tp = _lm_weights(jcfg, seed=1)
    own = ttf.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert {p: tuple(x.shape) for p, x in leaves(own)} == \
        {p: tuple(x.shape) for p, x in leaves(jp)}
    if label == "attn4":
        assert "moe" in tp["blocks"][1] and "mamba" in tp["blocks"][1]
    toks = _tokens(2, tcfg.vocab, (2, 32))
    margs = dict(margs, group=32, capacity_factor=1.25)

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
    got, want = dict(leaves(tg)), dict(leaves(jax.device_get(jg)))
    assert sorted(got) == sorted(want)
    for path, g in got.items():
        w = np.asarray(want[path])
        err = np.abs(g.numpy() - w).max()
        assert err <= GRAD_REL * np.abs(w).max(), (path, err)
    assert np.abs(got["blocks/0/mamba/in_x"].numpy()).max() > 0


def _close_caches(tc, jc):
    """The port's caches against the reference's, leaf by leaf, the two
    kinds side by side in one list."""
    got = interop.caches_to_numpy(tc)
    assert [type(c).__name__ for c in got] == \
        [type(c).__name__ for c in jc]
    for g, w in zip(got, jc):
        for a, b in zip(g, w):
            np.testing.assert_allclose(a, np.asarray(b), **TOL)


@DISPATCH
@pytest.mark.parametrize("plen", [12, 64], ids=["one_chunk", "two_chunks"])
@VARIANT
def test_prefill_and_decode_match_reference(label, changes, plen, margs):
    """Prefill (one ragged SSD chunk, or two whole ones) into mixed caches,
    then 8 teacher-forced decode steps: logits at every step and the
    caches at both ends."""
    jcfg, tcfg = _pair(attn_impl="pallas", **changes)
    jp, tp = _lm_weights(jcfg, seed=len(label) + plen)
    toks = _tokens(plen, tcfg.vocab, (3, plen + 9))
    jl, jc = jtf.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :plen])},
                         dtype=jnp.float32, moe_args=margs,
                         collect_cache_len=CACHE_LEN + plen)
    tl, tc = ttf.prefill(tcfg, tp, {"tokens": torch.tensor(toks[:, :plen])},
                         dtype=torch.float32, moe_args=margs,
                         collect_cache_len=CACHE_LEN + plen)
    assert {type(c) for c in tc} == {KVCache, SSMCache}
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _close_caches(tc, jc)
    for i in range(8):
        tok = toks[:, plen + i:plen + i + 1]
        jl, jc = jtf.decode_step(jcfg, jp, jnp.asarray(tok),
                                 jnp.int32(plen + i), jc, dtype=jnp.float32,
                                 moe_args=margs)
        tl, tc = ttf.decode_step(tcfg, tp, torch.tensor(tok), plen + i, tc,
                                 dtype=torch.float32, moe_args=margs)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _close_caches(tc, jc)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@VARIANT
def test_init_caches_are_the_reference_s(label, changes, dtype):
    jcfg, tcfg = _pair(**changes)
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    want = jtf.init_caches(jcfg, 3, CACHE_LEN, jd)
    got = ttf.init_caches(tcfg, 3, CACHE_LEN, getattr(torch, dtype),
                          device="cpu")
    assert [type(c).__name__ for c in got] == \
        [type(c).__name__ for c in want]
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert tuple(a.shape) == b.shape
            assert str(a.dtype).split(".")[-1] == str(b.dtype)
            assert not bool(a.any())


def test_mixed_caches_round_trip_through_numpy():
    jcfg, tcfg = _pair(**VARIANTS[1][1])
    jp, tp = _lm_weights(jcfg, seed=3)
    toks = _tokens(4, tcfg.vocab, (2, 20))
    _, jc = jtf.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                        dtype=jnp.float32, collect_cache_len=CACHE_LEN)
    jc = jax.device_get(jc)
    tc = interop.caches_from_numpy(jc, "cpu")
    assert [type(c) for c in tc] == [SSMCache] * 3 + [KVCache]
    back = interop.caches_to_numpy(tc)
    for g, w in zip(back, jc):
        assert type(g).__name__ == type(w).__name__
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, np.asarray(b))
    # a bf16 list comes back widened to f32, exactly
    half = [type(c)(*(x if name == "ssm" else x.to(torch.bfloat16)
                      for name, x in zip(c._fields, c))) for c in tc]
    again = interop.caches_from_numpy(interop.caches_to_numpy(half), "cpu")
    for a, b in zip(again, half):
        for x, y in zip(a, b):
            assert torch.equal(x.to(y.dtype), y)


@pytest.fixture(scope="module", params=[v[0] for v in VARIANTS])
def shared(request):
    """(reference cfg, port cfg, reference params, port params) of a
    small hybrid config from one set of weights."""
    jcfg, tcfg = _pair(**dict(VARIANTS)[request.param])
    jp, tp = _lm_weights(jcfg, seed=5)
    return jcfg, tcfg, jp, tp


@DISPATCH
def test_lockstep_engine_matches_reference(shared, margs):
    jcfg, tcfg, jp, tp = shared
    prompts = _tokens(3, tcfg.vocab, (3, 12))
    want = JaxEngine(jcfg, jp, cache_len=CACHE_LEN, moe_args=margs
                     ).generate(prompts, 6, temperature=0.0)
    got = Engine(tcfg, tp, cache_len=CACHE_LEN, moe_args=margs).generate(
        prompts, 6, temperature=0.0)
    np.testing.assert_array_equal(got, want)


@DISPATCH
def test_continuous_engine_matches_reference(shared, margs):
    """Same arrivals and slots on both sides: 5 ragged requests through 2
    slots, so slots are reused and stand idle, and both cache kinds are
    spliced at every admission."""
    jcfg, tcfg, jp, tp = shared
    rng = np.random.default_rng(4)
    budgets = [5, 3, 6, 2, 4]
    reqs = [(rng.integers(4, tcfg.vocab, (n,)).astype(np.int32), m, i)
            for i, (n, m) in enumerate(zip([8, 5, 32, 12, 5], budgets))]
    want = JaxContinuousEngine(jcfg, jp, cache_len=CACHE_LEN, num_slots=2,
                               moe_args=margs).run(reqs)
    ce = ContinuousEngine(tcfg, tp, cache_len=CACHE_LEN, num_slots=2,
                          moe_args=margs)
    got = ce.run(reqs)
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid], err_msg=rid)
    assert {type(c) for c in ce._caches} == {KVCache, SSMCache}


def test_continuous_insert_splices_both_cache_kinds():
    """A b = 1 prefill row lands in its slot of every leaf, KV and SSM
    alike, and leaves the other slots as they were."""
    _, tcfg = _pair(**VARIANTS[1][1])
    tp = ttf.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    ce = ContinuousEngine(tcfg, tp, cache_len=CACHE_LEN, num_slots=3)
    rows = [ce._prefill(_tokens(s, tcfg.vocab, (10 + s,)))[1]
            for s in range(3)]
    for slot, row in enumerate(rows):
        ce._insert(row, slot)
    for slot, row in enumerate(rows):
        for big, r in zip(ce._caches, row):
            for dst, src in zip(big, r):
                assert torch.equal(dst[:, slot], src[:, 0])
                assert bool(src[:, 0].any())


@pytest.mark.parametrize("engine", ["legacy", "continuous"])
def test_launcher_serves_jamba_on_the_cpu(engine, capsys):
    rep = tserve.main(["--arch", JAMBA, "--smoke", "--device", "cpu",
                       "--engine", engine, "--requests", "3", "--slots",
                       "2", "--batch", "2", "--prompt-len", "20",
                       "--max-new", "4", "--cache-len", "64", "--attn",
                       "pallas"])
    assert "tok/s" in capsys.readouterr().out and rep["device"] == "cpu"
    toks = (np.concatenate(list(rep["results"].values()))
            if engine == "continuous" else rep["tokens"])
    assert ((toks >= 0) & (toks < 512)).all()


def test_launcher_serves_an_expert_share():
    """``build(..., experts=)`` draws the share; ``run_continuous`` serves
    it with ``moe_args`` naming the same share."""
    cfg, params = tserve.build(JAMBA, smoke=True, device="cpu",
                               experts=(2, 2))
    assert tuple(params["blocks"][1]["moe"]["wi"].shape) == (1, 2, 256, 512)
    assert tuple(params["blocks"][1]["moe"]["router"].shape) == (1, 256, 4)
    args = tserve.parse_args(["--arch", JAMBA, "--smoke", "--requests", "2",
                              "--slots", "2", "--max-new", "3",
                              "--prompt-len", "16"])
    rep = tserve.run_continuous(cfg, params, args,
                                {"dispatch": "capacity", "experts": (2, 2)})
    assert rep["requests"] == 2
    with pytest.raises(ValueError, match="holds 2 experts"):
        tserve.run_legacy(cfg, params, args, tserve.moe_args_for(args))


def test_lm_command_line_trains_jamba_smoke(capsys):
    from repro_torch.launch import train as ttrain
    rep = ttrain.main(["--mode", "lm", "--arch", JAMBA, "--smoke",
                       "--device", "cpu", "--steps", "2", "--batch", "2",
                       "--seq", "32"])
    assert "loss" in capsys.readouterr().out
    assert all(np.isfinite(rep["losses"]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_jamba_mixer_views_need_no_copy(dtype):
    """At Jamba's widths (d_in 16384, state 128, d_conv 16640) the scan's
    x, B and C views of the conv output start at elements 0, 16384 and
    16512 and step by 16640 a token: whole 16-byte units in f32 and bf16,
    so the kernel's wrapper passes them as they are."""
    cfg = get_arch(JAMBA)
    d_in, heads, d_conv = tssm.dims(cfg)
    n = cfg.ssm.state_dim
    assert (d_in, heads, d_conv) == (16384, 256, 16640)
    buf = torch.zeros((2, 3, d_conv), dtype=dtype)
    views = (buf[..., :d_in].reshape(2, 3, heads, cfg.ssm.head_dim),
             buf[..., d_in:d_in + n], buf[..., d_in + n:])
    assert [v.storage_offset() for v in views] == [0, 16384, 16512]
    for v in views:
        assert ssd_ops._aligned(v) is v


# ---------------------------------------------------------------------------
# the expert share
# ---------------------------------------------------------------------------


def _moe_pair(arch, seed):
    jcfg, tcfg = _pair(arch)
    jp = jax.device_get(jmoe.init_moe_params(jax.random.key(seed), jcfg))
    return jcfg, tcfg, jp, interop.from_numpy(jp, "cpu")


def _share(tp, first, count):
    """The layer's weights cut to experts first .. first + count - 1."""
    return {k: (v[first:first + count] if k in ("wi", "wg", "wo") else v)
            for k, v in tp.items()}


# capacity: buckets of 4 pairs (group 16, cf 0.5) for 8 pairs an expert on
# average, so pairs are dropped
SHARE_OPTS = {"dense": dict(dispatch="dense"),
              "capacity": dict(dispatch="capacity", group=16,
                               capacity_factor=0.5)}
SHARES = {"halves": [(0, 2), (2, 2)],
          "quarters": [(0, 1), (1, 1), (2, 1), (3, 1)]}


@pytest.mark.parametrize("arch", [JAMBA, "mixtral-8x22b", "arctic-480b"])
@pytest.mark.parametrize("shares", list(SHARES))
@pytest.mark.parametrize("dispatch", list(SHARE_OPTS))
def test_shares_sum_to_the_whole_layer(arch, shares, dispatch):
    """The shares' outputs add up to the reference's whole layer, with
    Arctic's dense residual (which every share adds, as every card of the
    deployment does) counted once; each share's load-balance term is the
    whole layer's."""
    jcfg, tcfg, jp, tp = _moe_pair(arch, seed=len(arch))
    opts = SHARE_OPTS[dispatch]
    x = np.random.default_rng(7).standard_normal(
        (2, 16, tcfg.d_model)).astype(np.float32)
    want, jaux = jmoe.moe_ffn(jp, jcfg, jnp.asarray(x), **opts)
    tx = torch.from_numpy(x)
    parts = []
    for first, count in SHARES[shares]:
        out, aux = tmoe.moe_ffn(_share(tp, first, count), tcfg, tx,
                                experts=(first, count), **opts)
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
        parts.append(out)
    total = torch.stack(parts).sum(0)
    if tcfg.moe.dense_residual:
        residual = tmoe.L.swiglu(tx, tp["dense_wi"], tp["dense_wg"],
                                 tp["dense_wo"])
        assert float(residual.abs().max()) > 1e-3
        total = total - (len(parts) - 1) * residual
    np.testing.assert_allclose(_np(total), np.asarray(want), **TOL)
    if dispatch == "capacity":
        _, ti, _ = tmoe._router(tp, tcfg, tx)
        cap = tmoe.capacity(2, 16, tcfg.moe.num_experts, 0.5)
        _, keep = tmoe.bucket_positions(ti.reshape(2, 16, 2),
                                        tcfg.moe.num_experts, cap)
        assert not bool(keep.all())         # the sum holds with drops


@pytest.mark.parametrize("dispatch", list(SHARE_OPTS))
def test_share_of_every_expert_is_the_unshared_layer(dispatch):
    """``experts=(0, E)`` computes what ``experts=None`` does, bit for
    bit, in the layer and through the LM."""
    _, tcfg, _, tp = _moe_pair("mixtral-8x22b", seed=3)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 16, tcfg.d_model)).astype(np.float32))
    opts = SHARE_OPTS[dispatch]
    whole, aux = tmoe.moe_ffn(tp, tcfg, x, **opts)
    every, aux_every = tmoe.moe_ffn(tp, tcfg, x, experts=(0, 4), **opts)
    assert torch.equal(whole, every) and torch.equal(aux, aux_every)
    jcfg, lcfg = _pair()
    _, lp = _lm_weights(jcfg, seed=9)
    toks = torch.from_numpy(_tokens(9, lcfg.vocab, (2, 16)))
    a = ttf.prefill(lcfg, lp, {"tokens": toks}, dtype=torch.float32,
                    moe_args=opts)
    b = ttf.prefill(lcfg, lp, {"tokens": toks}, dtype=torch.float32,
                    moe_args=dict(opts, experts=(0, 4)))
    assert torch.equal(a, b)


def test_interop_cut_is_the_share_s_weights():
    """``cut_experts`` of a reference LM tree slices every MoE layer's
    ``wi``, ``wg``, ``wo`` after the layer axis and keeps every other leaf;
    the port draws a share with the same leaves' shapes, and a layer of
    the cut tree computes what the sliced layer does."""
    jcfg, tcfg = _pair(**VARIANTS[1][1])
    jp, tp = _lm_weights(jcfg, seed=11)
    cut = interop.cut_experts(jp, (1, 2))
    got, full = dict(leaves(cut)), dict(leaves(jp))
    assert sorted(got) == sorted(full)
    for path, x in got.items():
        if path.rsplit("/", 2)[-2:] in (["moe", "wi"], ["moe", "wg"],
                                        ["moe", "wo"]):
            np.testing.assert_array_equal(x, full[path][:, 1:3])
        else:
            assert x is full[path]
    drawn = ttf.init_params(tcfg, torch.Generator().manual_seed(0), "cpu",
                            experts=(1, 2))
    assert {p: tuple(x.shape) for p, x in leaves(drawn)} == \
        {p: tuple(np.shape(x)) for p, x in got.items()}
    tcut = interop.from_numpy(cut, "cpu")
    x = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (1, 8, tcfg.d_model)).astype(np.float32))
    layer = {k: v[0] for k, v in tcut["blocks"][1]["moe"].items()}
    sliced = _share({k: v[0] for k, v in tp["blocks"][1]["moe"].items()},
                    1, 2)
    for opts in SHARE_OPTS.values():
        a, _ = tmoe.moe_ffn(layer, tcfg, x, experts=(1, 2), **opts)
        b, _ = tmoe.moe_ffn(sliced, tcfg, x, experts=(1, 2), **opts)
        assert torch.equal(a, b)


def test_wrong_share_raises():
    _, tcfg, _, tp = _moe_pair(JAMBA, seed=2)
    x = torch.zeros((1, 4, tcfg.d_model))
    with pytest.raises(ValueError, match="holds 4 experts, the share 2"):
        tmoe.moe_ffn(tp, tcfg, x, experts=(0, 2))
    with pytest.raises(ValueError, match="holds 2 experts, the share 3"):
        tmoe.moe_ffn(_share(tp, 0, 2), tcfg, x, experts=(0, 3))
    for bad in ((3, 2), (-1, 2), (0, 0)):
        with pytest.raises(ValueError, match="not within its 4 experts"):
            tmoe.moe_ffn(_share(tp, 0, 2), tcfg, x, experts=bad)
        with pytest.raises(ValueError, match="not within its 4 experts"):
            ttf.init_params(tcfg, torch.Generator(), "cpu", experts=bad)
    with pytest.raises(ValueError, match="holds 4 experts"):
        interop.cut_experts(interop.to_numpy(ttf.init_params(
            tcfg, torch.Generator(), "cpu")), (3, 2))
