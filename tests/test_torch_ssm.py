"""Port parity: the Mamba-2 block and the SSM family's prefill and decode
against the JAX reference on the CPU, from the same weights (carried over
with ``interop.from_numpy``) and the same inputs, at the smoke config
(2 layers, d_model 256, 16 heads of 32, state 16, chunk 32).

The port's mixer runs the ``ssd_scan`` wrapper, whose CPU path is the
plain chunked scan; the reference's runs its jnp ``ssd_chunked``.
Tolerance: rtol 1e-4, atol 1e-5 on outputs, logits and caches (the LM
parity tests' own, tests/test_torch_lm.py); fp32 throughout, sums in
another order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import smoke_variant as jax_smoke
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro_torch import interop
from repro_torch.configs import get_arch, smoke_variant
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttf

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def model():
    """(reference cfg, port cfg, reference params, port params)."""
    jcfg = jax_smoke(jax_get_arch("mamba2-130m"))
    jp = jax.device_get(jtf.init_params(jcfg, jax.random.key(0)))
    return (jcfg, smoke_variant(get_arch("mamba2-130m")), jp,
            interop.from_numpy(jp, "cpu"))


def _block(jp, tp, i=0):
    """Layer ``i``'s mamba params on both sides."""
    jb = jax.tree.map(lambda a: a[i], jp["blocks"][0]["mamba"])
    tb = {k: v[i] for k, v in tp["blocks"][0]["mamba"].items()}
    return jb, tb


def _x(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


@pytest.mark.parametrize("l", [1, 2, 3, 9])
@pytest.mark.parametrize("with_state", [False, True])
def test_conv1d(l, with_state):
    """Causal depthwise conv and its new window, including prompts
    shorter than the window (l < conv_width - 1)."""
    cw, c = 4, 12
    xbc, w = _x(1, (2, l, c)), _x(2, (cw, c))
    state = _x(3, (2, cw - 1, c)) if with_state else None
    want, want_win = jssm._conv1d(jnp.asarray(xbc), jnp.asarray(w),
                                  None if state is None
                                  else jnp.asarray(state))
    got, win = tssm._conv1d(torch.from_numpy(xbc), torch.from_numpy(w),
                            None if state is None
                            else torch.from_numpy(state))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(win.numpy(), np.asarray(want_win), **TOL)


@pytest.mark.parametrize("l,with_cache", [(20, False), (64, False),
                                          (32, True)])
def test_mamba_mixer(model, l, with_cache):
    """One block's full-sequence mixer: a ragged single chunk (20), two
    chunks (64), and a start from a cache (conv window and SSD state)."""
    jcfg, cfg, jp, tp = model
    jb, tb = _block(jp, tp, 1)
    x = _x(4, (2, l, cfg.d_model))
    cache = None
    if with_cache:
        _, nheads, d_conv = tssm.dims(cfg)
        s = cfg.ssm
        cache = (_x(5, (2, nheads, s.head_dim, s.state_dim), 0.5),
                 _x(6, (2, s.conv_width - 1, d_conv)))
    want, wc = jssm.mamba_mixer(jb, jcfg, jnp.asarray(x), None if cache is None
                                else jssm.SSMCache(*map(jnp.asarray, cache)))
    before = ssd_ops.COUNTER.count
    got, tc = tssm.mamba_mixer(tb, cfg, torch.from_numpy(x), None
                               if cache is None else tssm.SSMCache(
                                   *map(torch.from_numpy, cache)))
    assert ssd_ops.COUNTER.count == before        # the CPU path: no kernel
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(tc.ssm.numpy(), np.asarray(wc.ssm), **TOL)
    np.testing.assert_allclose(tc.conv.numpy(), np.asarray(wc.conv), **TOL)


def test_mamba_mixer_refuses_lengths_the_reference_refuses(model):
    _, cfg, _, tp = model
    tb = {k: v[0] for k, v in tp["blocks"][0]["mamba"].items()}
    with pytest.raises(ValueError, match="multiple of it"):
        tssm.mamba_mixer(tb, cfg, torch.zeros(1, 40, cfg.d_model))


def test_mamba_decode_writes_the_cache_in_place(model):
    jcfg, cfg, jp, tp = model
    jb, tb = _block(jp, tp)
    _, nheads, d_conv = tssm.dims(cfg)
    s = cfg.ssm
    ssm0 = _x(7, (3, nheads, s.head_dim, s.state_dim), 0.5)
    conv0 = _x(8, (3, s.conv_width - 1, d_conv))
    x = _x(9, (3, 1, cfg.d_model))
    want, wc = jssm.mamba_decode(jb, jcfg, jnp.asarray(x), jssm.SSMCache(
        jnp.asarray(ssm0), jnp.asarray(conv0)))
    cache = tssm.SSMCache(torch.from_numpy(ssm0.copy()),
                          torch.from_numpy(conv0.copy()))
    got, tc = tssm.mamba_decode(tb, cfg, torch.from_numpy(x), cache)
    assert tc.ssm is cache.ssm and tc.conv is cache.conv
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(cache.ssm.numpy(), np.asarray(wc.ssm), **TOL)
    np.testing.assert_allclose(cache.conv.numpy(), np.asarray(wc.conv),
                               **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_ssm_cache_and_caches(model, dtype):
    jcfg, cfg, _, _ = model
    want = jtf.init_caches(jcfg, 3, 64, getattr(jnp, dtype))
    got = ttf.init_caches(cfg, 3, 64, getattr(torch, dtype), device="cpu")
    assert len(got) == len(want) == 1
    assert isinstance(got[0], tssm.SSMCache)
    for g, w in zip(got[0], want[0]):
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
        assert not bool(g.any())


def test_params_have_the_reference_layout_and_law(model):
    """``init_params`` for the SSM family: the reference's leaf paths and
    shapes (``ln1`` + ``mamba`` per block, no ``ln2``/``ffn``), A_log,
    D and dt_bias as the reference draws them."""
    _, cfg, jp, tp = model
    fresh = interop.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    shapes = {p: tuple(t.shape) for p, t in interop.leaves(fresh)}
    assert shapes == {p: tuple(t.shape) for p, t in interop.leaves(tp)}
    assert "blocks/0/ln2" not in shapes and "blocks/0/ffn/wi" not in shapes
    m = fresh["blocks"][0]["mamba"]
    jm = jp["blocks"][0]["mamba"]
    np.testing.assert_allclose(m["A_log"].numpy(), jm["A_log"], rtol=1e-6)
    assert bool((m["D"] == 1).all()) and not bool(m["dt_bias"].any())
    cw = cfg.ssm.conv_width
    assert float(m["conv_w"].abs().max()) <= 2 * cw ** -0.5
    n = sum(t.numel() for _, t in interop.leaves(fresh))
    # the analytic count (the reference's formula) counts two norms and
    # no dt_bias per layer; the tree has one norm and a dt_bias
    nheads = tssm.dims(cfg)[1]
    assert n == cfg.param_counts()["total"] + cfg.n_layers * (
        nheads - cfg.d_model)


def _run_both(jcfg, cfg, jp, tp, toks, plen, steps):
    """Prefill ``toks[:, :plen]`` and decode ``steps`` teacher-forced
    tokens on both sides; logits at every step, the caches after prefill
    and at the end."""
    jl, jc = jtf.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :plen])},
                         dtype=jnp.float32, collect_cache_len=128)
    tl, tc = ttf.prefill(cfg, tp, {"tokens": torch.tensor(toks[:, :plen])},
                         dtype=torch.float32, collect_cache_len=128)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)

    def close_caches():
        (got,) = interop.caches_to_numpy(tc)
        np.testing.assert_allclose(got.ssm, np.asarray(jc[0].ssm), **TOL)
        np.testing.assert_allclose(got.conv, np.asarray(jc[0].conv), **TOL)

    close_caches()
    for i in range(steps):
        tok = toks[:, plen + i:plen + i + 1]
        jl, jc = jtf.decode_step(jcfg, jp, jnp.asarray(tok),
                                 jnp.int32(plen + i), jc, dtype=jnp.float32)
        before = tc[0].ssm
        tl, tc = ttf.decode_step(cfg, tp, torch.tensor(tok), plen + i, tc,
                                 dtype=torch.float32)
        assert tc[0].ssm is before            # written in place
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    close_caches()


@pytest.mark.parametrize("plen", [3, 20, 32, 64])
def test_prefill_and_decode_match_the_reference(model, plen):
    """Prompts shorter than the conv window, one ragged chunk, one whole
    chunk and two chunks, then 6 decode steps."""
    jcfg, cfg, jp, tp = model
    toks = np.random.default_rng(plen).integers(
        4, cfg.vocab, (2, plen + 6)).astype(np.int32)
    _run_both(jcfg, cfg, jp, tp, toks, plen, 6)


def test_per_slot_positions_change_nothing_for_the_ssm(model):
    """The continuous engine passes per-slot positions; the SSM ignores
    them: a (b,) position tensor gives the scalar position's logits."""
    _, cfg, _, tp = model
    toks = torch.tensor(np.random.default_rng(1).integers(
        4, cfg.vocab, (2, 9)).astype(np.int32))
    outs = []
    for pos in (8, torch.tensor([8, 3])):
        _, caches = ttf.prefill(cfg, tp, {"tokens": toks[:, :8]},
                                dtype=torch.float32, collect_cache_len=16)
        outs.append(ttf.decode_step(cfg, tp, toks[:, 8:], pos, caches,
                                    dtype=torch.float32)[0])
    assert torch.equal(outs[0], outs[1])


def test_vlm_and_hybrid_families_build_their_blocks():
    """The vlm builds its vision frontend beside the dense blocks, the
    embedding and the untied head; the hybrid family builds Mamba-2
    blocks with an FFN, attention every ``attn_every`` layers."""
    cfg = get_arch("internvl2-76b")
    full = ttf.init_params(cfg, torch.Generator(), "meta")
    assert sorted(full) == ["blocks", "embed", "final_norm", "frontend",
                            "lm_head"]
    assert tuple(full["frontend"]["patch_proj"].shape) == (16 * 16 * 3, 8192)
    assert [sorted(b) for b in full["blocks"]] == [
        ["attn", "ffn", "ln1", "ln2"]]
    hybrid = smoke_variant(get_arch("jamba-1.5-large-398b"))
    tp = ttf.init_params(hybrid, torch.Generator().manual_seed(0), "cpu")
    assert [sorted(b) for b in tp["blocks"]] == [
        ["ffn", "ln1", "ln2", "mamba"], ["attn", "ln1", "ln2", "moe"]]
