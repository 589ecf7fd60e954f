"""Port parity: the dense LM's prefill and decode against the JAX reference
on the CPU, from the same weights (carried over with
``interop.from_numpy``) and the same token ids.

Prefill logits and caches, and a run of ``decode_step`` logits with a
scalar position (the lockstep engine) and with per-slot positions (the
continuous engine), for the ``einsum`` decode backend and the kernel path
(``pallas``: the port's plain versions of the flash and decode kernels on
a CPU tensor, the reference's Pallas kernels in interpret mode). Cases: a
linear cache; a sliding-window ring that has wrapped; the linear cache
longer than the window, where decode attends past it in both (a reference
behaviour the port reproduces); qk-norm (Qwen3); head dim 128.

Tolerance: rtol 1e-4, atol 1e-5 on logits and caches, the reference's own
for its ring tests (tests/test_swa_ring.py); fp32 throughout, sums in
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
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro_torch import interop
from repro_torch.configs import get_arch, smoke_variant
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttf
from repro_torch.tree import leaves

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)


def _pair(arch="llama3.2-1b", **changes):
    """(reference cfg, port cfg) of the smoke variant with ``changes``."""
    return (dataclasses.replace(jax_smoke(jax_get_arch(arch)), **changes),
            dataclasses.replace(smoke_variant(get_arch(arch)), **changes))


def _weights(jcfg, seed=0):
    jp = jax.device_get(jtf.init_params(jcfg, jax.random.key(seed)))
    return jp, interop.from_numpy(jp, "cpu")


def _close_caches(tc, jc):
    for got, want in zip(interop.caches_to_numpy(tc), jc):
        np.testing.assert_allclose(got.k, np.asarray(want.k), **TOL)
        np.testing.assert_allclose(got.v, np.asarray(want.v), **TOL)


def _run_both(jcfg, tcfg, jp, tp, toks, plen, clen, steps, per_slot=None):
    """Prefill ``toks[:, :plen]`` with a cache of ``clen``, then decode
    ``steps`` tokens (teacher-forced from ``toks``) on both sides,
    comparing logits at every step and the caches at the end.
    ``per_slot``: per-row position offsets for a final per-slot step."""
    jl, jc = jtf.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :plen])},
                         dtype=jnp.float32, collect_cache_len=clen)
    tl, tc = ttf.prefill(tcfg, tp, {"tokens": torch.tensor(toks[:, :plen])},
                         dtype=torch.float32, collect_cache_len=clen)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _close_caches(tc, jc)
    for i in range(steps):
        tok = toks[:, plen + i:plen + i + 1]
        jl, jc = jtf.decode_step(jcfg, jp, jnp.asarray(tok),
                                 jnp.int32(plen + i), jc, dtype=jnp.float32)
        before = tc[0].k
        tl, tc = ttf.decode_step(tcfg, tp, torch.tensor(tok), plen + i, tc,
                                 dtype=torch.float32)
        assert tc[0].k is before            # written in place
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    if per_slot is not None:
        pos = (plen + steps + np.asarray(per_slot)).astype(np.int32)
        tok = toks[:, -1:]
        jl, jc = jtf.decode_step(jcfg, jp, jnp.asarray(tok), jnp.asarray(pos),
                                 jc, dtype=jnp.float32)
        tl, tc = ttf.decode_step(tcfg, tp, torch.tensor(tok),
                                 torch.tensor(pos), tc, dtype=torch.float32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _close_caches(tc, jc)
    return tl


@pytest.mark.parametrize("attn", ["naive", "pallas"])
@pytest.mark.parametrize("case", ["linear", "ring", "linear_past_window",
                                  "qwen3", "head_dim_128"])
def test_prefill_and_decode_match_reference(case, attn):
    arch, changes, plen, clen, steps = {
        "linear": ("llama3.2-1b", dict(sliding_window=None), 12, 32, 4),
        # a window of 8 under a 20-token prompt: the ring has wrapped at
        # prefill and keeps wrapping while decoding
        "ring": ("llama3.2-1b", dict(sliding_window=8), 20, 8, 5),
        # a linear cache longer than the window (repro/models/
        # attention.py:356): prefill honours the window, decode does not
        "linear_past_window": ("llama3.2-1b", dict(sliding_window=8), 12,
                               32, 4),
        "qwen3": ("qwen3-32b", {}, 12, 32, 4),
        "head_dim_128": ("llama3.2-1b", dict(head_dim=128,
                                             sliding_window=None), 12, 32,
                         3),
    }[case]
    jcfg, tcfg = _pair(arch, attn_impl=attn, **changes)
    assert tcfg.qk_norm == (case == "qwen3")
    jp, tp = _weights(jcfg, seed=len(case))
    rng = np.random.default_rng(len(case))
    toks = rng.integers(4, tcfg.vocab, (2, plen + steps + 1)).astype(np.int32)
    _run_both(jcfg, tcfg, jp, tp, toks, plen, clen, steps,
              per_slot=[0, -3])


def test_linear_cache_past_the_window_attends_past_it():
    """The reference behaviour reproduced above is real: with a linear
    cache the decode logits differ from those of the ring, which keeps
    only the window."""
    jcfg, tcfg = _pair(sliding_window=8)
    jp, tp = _weights(jcfg, seed=3)
    toks = np.random.default_rng(3).integers(4, 512, (1, 21)).astype(
        np.int32)
    outs = []
    for clen in (8, 32):
        _, caches = ttf.prefill(tcfg, tp, {"tokens": torch.tensor(
            toks[:, :20])}, dtype=torch.float32, collect_cache_len=clen)
        logits, _ = ttf.decode_step(tcfg, tp, torch.tensor(toks[:, 20:]), 20,
                                    caches, dtype=torch.float32)
        outs.append(logits)
    assert float((outs[0] - outs[1]).abs().max()) > 1e-3


@pytest.mark.parametrize("attn", ["naive", "pallas"])
def test_prefill_ring_equals_decode_built_ring(attn):
    """A ring built by prefill over a prompt longer than the window equals
    one built token by token from ``init_caches``; the next-token logits
    agree with each other and with the reference's."""
    window, plen = 8, 20
    jcfg, tcfg = _pair(sliding_window=window, attn_impl=attn)
    jp, tp = _weights(jcfg)
    toks = np.random.default_rng(0).integers(4, 512, (2, plen + 1)).astype(
        np.int32)
    _, ca = ttf.prefill(tcfg, tp, {"tokens": torch.tensor(toks[:, :plen])},
                        dtype=torch.float32, collect_cache_len=window)
    la, _ = ttf.decode_step(tcfg, tp, torch.tensor(toks[:, plen:]), plen, ca,
                            dtype=torch.float32)
    cb = ttf.init_caches(tcfg, 2, window, dtype=torch.float32, device="cpu")
    assert cb[0].k.shape == (2, 2, 2, window, 64)
    for t in range(plen + 1):
        lb, cb = ttf.decode_step(tcfg, tp, torch.tensor(toks[:, t:t + 1]), t,
                                 cb, dtype=torch.float32)
    np.testing.assert_allclose(la.numpy(), lb.numpy(), **TOL)
    jcb = jtf.init_caches(jcfg, 2, window, dtype=jnp.float32)
    for t in range(plen + 1):
        jl, jcb = jtf.decode_step(jcfg, jp, jnp.asarray(toks[:, t:t + 1]),
                                  jnp.int32(t), jcb, dtype=jnp.float32)
    np.testing.assert_allclose(lb.numpy(), np.asarray(jl), **TOL)
    _close_caches(cb, jcb)


def test_positions_past_a_linear_cache_follow_the_reference():
    """Past the end of a linear cache (a windowed config admits it) the
    reference clamps a scalar write to the last slot and drops a per-slot
    one; both attend over the whole cache. The port does the same."""
    jcfg, tcfg = _pair(sliding_window=8)
    jp, tp = _weights(jcfg, seed=4)
    toks = np.random.default_rng(4).integers(4, 512, (2, 13)).astype(
        np.int32)
    jl, jc = jtf.prefill(jcfg, jp, {"tokens": jnp.asarray(toks[:, :10])},
                         dtype=jnp.float32, collect_cache_len=12)
    tl, tc = ttf.prefill(tcfg, tp, {"tokens": torch.tensor(toks[:, :10])},
                         dtype=torch.float32, collect_cache_len=12)
    for pos in (14, np.array([15, 11], np.int32), np.array([3, 20],
                                                           np.int32)):
        tok = toks[:, 10:11]
        jl, jc = jtf.decode_step(jcfg, jp, jnp.asarray(tok), jnp.asarray(pos),
                                 jc, dtype=jnp.float32)
        tl, tc = ttf.decode_step(tcfg, tp, torch.tensor(tok),
                                 torch.tensor(pos) if np.ndim(pos) else pos,
                                 tc, dtype=torch.float32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _close_caches(tc, jc)


def test_cache_from_prefill_places_the_ring_like_the_reference():
    jcfg, tcfg = _pair(sliding_window=8)
    rng = np.random.default_rng(5)
    k, v = (rng.standard_normal((2, 21, 2, 16)).astype(np.float32)
            for _ in range(2))
    for clen in (8, 32):          # a wrapped ring, and a linear cache
        want = jattn.cache_from_prefill(jcfg, jnp.asarray(k), jnp.asarray(v),
                                        clen)
        got = tattn.cache_from_prefill(tcfg, torch.tensor(k),
                                       torch.tensor(v), clen)
        np.testing.assert_array_equal(got.k.numpy(), np.asarray(want.k))
        np.testing.assert_array_equal(got.v.numpy(), np.asarray(want.v))
    # slot i of the wrapped ring holds the position p in [13, 21) with
    # p % 8 == i
    ring = tattn.cache_from_prefill(tcfg, torch.tensor(k), torch.tensor(v), 8)
    for i in range(8):
        p = next(p for p in range(13, 21) if p % 8 == i)
        assert torch.equal(ring.k[:, :, i], torch.tensor(k)[:, p])


def test_caches_round_trip_through_interop():
    jcfg, tcfg = _pair(sliding_window=None)
    jp, tp = _weights(jcfg)
    toks = np.random.default_rng(1).integers(4, 512, (2, 6)).astype(np.int32)
    _, jc = jtf.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                        dtype=jnp.float32, collect_cache_len=16)
    tc = interop.caches_from_numpy(jax.device_get(jc), "cpu")
    assert isinstance(tc[0], tattn.KVCache) and tc[0].k.shape == (
        2, 2, 2, 16, 64)
    jl, _ = jtf.decode_step(jcfg, jp, jnp.asarray(toks[:, -1:]), jnp.int32(6),
                            jc, dtype=jnp.float32)
    tl, _ = ttf.decode_step(tcfg, tp, torch.tensor(toks[:, -1:]), 6, tc,
                            dtype=torch.float32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    with pytest.raises(TypeError):
        interop.caches_from_numpy(jax.device_get(jc))


def test_kernel_path_reaches_the_decode_wrapper_at_any_cache_length(
        monkeypatch):
    """attn='pallas' sends decode through ``ops.decode_attention`` even at
    a cache length of 300, where the reference's TPU tiling rule falls back
    to einsum; the values still match the reference's."""
    calls = []
    real = dec_ops.decode_attention

    def spy(*args):
        calls.append(args[1].shape)
        return real(*args)

    monkeypatch.setattr(dec_ops, "decode_attention", spy)
    jcfg, tcfg = _pair(sliding_window=None, attn_impl="pallas")
    jp, tp = _weights(jcfg)
    toks = np.random.default_rng(2).integers(4, 512, (2, 12)).astype(
        np.int32)
    _run_both(jcfg, tcfg, jp, tp, toks, 10, 300, 1)
    assert calls and all(s[2] == 300 for s in calls)
    assert len(calls) == tcfg.n_layers


def test_resolve_decode_backend():
    r = tattn.resolve_decode_backend
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert r("auto", cpu) == "einsum" and r(None, cpu) == "einsum"
    assert r("auto", cuda) == "decode" and r(None, cuda) == "decode"
    for dev in (cpu, cuda):
        assert r("pallas", dev) == "decode"
        assert r("decode", dev) == "decode"
        assert r("flash", dev) == "decode"
        assert r("naive", dev) == "einsum"
        assert r("chunked", dev) == "einsum"
        assert r("einsum", dev) == "einsum"
    with pytest.raises(KeyError, match="bogus"):
        r("bogus", cpu)


def test_vlm_and_hybrid_families_build_on_the_dense_blocks():
    """Every family of the reference builds now: a vlm config without a
    vision frontend, and a hybrid config with attention every layer, are
    the dense model with its blocks' leaves."""
    base = smoke_variant(get_arch("llama3.2-1b"))
    vlm = ttf.init_params(dataclasses.replace(base, family="vlm"),
                          torch.Generator().manual_seed(0), "cpu")
    hybrid = dataclasses.replace(base, family="hybrid")
    assert hybrid.layer_kinds() == ("attn", "attn")
    tp = ttf.init_params(hybrid, torch.Generator().manual_seed(0), "cpu")
    dense = ttf.init_params(base, torch.Generator().manual_seed(0), "cpu")
    for tree in (tp, vlm):
        assert [p for p, _ in leaves(tree)] == [p for p, _ in leaves(dense)]
        assert all(torch.equal(a, b) for (_, a), (_, b) in
                   zip(leaves(tree), leaves(dense)))
