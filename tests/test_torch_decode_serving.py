"""The port's decode engines on the CPU: the lockstep ``Engine`` against the
reference's from shared weights, the ``ContinuousEngine`` contract of
tests/test_continuous_engine.py held within the port, and the
``launch/serve.py`` launcher.

Greedy tokens are compared exactly. Where a comparison with the reference
meets a near-tie (the reference's top-2 logit gap under 1e-4 at the first
differing step; fp32 sums in another order move logits by ~1e-6), the
tokens are compared up to that step and the gap is checked instead; the
inputs are never re-seeded. Sampled decoding is held within the port
(reproducible per ``(seed, request_id)``): the two softmaxes differ in
ulps, so bit-equality with JAX is not required.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import smoke_variant as jax_smoke
from repro.models import transformer as jtf
from repro.serving import Engine as JaxEngine
from repro_torch import interop
from repro_torch.configs import get_arch, smoke_variant
from repro_torch.launch import serve as tserve
from repro_torch.serving import ContinuousEngine, Engine, sample_tokens

torch.set_num_threads(1)

CACHE_LEN = 64
NEAR_TIE = 1e-4


@pytest.fixture(scope="module")
def shared():
    """(reference cfg, port cfg, reference params, port params) of the
    smoke llama from one set of weights."""
    jcfg = jax_smoke(jax_get_arch("llama3.2-1b"))
    jp = jax.device_get(jtf.init_params(jcfg, jax.random.key(0)))
    return jcfg, smoke_variant(get_arch("llama3.2-1b")), jp, \
        interop.from_numpy(jp, "cpu")


@pytest.fixture(scope="module")
def oracle(shared):
    """The port's lockstep engine and a memo of requests run alone."""
    _, cfg, _, params = shared
    eng = Engine(cfg, params, cache_len=CACHE_LEN)
    memo = {}

    def run_alone(prompt, max_new):
        key = (prompt.tobytes(), max_new)
        if key not in memo:
            row = eng.generate(prompt[None, :], max_new, temperature=0.0)[0]
            memo[key] = _until_eos(row, eng.eos_id)
        return memo[key]

    return eng, run_alone


def _until_eos(row, eos_id):
    toks = []
    for t in row:
        toks.append(int(t))
        if t == eos_id:
            break
    return np.asarray(toks, np.int32)


def _prompts(seed, n, vocab, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(4, vocab, (lens[i % len(lens)],)).astype(np.int32)
            for i in range(n)]


def _reference_gap(jcfg, jp, prompt, prefix):
    """The reference's top-2 logit gap for the token after
    ``prompt + prefix`` (teacher-forced prefill, f32)."""
    toks = np.concatenate([prompt, prefix])[None, :].astype(np.int32)
    logits = np.asarray(jtf.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                                    dtype=jnp.float32))[0, 0]
    top = np.sort(logits)[-2:]
    return float(top[1] - top[0])


@pytest.mark.parametrize("attn", ["naive", "pallas"])
def test_greedy_tokens_match_the_reference_engine(shared, attn):
    jcfg, cfg, jp, params = shared
    prompts = np.random.default_rng(3).integers(4, cfg.vocab, (2, 8)).astype(
        np.int32)
    want = JaxEngine(dataclasses.replace(jcfg), jp, cache_len=CACHE_LEN,
                     attn=attn).generate(prompts, 6, temperature=0.0)
    eng = Engine(cfg, params, cache_len=CACHE_LEN, attn=attn,
                 precision="f32")
    got = eng.generate(prompts, 6, temperature=0.0)
    assert eng.cfg.attn_impl == attn and eng.precision.name == "f32"
    for r in range(2):
        diff = np.nonzero(got[r] != want[r])[0]
        if diff.size:                      # only at a near-tie
            i = int(diff[0])
            assert _reference_gap(jcfg, jp, prompts[r], want[r, :i]) \
                < NEAR_TIE, (r, i, got[r], want[r])


def test_bf16_eos_and_typos(shared):
    _, cfg, _, params = shared
    prompts = np.random.default_rng(1).integers(4, cfg.vocab, (2, 8)).astype(
        np.int32)
    bf = Engine(cfg, params, cache_len=CACHE_LEN, precision="bf16",
                attn="pallas")
    assert bf.precision.compute_dtype == torch.bfloat16
    out = bf.generate(prompts, 5, temperature=0.0)
    assert out.shape == (2, 5) and out.dtype == np.int32
    assert ((out >= 0) & (out < cfg.vocab)).all()
    eng = Engine(cfg, params, cache_len=CACHE_LEN)
    first = int(eng.generate(prompts[:1], 1, temperature=0.0)[0, 0])
    eng.eos_id = first
    out = eng.generate(prompts[:1], 6, temperature=0.0)
    assert out[0, 0] == first and (out[0, 1:] == 0).all()
    with pytest.raises(KeyError, match="palas"):
        Engine(cfg, params, cache_len=CACHE_LEN, attn="palas")
    with pytest.raises(KeyError, match="palas"):
        ContinuousEngine(cfg, params, cache_len=CACHE_LEN, num_slots=2,
                         attn="palas")
    with pytest.raises(ValueError, match="exceeds cache_len"):
        Engine(dataclasses.replace(cfg, sliding_window=None), params,
               cache_len=16).generate(prompts, 10)
    with pytest.raises(ValueError, match="encoder-only"):
        Engine(dataclasses.replace(cfg, causal=False), params, cache_len=16)


def test_single_request_matches_lockstep(shared, oracle):
    _, cfg, _, params = shared
    _, run_alone = oracle
    (prompt,) = _prompts(0, 1, cfg.vocab, [8])
    ce = ContinuousEngine(cfg, params, cache_len=CACHE_LEN, num_slots=1)
    np.testing.assert_array_equal(ce.run([(prompt, 6, 0)])[0],
                                  run_alone(prompt, 6))


@pytest.mark.parametrize("num_slots", [1, 2, 4])
def test_staggered_lengths_any_slot_count(shared, oracle, num_slots):
    _, cfg, _, params = shared
    _, run_alone = oracle
    prompts = _prompts(1, 6, cfg.vocab, [8, 5, 11, 3, 7, 8])
    budgets = [6, 4, 8, 5, 1, 6]
    ce = ContinuousEngine(cfg, params, cache_len=CACHE_LEN,
                          num_slots=num_slots)
    got = ce.run([(p, m, i) for i, (p, m) in enumerate(zip(prompts,
                                                             budgets))])
    assert set(got) == set(range(6))
    for i, (p, m) in enumerate(zip(prompts, budgets)):
        np.testing.assert_array_equal(got[i], run_alone(p, m))


def test_arrival_order_is_irrelevant(shared, oracle):
    _, cfg, _, params = shared
    _, run_alone = oracle
    prompts = _prompts(2, 5, cfg.vocab, [6, 9, 4, 8, 5])
    budgets = [5, 3, 7, 4, 6]
    reqs = [(p, m, i) for i, (p, m) in enumerate(zip(prompts, budgets))]
    for order in [reqs, reqs[::-1], reqs[2:] + reqs[:2]]:
        got = ContinuousEngine(cfg, params, cache_len=CACHE_LEN,
                               num_slots=2).run(order)
        for i, (p, m) in enumerate(zip(prompts, budgets)):
            np.testing.assert_array_equal(got[i], run_alone(p, m))
    # late arrivals: two requests, a few ticks, then the rest
    ce = ContinuousEngine(cfg, params, cache_len=CACHE_LEN, num_slots=2)
    got = {}
    for p, m, i in reqs[:2]:
        ce.submit(p, m, i)
    for _ in range(3):
        for fin in ce.step():
            got[fin.request_id] = fin.tokens
    for p, m, i in reqs[2:]:
        ce.submit(p, m, i)
    while ce.pending:
        for fin in ce.step():
            got[fin.request_id] = fin.tokens
    for i, (p, m) in enumerate(zip(prompts, budgets)):
        np.testing.assert_array_equal(got[i], run_alone(p, m))


def test_slot_reuse_after_eos_leaks_nothing(shared, oracle):
    _, cfg, _, params = shared
    _, run_alone = oracle
    prompts = _prompts(3, 8, cfg.vocab, [10, 4, 7, 12, 5, 9, 6, 8])
    budgets = [2, 9, 3, 8, 2, 7, 3, 6]
    ce = ContinuousEngine(cfg, params, cache_len=CACHE_LEN, num_slots=2,
                          attn="pallas")
    got = ce.run([(p, m, i) for i, (p, m) in enumerate(zip(prompts,
                                                             budgets))])
    assert ce.registry.counter("decode/admissions").value >= 8
    for i, (p, m) in enumerate(zip(prompts, budgets)):
        np.testing.assert_array_equal(got[i], run_alone(p, m))


def test_first_token_eos_never_takes_a_slot(shared, oracle):
    _, cfg, _, params = shared
    eng, _ = oracle
    (prompt,) = _prompts(4, 1, cfg.vocab, [8])
    first = int(eng.generate(prompt[None, :], 1, temperature=0.0)[0, 0])
    ce = ContinuousEngine(cfg, params, cache_len=CACHE_LEN, num_slots=2,
                          eos_id=first)
    np.testing.assert_array_equal(ce.run([(prompt, 6, 0)])[0],
                                  np.asarray([first], np.int32))
    assert all(not s.active for s in ce._slots)
    assert ce.registry.gauge("decode/slot_occupancy").value == 0.0


def test_budget_is_exact(shared, oracle):
    _, cfg, _, params = shared
    _, run_alone = oracle
    prompts = _prompts(5, 3, cfg.vocab, [7, 7, 7])
    got = ContinuousEngine(cfg, params, cache_len=CACHE_LEN,
                           num_slots=3).run([(p, 5, i) for i, p in
                                             enumerate(prompts)])
    for i, p in enumerate(prompts):
        want = run_alone(p, 5)
        np.testing.assert_array_equal(got[i], want)
        if want[-1] != 3:
            assert got[i].size == 5


def test_capacity_occupancy_and_counters(shared):
    _, cfg, _, params = shared
    strict = ContinuousEngine(dataclasses.replace(cfg, sliding_window=None),
                              params, cache_len=CACHE_LEN, num_slots=2)
    with pytest.raises(ValueError, match="exceeds cache_len"):
        strict.submit(np.ones((60,), np.int32), 10)
    ce = ContinuousEngine(cfg, params, cache_len=CACHE_LEN, num_slots=2)
    for i, p in enumerate(_prompts(6, 4, cfg.vocab, [6, 6, 6, 6])):
        ce.submit(p, 4, i)
    assert ce.pending == 4
    occupancies = []
    while ce.pending:
        ce.step()
        occupancies.append(sum(s.active for s in ce._slots))
    assert max(occupancies) == 2
    snap = ce.stats()
    assert snap["derived"]["tokens_per_sec"] > 0
    reg = ce.registry
    assert reg.counter("decode/tokens").value >= 4 * 4 - 3
    assert reg.counter("decode/requests").value == 4
    assert reg.counter("decode/admissions").value == 4
    assert reg.histogram("decode/step_s").count == len(ce.step_log)
    assert sum(n for _, n in ce.step_log) == \
        reg.counter("decode/tokens").value - 4
    occ = reg.histogram("decode/slot_occupancy_ratio").summary()
    assert occ["count"] == len(occupancies) and occ["max"] == 1.0
    # the SLO tracker sees each request once, submit to finish
    slo_eng = ContinuousEngine(cfg, params, cache_len=CACHE_LEN,
                               num_slots=2, latency_slo_s=60.0)
    slo_eng.run([(p, 3) for p in _prompts(6, 3, cfg.vocab, [5, 6, 7])])
    slo = slo_eng.stats()["slo"]
    assert slo["requests"] == 3 and slo["healthy"] and "slo" not in snap
    server = ce.serve_metrics()
    server.stop()


def test_sampled_decoding_is_reproducible_per_request(shared):
    _, cfg, _, params = shared
    prompts = _prompts(8, 3, cfg.vocab, [6, 8, 5])
    reqs = [(p, 5, i) for i, p in enumerate(prompts)]
    outs = [ContinuousEngine(cfg, params, cache_len=CACHE_LEN, num_slots=2,
                             temperature=1.5, seed=42).run(order)
            for order in (reqs, reqs[::-1])]
    for i in range(3):
        np.testing.assert_array_equal(outs[0][i], outs[1][i])
    rng = np.random.default_rng(0)
    logits = np.array([[0.0, 50.0, 0.0], [3.0, 1.0, 2.0]], np.float32)
    assert sample_tokens(logits, 0.0, rng).tolist() == [1, 0]
    assert sample_tokens(torch.tensor(logits), 1e-3, rng).tolist() == [1, 0]


@pytest.mark.parametrize("engine", ["legacy", "continuous"])
def test_launcher_serves_on_the_cpu(engine, capsys):
    rep = tserve.main(["--arch", "llama3.2-1b", "--smoke", "--device", "cpu",
                       "--engine", engine, "--requests", "3", "--slots",
                       "2", "--batch", "2", "--prompt-len", "8",
                       "--max-new", "4", "--attn", "pallas"])
    out = capsys.readouterr().out
    assert "tok/s" in out and rep["device"] == "cpu"
    assert np.isfinite(rep["tokens_per_s"]) and rep["tokens_per_s"] > 0
    if engine == "continuous":
        assert rep["requests"] == 3 and "decode step: median" in out
        assert rep["step_p90_s"] >= rep["step_median_s"] > 0


def test_launcher_raises_without_a_card_or_for_later_slices(capsys):
    """No card and no CPU request: it raises. The SLO and live-endpoint
    flags, once refused, now serve."""
    if torch.cuda.is_available():
        pytest.skip("checks the card-less host")
    argv = ["--arch", "llama3.2-1b", "--smoke", "--max-new", "2"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(argv)
    rep = tserve.main(argv + ["--device", "cpu", "--engine", "continuous",
                              "--requests", "2", "--slo-ms", "60000",
                              "--metrics-port", "0"])
    out = capsys.readouterr().out
    assert rep["slo"]["requests"] == 2 and "slo: p99" in out
    assert "obs: serving /metrics" in out
