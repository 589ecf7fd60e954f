"""The port's decode engines on the SSM family (smoke Mamba-2) on the CPU:
the lockstep ``Engine`` against the reference's from shared weights, the
port of tests/test_continuous_engine.py's
``test_mamba_ssm_cache_slot_parity`` (the slot insert splices SSM and
conv state rows as it does KV rows), and the ``launch/serve.py``
launcher with ``--arch mamba2-130m``.

Greedy tokens are compared exactly; where a comparison with the reference
meets a near-tie (the reference's top-2 logit gap under 1e-4 at the first
differing step), the tokens are compared up to that step and the gap is
checked instead, as in tests/test_torch_decode_serving.py.
"""
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
from repro_torch.models.ssm import SSMCache
from repro_torch.serving import ContinuousEngine, Engine

torch.set_num_threads(1)

CACHE_LEN = 64
NEAR_TIE = 1e-4


@pytest.fixture(scope="module")
def shared():
    """(reference cfg, port cfg, reference params, port params) of the
    smoke Mamba-2 from one set of weights."""
    jcfg = jax_smoke(jax_get_arch("mamba2-130m"))
    jp = jax.device_get(jtf.init_params(jcfg, jax.random.key(0)))
    return jcfg, smoke_variant(get_arch("mamba2-130m")), jp, \
        interop.from_numpy(jp, "cpu")


def _until_eos(row, eos_id):
    stop = np.nonzero(row == eos_id)[0]
    return row[:int(stop[0]) + 1] if stop.size else row


def _prompts(seed, vocab, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(4, vocab, (n,)).astype(np.int32) for n in lens]


def _reference_gap(jcfg, jp, prompt, prefix):
    toks = np.concatenate([prompt, prefix])[None, :].astype(np.int32)
    logits = np.asarray(jtf.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)},
                                    dtype=jnp.float32))[0, 0]
    top = np.sort(logits)[-2:]
    return float(top[1] - top[0])


@pytest.mark.parametrize("plen", [8, 32])
def test_greedy_tokens_match_the_reference_engine(shared, plen):
    """A ragged chunk (8) and a whole chunk (32), 3 rows, 6 tokens; the
    ``--attn`` choice changes nothing on an attention-free model."""
    jcfg, cfg, jp, params = shared
    prompts = np.random.default_rng(plen).integers(
        4, cfg.vocab, (3, plen)).astype(np.int32)
    want = JaxEngine(jcfg, jp, cache_len=CACHE_LEN).generate(
        prompts, 6, temperature=0.0)
    got = Engine(cfg, params, cache_len=CACHE_LEN, precision="f32").generate(
        prompts, 6, temperature=0.0)
    same = Engine(cfg, params, cache_len=CACHE_LEN, attn="pallas").generate(
        prompts, 6, temperature=0.0)
    np.testing.assert_array_equal(same, got)
    for r in range(3):
        diff = np.nonzero(got[r] != want[r])[0]
        if diff.size:                      # only at a near-tie
            i = int(diff[0])
            assert _reference_gap(jcfg, jp, prompts[r], want[r, :i]) \
                < NEAR_TIE, (r, i, got[r], want[r])


def test_mamba_ssm_cache_slot_parity(shared):
    """The slot insert is a generic axis-1 splice over the cache leaves:
    it carries SSM and conv state rows just like KV rows, so the
    continuous engine (2 slots, 4 ragged requests) gives each request the
    lockstep engine's tokens run alone."""
    _, cfg, _, params = shared
    eng = Engine(cfg, params, cache_len=CACHE_LEN)
    prompts = _prompts(7, cfg.vocab, [8, 5, 11, 6])
    budgets = [5, 4, 6, 3]
    ce = ContinuousEngine(cfg, params, cache_len=CACHE_LEN, num_slots=2)
    got = ce.run([(p, m, i) for i, (p, m) in enumerate(zip(prompts,
                                                             budgets))])
    assert isinstance(ce._caches[0], SSMCache)
    assert ce._caches[0].ssm.shape[:2] == (cfg.n_layers, 2)
    for i, (p, m) in enumerate(zip(prompts, budgets)):
        alone = _until_eos(eng.generate(p[None, :], m, temperature=0.0)[0],
                           eng.eos_id)
        np.testing.assert_array_equal(got[i], alone)


def test_slot_reuse_and_bf16(shared):
    """More requests than slots, reused after each finishes, under both
    precision policies; a prompt the scan refuses raises."""
    _, cfg, _, params = shared
    prompts = _prompts(3, cfg.vocab, [10, 32, 7, 64, 5, 9])
    budgets = [2, 7, 3, 6, 2, 5]
    reqs = [(p, m, i) for i, (p, m) in enumerate(zip(prompts, budgets))]
    for precision in ("f32", "bf16"):
        eng = Engine(cfg, params, cache_len=CACHE_LEN + 16,
                     precision=precision)
        got = ContinuousEngine(cfg, params, cache_len=CACHE_LEN + 16,
                               num_slots=2, precision=precision).run(reqs)
        for p, m, i in reqs:
            np.testing.assert_array_equal(
                got[i], _until_eos(eng.generate(p[None, :], m)[0],
                                   eng.eos_id))
    with pytest.raises(ValueError, match="multiple of it"):
        Engine(cfg, params, cache_len=CACHE_LEN).generate(
            np.ones((1, 40), np.int32), 2)
    with pytest.raises(ValueError, match="exceeds cache_len"):
        ContinuousEngine(cfg, params, cache_len=CACHE_LEN,
                         num_slots=2).submit(np.ones((60,), np.int32), 10)


@pytest.mark.parametrize("engine", ["legacy", "continuous"])
def test_launcher_serves_mamba_on_the_cpu(engine, capsys):
    rep = tserve.main(["--arch", "mamba2-130m", "--smoke", "--device", "cpu",
                       "--engine", engine, "--requests", "3", "--slots",
                       "2", "--batch", "2", "--max-new", "4", "--attn",
                       "pallas"])
    out = capsys.readouterr().out
    assert "tok/s" in out and rep["device"] == "cpu"
    assert np.isfinite(rep["tokens_per_s"]) and rep["tokens_per_s"] > 0
    if engine == "continuous":
        assert rep["requests"] == 3 and rep["prefills"] == 3
        assert rep["step_p90_s"] >= rep["step_median_s"] > 0


def test_launcher_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("checks the card-less host")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--arch", "mamba2-130m", "--smoke", "--max-new", "2"])
