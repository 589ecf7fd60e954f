"""Port parity: the audio encoder against the JAX reference on the CPU, at
HuBERT-XLarge's smoke size (``smoke_variant``: 2 layers, d 256, 4 heads
with kv = heads, not causal, vocab 504), from the reference's weights
carried over by ``interop.from_numpy`` and batches drawn with numpy from
a seed. The frontend is the reference's stub: precomputed frame
embeddings (``batch['embeddings']``).

- The parameter tree (no embedding table, the untied ``lm_head``) has the
  reference's paths, shapes and dtypes at full size and crosses both ways
  bit for bit.
- ``embed_inputs``: the frames cast to the compute dtype, positions
  ``arange(s)``, no text mask.
- ``lm_loss`` (the masked-frame cross-entropy of ``targets`` where
  ``mask`` is set, over max(mask count, 1)) and its gradients against
  ``jax.value_and_grad``, with naive attention and with the flash path
  (its plain version, bidirectional): the loss and ``xent`` at rtol 2e-5
  and every gradient leaf at rtol 2e-5 with the leaf's largest |gradient|
  as the absolute part (``GA_RTOL``, ``tests/test_torch_lm_train.py``);
  an empty mask gives 0, as the reference's.
- ``train --mode lm`` for 3 steps against the reference's ``run_lm``:
  losses at rel 1e-4, params per leaf within 1e-3 of the change the steps
  made.
- Serving: both engines refuse the encoder (no decode step), as the
  reference's do.
- ``train_distributed`` at (data 1, model 2) under ``basic_ws`` and
  ``tp`` (``tests/test_torch_vlm.py``'s harness): the reference's runs
  resumed by the port from step 2 on spawned gloo ranks. Under
  ``basic_ws`` each rank holds half the batch, so its masked mean is
  weighed by its masked count (``steps.masked_share``), as the
  reference's loss over the global batch weighs it.
"""
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import get_arch as jax_get_arch
from repro.configs import smoke_variant as jax_smoke_variant
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import frontends as jfe
from repro.models import transformer as jtf
from repro.serving import ContinuousEngine as JaxContinuousEngine
from repro.serving import Engine as JaxEngine
from repro_torch import interop
from repro_torch.configs import applicable_shapes, get_arch, smoke_variant
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import frontends as tfe
from repro_torch.models import transformer as ttf
from repro_torch.serving import ContinuousEngine, Engine
from repro_torch.tree import leaves

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_lm_train import (GA_RTOL, _assert_change_close,  # noqa: E402
                                 _assert_grads_close, _paths,
                                 _record_reference_floats, _ref_args,
                                 _ref_paths)
from test_torch_vlm import check_resumed_runs  # noqa: E402

torch.set_num_threads(1)

ARCH = "hubert-xlarge"
SEQ = 48


@pytest.fixture(scope="module")
def audio():
    """(reference cfg, port cfg, reference params as numpy, the same
    params in the port, one numpy batch of 2 × 48 frames)."""
    jcfg = jax_smoke_variant(jax_get_arch(ARCH))
    tcfg = smoke_variant(get_arch(ARCH))
    jparams = jax.device_get(jtf.init_params(jcfg, jax.random.key(0)))
    batch = jax.device_get(jfe.synthetic_inputs(jcfg, 2, SEQ,
                                                np.random.default_rng(1)))
    return jcfg, tcfg, jparams, interop.from_numpy(jparams, "cpu"), batch


def _shapes(tree):
    return {p: (tuple(x.shape), str(x.dtype).removeprefix("torch."))
            for p, x in leaves(tree)}


def test_config_is_the_reference_s():
    cfg = get_arch(ARCH)
    assert dataclasses.astuple(cfg) == dataclasses.astuple(
        jax_get_arch(ARCH))
    assert (cfg.family, cfg.frontend, cfg.causal) == ("encoder", "audio",
                                                      False)
    assert cfg.resolved_head_dim == 80


def test_param_tree_is_the_reference_s_and_crosses_both_ways(audio):
    _, tcfg, jparams, tparams, _ = audio
    full = tsteps.abstract_params(get_arch(ARCH))
    ref = jsteps.abstract_params(jax_get_arch(ARCH))
    assert _shapes(full) == {p: (tuple(s.shape), str(s.dtype))
                             for p, s in leaves(ref)}
    assert "embed" not in full and "frontend" not in full
    assert tuple(full["lm_head"].shape) == (1280, 504)
    got, want = dict(leaves(interop.to_numpy(tparams))), dict(leaves(jparams))
    assert set(got) == set(want)
    for path, w in want.items():
        np.testing.assert_array_equal(got[path], w, err_msg=path)
    drawn = ttf.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert _shapes(drawn) == _shapes(tparams)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_inputs_match_reference(audio, dtype):
    jcfg, tcfg, jparams, tparams, batch = audio
    jh, jpos, jmask = jtf.embed_inputs(
        jcfg, jax.tree.map(jnp.asarray, jparams),
        jax.tree.map(jnp.asarray, batch), getattr(jnp, dtype))
    h, pos, mask = ttf.embed_inputs(tcfg, tparams,
                                    interop.from_numpy(batch, "cpu"),
                                    getattr(torch, dtype))
    assert mask is None and jmask is None
    assert h.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(h.float().numpy(),
                                  np.asarray(jh).astype(np.float32))
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))


@pytest.fixture(scope="module")
def reference_grads(audio):
    jcfg, _, jparams, _, batch = audio
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jtf.lm_loss(jcfg, p, jax.tree.map(jnp.asarray, batch)),
        has_aux=True)(jax.tree.map(jnp.asarray, jparams))
    return jl, jm, jg


@pytest.mark.parametrize("attn", ["naive", "pallas"])
def test_lm_loss_and_grads_match_reference(audio, reference_grads, attn):
    _, tcfg, _, tparams, batch = audio
    jl, jm, jg = reference_grads
    cfg = dataclasses.replace(tcfg, attn_impl=attn)
    tbatch = interop.from_numpy(batch, "cpu")
    loss, metrics, grads = tsteps.value_and_grad(
        lambda p: ttf.lm_loss(cfg, p, tbatch), tparams)
    assert float(loss) == pytest.approx(float(jl), rel=GA_RTOL)
    assert float(metrics["xent"]) == pytest.approx(float(jm["xent"]),
                                                   rel=GA_RTOL)
    assert float(metrics["aux"]) == float(jm["aux"]) == 0.0
    got = _paths(grads)
    _assert_grads_close(got, _ref_paths(jg))
    assert all(np.abs(g).max() > 0 for g in got.values())


def test_empty_mask_gives_zero_as_the_reference(audio):
    jcfg, tcfg, jparams, tparams, batch = audio
    batch = dict(batch, mask=np.zeros_like(batch["mask"]))
    jl, _ = jtf.lm_loss(jcfg, jax.tree.map(jnp.asarray, jparams),
                        jax.tree.map(jnp.asarray, batch))
    loss, _ = ttf.lm_loss(tcfg, tparams, interop.from_numpy(batch, "cpu"))
    assert float(loss) == float(jl) == 0.0


def test_run_lm_matches_reference(audio, tmp_path, monkeypatch):
    jcfg, tcfg, jparams, tparams, _ = audio
    args = ttrain.parse_args([
        "--mode", "lm", "--arch", ARCH, "--smoke", "--device", "cpu",
        "--steps", "3", "--batch", "2", "--seq", str(SEQ), "--log-every",
        "1", "--seed", "0"])
    rep = ttrain.run_lm(args, params_init=tparams)
    seen = _record_reference_floats(monkeypatch)
    ref = jax.device_get(jtrain.run_lm(_ref_args(args, tmp_path)))
    assert rep["losses"] == pytest.approx(seen, rel=1e-4)
    _assert_change_close(_paths(rep["params"]), _ref_paths(ref),
                         _ref_paths(jparams), 1e-3)


def test_engines_refuse_the_encoder_as_the_reference(audio):
    jcfg, tcfg, jparams, tparams, _ = audio
    with pytest.raises(AssertionError, match="encoder-only"):
        JaxEngine(jcfg, jparams, cache_len=32)
    with pytest.raises(AssertionError, match="encoder-only"):
        JaxContinuousEngine(jcfg, jparams, cache_len=32, num_slots=2)
    with pytest.raises(ValueError, match="encoder-only"):
        Engine(tcfg, tparams, cache_len=32)
    with pytest.raises(ValueError, match="encoder-only"):
        ContinuousEngine(tcfg, tparams, cache_len=32, num_slots=2)
    with pytest.raises(ValueError, match="encoder-only"):
        tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])


def test_train_distributed_resumes_the_references_runs(tmp_path):
    """HuBERT smoke (b 4 × 48 frames) at (1, 2) under ``basic_ws`` (each
    rank half the batch: the masked means weighed by their counts) and
    ``tp`` (both ranks the whole batch; 504 cluster logits split 252 a
    rank, the cross-entropy vocab-parallel)."""
    check_resumed_runs({f"hubert_{s}": {"arch": ARCH, "seq": SEQ,
                                        "sharding": s}
                        for s in ("basic_ws", "tp")}, tmp_path)


def test_applicable_shapes_have_no_decode():
    names = [s.name for s in applicable_shapes(get_arch(ARCH))]
    assert names == [s.name for s in
                     jbase.applicable_shapes(jax_get_arch(ARCH))]
    assert names == ["train_4k", "prefill_32k"]


@pytest.mark.parametrize("size", ["smoke", "full"])
def test_synthetic_inputs_are_the_reference_s(size):
    """Same draws from the same ``np.random.default_rng``, twice in a row,
    at smoke size and at full width (frames of 1280)."""
    jcfg, tcfg = jax_get_arch(ARCH), get_arch(ARCH)
    if size == "smoke":
        jcfg, tcfg = jax_smoke_variant(jcfg), smoke_variant(tcfg)
    jrng, trng = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(2):
        ref = jax.device_get(jfe.synthetic_inputs(jcfg, 2, 24, jrng))
        got = tfe.synthetic_inputs(tcfg, 2, 24, trng, device="cpu")
        assert set(got) == set(ref) == {"embeddings", "targets", "mask"}
        for k, r in ref.items():
            assert str(got[k].dtype).removeprefix("torch.") == str(r.dtype)
            np.testing.assert_array_equal(got[k].numpy(), r, err_msg=k)
    assert got["embeddings"].shape == (2, 24, tcfg.d_model)
