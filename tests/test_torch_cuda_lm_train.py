"""LM training on the card: the flash kernels' causal grouped-query
backward against its plain version, one Llama step on the kernel path
against the plain path at smoke size, and ``--mode lm`` with a checkpoint
(the SSM family's training on the card is tested in
tests/test_torch_cuda_ssd.py).
Every test here needs a CUDA card and the CUDA toolkit; on a host without
a card they skip (the card is looked for inside a fixture, never at
import). Run them on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_lm_train.py

Tolerances, each with its reason:
- flash forward: tests/test_torch_cuda_kernels.py's (f32 5e-5, bf16 1.6e-2,
  one ulp of an output below 4; lse 5e-5).
- flash backward: as tests/test_torch_cuda_train.py (f32 2e-4 abs, the
  reference's gradient tolerance; bf16 2 ulps of |ref| plus 1e-3 of the
  tensor's max |ref| plus 1e-5); dk and dv here sum the four query heads
  of each kv head, which both sides add in another order.
- the LM step, kernel path (flash) against plain path (chunked attention)
  in f32: the loss within 1e-4 and every gradient leaf within 1e-3 of its
  largest entry, ``chip_smoke.py``'s training-parity limits (fp32 sums in
  another order through every layer's backward).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import checkpoint as ckpt
from repro_torch import interop
from repro_torch.configs import get_arch, smoke_variant
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import (flash_bwd_ref,
                                                     flash_fwd_ref)
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import transformer as tf

pytestmark = pytest.mark.cuda

BF16_ULP = 2.0 ** -7
# the forward's limits, tests/test_torch_cuda_kernels.py's: fp32 sums over
# the keys in another order; one bf16 ulp of an output of magnitude < 4
FWD_TOL = {torch.float32: 5e-5, torch.bfloat16: 1.6e-2}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.device import resolve_device
    resolve_device("cuda")
    return torch.Generator(device="cuda").manual_seed(0)


def _close(got, ref, dtype):
    err = (got.float() - ref.float()).abs()
    if dtype == torch.float32:
        return bool((err <= 2e-4).all()), float(err.max())
    r = ref.float().abs()
    lim = 2 * BF16_ULP * r + 1e-3 * r.max() + 1e-5
    return bool((err <= lim).all()), float(err.max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,window", [(1024, 8192), (520, 200), (64, None)])
def test_causal_gqa_backward_matches_plain(gen, dtype, s, window):
    """Llama's attention: 32 query heads over 8 kv heads (groups of 4),
    d 64, causal, the window past the sequence, inside it, or none."""
    b, h, kv, d = 2, 32, 8, 64
    q, dout = (torch.randn((b * h, s, d), generator=gen, device="cuda")
               .to(dtype) for _ in range(2))
    k, v = (torch.randn((b * kv, s, d), generator=gen, device="cuda")
            .to(dtype) for _ in range(2))
    out, lse = fa_ops.flash_fwd(q, k, v, causal=True, window=window)
    ref_out, ref_lse = flash_fwd_ref(q, k, v, causal=True, window=window)
    err = float((out.float() - ref_out.float()).abs().max())
    assert err <= FWD_TOL[dtype]
    assert float((lse - ref_lse).abs().max()) <= 5e-5
    args = (q, k, v, None, ref_out, ref_lse, dout)
    got = fa_ops.flash_bwd(*args, causal=True, window=window)
    ref = flash_bwd_ref(*args, causal=True, window=window)
    assert got[1].shape == (b * kv, s, d)
    for name, x, r in zip(("dq", "dk", "dv"), got, ref):
        ok, err = _close(x, r, dtype)
        assert ok, (name, err)


def test_lm_step_kernel_path_matches_plain_path(gen):
    cfg = smoke_variant(get_arch("llama3.2-1b"))
    params = interop.init_params(cfg, torch.Generator(device="cuda")
                                 .manual_seed(1), "cuda")
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (2, 128)).astype(np.int32)).cuda()}
    res = {}
    for attn in ("pallas", "chunked"):
        c = dataclasses.replace(cfg, attn_impl=attn)
        for ctr in (fa_ops.COUNTER, fa_ops.BWD_COUNTER):
            ctr.reset()
        loss, _, grads = tsteps.value_and_grad(
            lambda p: tf.lm_loss(c, p, batch), params)
        res[attn] = (float(loss), dict(interop.leaves(grads)),
                     (fa_ops.COUNTER.count, fa_ops.BWD_COUNTER.count))
    (lk, gk, nk), (lp, gp, np_) = res["pallas"], res["chunked"]
    assert nk == (cfg.n_layers, cfg.n_layers) and np_ == (0, 0)
    assert abs(lk - lp) <= 1e-4
    for path, g in gp.items():
        err = float((gk[path] - g).abs().max())
        assert err <= 1e-3 * float(g.abs().max()), (path, err)


def test_mode_lm_trains_saves_and_restores_on_the_card(gen, tmp_path):
    rep = ttrain.main(["--mode", "lm", "--arch", "llama3.2-1b", "--smoke",
                       "--steps", "2", "--batch", "2", "--seq", "128",
                       "--ckpt-dir", str(tmp_path)])
    assert rep["device"].startswith("cuda") and len(rep["losses"]) == 2
    assert all(np.isfinite(rep["losses"]))
    ckpt.verify(str(tmp_path), 2)
    like = interop.to_device(rep["params"], "meta")
    back = ckpt.restore(str(tmp_path), 2, like, device="cuda")
    for (path, a), (_, b) in zip(interop.leaves(back),
                                 interop.leaves(rep["params"])):
        assert torch.equal(a, b), path
