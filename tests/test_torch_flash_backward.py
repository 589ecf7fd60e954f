"""Port parity: gradients through the port's ``flash_attention`` (on a CPU
tensor: its plain forward and backward inside the autograd Function)
against ``jax.grad`` through the reference's
``repro.kernels.flash_attention.ops.flash_attention`` (Pallas in interpret
mode), and the port's ``flash_bwd_ref`` against the reference's
``flash_bwd_bh`` from the same ``out`` and ``lse``.

Inputs are drawn with numpy from a seed. Tolerances are the reference's own
gradient tolerances (tests/test_attention_backends.py): f32 2e-4, bf16
1e-1.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jfa_ops
from repro.kernels.flash_attention.kernel import flash_bwd_bh, flash_fwd_bh
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import (NEG_INF, flash_bwd_ref,
                                                     flash_fwd_ref)

torch.set_num_threads(1)

GTOL = {"float32": 2e-4, "bfloat16": 1e-1}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(b, h, kv, s, d, padded, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, s, d)).astype(np.float32)
    k, v = (rng.standard_normal((b, kv, s, d)).astype(np.float32)
            for _ in range(2))
    w = rng.standard_normal((b, h, s, d)).astype(np.float32)
    mask = None
    if padded:
        lens = rng.integers(1, s + 1, b)
        lens[0] = s
        mask = np.arange(s)[None, :] < lens[:, None]
    return q, k, v, w, mask


def _jax_grads(q, k, v, w, mask, causal, window, dtype):
    def f(q, k, v):
        out = jfa_ops.flash_attention(q, k, v, causal=causal, window=window,
                                      key_mask=None if mask is None
                                      else jnp.asarray(mask))
        return jnp.sum(out.astype(jnp.float32) * w)
    g = jax.grad(f, argnums=(0, 1, 2))(
        *(jnp.asarray(x, JDT[dtype]) for x in (q, k, v)))
    return [np.asarray(x.astype(jnp.float32)) for x in g]


def _torch_grads(q, k, v, w, mask, causal, window, dtype):
    qt, kt, vt = (torch.tensor(x).to(TDT[dtype]).requires_grad_()
                  for x in (q, k, v))
    out = fa_ops.flash_attention(qt, kt, vt, causal=causal, window=window,
                                 key_mask=None if mask is None
                                 else torch.tensor(mask))
    g = torch.autograd.grad(torch.sum(out.float() * torch.tensor(w)),
                            (qt, kt, vt))
    assert all(x.dtype == TDT[dtype] for x in g)
    return [x.float().numpy() for x in g]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kv,s,causal,window,padded", [
    (2, 4, 4, 49, False, None, True),     # bidirectional, padded, ragged s
    (2, 4, 4, 24, True, None, False),     # causal
    (1, 2, 2, 33, True, 8, False),        # causal sliding window
    (2, 4, 2, 20, False, None, True),     # GQA group 2 with padding
    (1, 6, 2, 17, False, None, False),    # GQA group 3, no mask
])
def test_flash_attention_grads_match_reference(b, h, kv, s, causal, window,
                                               padded, dtype):
    q, k, v, w, mask = _inputs(b, h, kv, s, 64, padded, seed=s + h + kv)
    got = _torch_grads(q, k, v, w, mask, causal, window, dtype)
    ref = _jax_grads(q, k, v, w, mask, causal, window, dtype)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a, r, rtol=GTOL[dtype], atol=GTOL[dtype],
                                   err_msg=name)


@pytest.mark.parametrize("causal,window,padded,group", [
    (False, None, True, 1), (True, None, False, 1), (True, 6, False, 1),
    (False, None, False, 2)])
def test_flash_bwd_ref_matches_reference_kernel(causal, window, padded,
                                                group):
    """The plain backward against the reference's blockwise Pallas backward
    (interpret mode), from the same out and lse. The reference kernel takes
    k and v repeated over the group and returns per-query-head dk/dv; the
    port sums them over the group."""
    rng = np.random.default_rng(7 + group)
    bh, s, d = 4, 24, 64
    q, out_w = (rng.standard_normal((bh, s, d)).astype(np.float32)
                for _ in range(2))
    k, v = (rng.standard_normal((bh // group, s, d)).astype(np.float32)
            for _ in range(2))
    bias = None
    if padded:
        bias = np.where(np.arange(s)[None, :] < np.array([[s], [5], [s],
                                                          [11]]),
                        0.0, NEG_INF).astype(np.float32)
    kr, vr = (np.repeat(x, group, axis=0) for x in (k, v))
    jargs = [jnp.asarray(x) for x in (q, kr, vr)]
    jbias = None if bias is None else jnp.asarray(bias)
    out, lse = flash_fwd_bh(*jargs, jbias, causal=causal, window=window,
                            block_q=8, block_k=8, interpret=True)
    dq, dk, dv = flash_bwd_bh(*jargs, jbias, out, lse, jnp.asarray(out_w),
                              causal=causal, window=window, block_q=8,
                              block_k=8, interpret=True)
    t_out, t_lse = flash_fwd_ref(torch.tensor(q), torch.tensor(k),
                                 torch.tensor(v), None if bias is None
                                 else torch.tensor(bias), causal=causal,
                                 window=window)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(out), rtol=2e-5,
                               atol=2e-5)
    got = flash_bwd_ref(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                        None if bias is None else torch.tensor(bias),
                        torch.tensor(np.asarray(out)),
                        torch.tensor(np.asarray(lse)),
                        torch.tensor(out_w), causal=causal, window=window)
    ref = [np.asarray(dq),
           np.asarray(dk).reshape(bh // group, group, s, d).sum(1),
           np.asarray(dv).reshape(bh // group, group, s, d).sum(1)]
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a.numpy(), r, rtol=2e-4, atol=2e-4,
                                   err_msg=name)


def test_flash_bwd_wrapper_runs_the_plain_version_on_cpu():
    rng = np.random.default_rng(3)
    q, k, v, dout = (torch.tensor(rng.standard_normal((6, 13, 64))
                                  .astype(np.float32)) for _ in range(4))
    out, lse = fa_ops.flash_fwd(q, k, v, causal=False)
    before = fa_ops.BWD_COUNTER.count
    got = fa_ops.flash_bwd(q, k, v, None, out, lse, dout, causal=False)
    ref = flash_bwd_ref(q, k, v, None, out, lse, dout, causal=False)
    assert fa_ops.BWD_COUNTER.count == before     # no kernel on the CPU
    for a, r in zip(got, ref):
        assert torch.equal(a, r)
    with pytest.raises(ValueError, match="do not match"):
        fa_ops.flash_bwd(q, k, v, None, out[:, :5], lse, dout)
