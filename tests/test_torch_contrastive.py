"""Port parity: the contrastive loss of paper Eq. 3 and the fused kernels'
entry points against the JAX reference on the CPU.

``contrastive_loss`` (with label smoothing), ``fused_contrastive_loss``,
``fused_kernel_loss``, ``similarity`` and ``normalized_train_loss`` are held
against ``repro.core.contrastive`` and ``repro.kernels.contrastive_loss``
(Pallas in interpret mode) on the same numpy inputs; ``fwd_fused`` /
``bwd_fused`` (their plain versions on a CPU tensor) against the
reference's ``kernel.fwd_fused`` / ``kernel.bwd_fused`` with ``b_norm`` and
``with_diag``. Ragged B, which the reference's kernels do not take, is held
against the port's own materialising loss.

Tolerances are the reference's (tests/test_fused_contrastive.py,
tests/test_kernels.py): loss 1e-5, dX / dY 1e-6 abs, dlog_tau 1e-4 rel in
f32; 2e-2 under bf16 inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import contrastive as jcl
from repro.kernels.contrastive_loss import kernel as jkernel
from repro.kernels.contrastive_loss import ops as jops
from repro_torch.core import contrastive as tcl
from repro_torch.kernels.contrastive_loss import ops as tops

torch.set_num_threads(1)

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": dict(loss=1e-5, grad=1e-6, dtau=1e-4),
       "bfloat16": dict(loss=2e-2, grad=2e-2, dtau=2e-2)}


def _pair(b, d, seed):
    rng = np.random.default_rng(seed)
    x, y = (rng.standard_normal((b, d)).astype(np.float32) for _ in range(2))
    return (x / np.linalg.norm(x, axis=1, keepdims=True),
            y / np.linalg.norm(y, axis=1, keepdims=True))


def _t(a, dtype="float32"):
    return torch.tensor(np.asarray(a, np.float32)).to(TDT[dtype])


def _j(a, dtype="float32"):
    return jnp.asarray(a, JDT[dtype])


def _torch_value_and_grads(fn, x, y, log_tau, dtype):
    xt, yt = (_t(a, dtype).requires_grad_() for a in (x, y))
    lt = torch.tensor(log_tau, dtype=torch.float32, requires_grad=True)
    loss = fn(xt, yt, lt)
    g = torch.autograd.grad(loss, (xt, yt, lt))
    return float(loss.detach()), [a.float().numpy() for a in g]


def _jax_value_and_grads(fn, x, y, log_tau, dtype):
    loss, g = jax.value_and_grad(fn, argnums=(0, 1, 2))(
        _j(x, dtype), _j(y, dtype), jnp.asarray(log_tau, jnp.float32))
    return float(loss), [np.asarray(a.astype(jnp.float32)) for a in g]


def _check(got, ref, tol):
    assert got[0] == pytest.approx(ref[0], rel=tol["loss"], abs=tol["loss"])
    for a, r in zip(got[1][:2], ref[1][:2]):
        np.testing.assert_allclose(a, r, atol=tol["grad"], rtol=0)
    np.testing.assert_allclose(got[1][2], ref[1][2], rtol=tol["dtau"],
                               atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_contrastive_loss_matches_reference(dtype, smoothing):
    x, y = _pair(24, 16, seed=1)
    got = _torch_value_and_grads(
        lambda a, b, lt: tcl.contrastive_loss(
            a, b, torch.exp(lt), label_smoothing=smoothing)[0],
        x, y, -1.1, dtype)
    ref = _jax_value_and_grads(
        lambda a, b, lt: jcl.contrastive_loss(
            a, b, jnp.exp(lt), label_smoothing=smoothing)[0],
        x, y, -1.1, dtype)
    _check(got, ref, TOL[dtype])
    _, tm = tcl.contrastive_loss(_t(x), _t(y), torch.tensor(0.3),
                                 label_smoothing=smoothing)
    _, jm = jcl.contrastive_loss(_j(x), _j(y), jnp.asarray(0.3),
                                 label_smoothing=smoothing)
    for k in ("row_loss", "col_loss", "i2t_top1"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-5), k


@pytest.mark.parametrize("dtype,b,d", [("float32", 32, 16),
                                       ("float32", 64, 32),
                                       ("bfloat16", 32, 16)])
def test_fused_contrastive_loss_matches_reference_kernel(dtype, b, d):
    x, y = _pair(b, d, seed=b + d)
    got = _torch_value_and_grads(tops.fused_contrastive_loss, x, y, -0.8,
                                 dtype)
    ref = _jax_value_and_grads(
        lambda a, c, lt: jops.fused_contrastive_loss(a, c, lt, True),
        x, y, -0.8, dtype)
    _check(got, ref, TOL[dtype])


def test_fused_kernel_loss_matches_reference():
    x, y = _pair(16, 8, seed=5)
    tau = 0.07
    tl, tm = tcl.fused_kernel_loss(_t(x), _t(y), torch.tensor(tau))
    jl, jm = jcl.fused_kernel_loss(_j(x), _j(y), jnp.asarray(tau),
                                   interpret=True)
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    assert set(tm) == set(jm)
    assert all(float(v) == 0.0 for v in tm.values())
    # and it is the materialising loss's value
    assert float(tl) == pytest.approx(
        float(tcl.contrastive_loss(_t(x), _t(y), torch.tensor(tau))[0]),
        rel=1e-5)


@pytest.mark.parametrize("b", [1, 7, 37])
def test_fused_loss_takes_a_ragged_batch(b):
    """The reference's kernels ask for B % 8 == 0; the port's do not. Held
    against the port's own materialising loss."""
    x, y = _pair(b, 12, seed=b)
    got = _torch_value_and_grads(tops.fused_contrastive_loss, x, y, -1.3,
                                 "float32")
    ref = _torch_value_and_grads(
        lambda a, c, lt: tcl.contrastive_loss(a, c, torch.exp(lt))[0],
        x, y, -1.3, "float32")
    _check(got, ref, TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b_norm,with_diag", [(None, True), (96, False),
                                              (80, True)])
def test_fwd_bwd_fused_match_reference_kernels(dtype, b_norm, with_diag):
    x, y = _pair(32, 24, seed=9)
    inv_tau = 1 / 0.07
    jrow, jcol = jkernel.fwd_fused(_j(x, dtype), _j(y, dtype), inv_tau,
                                   bm=8, bn=16, interpret=True)
    trow, tcol = tops.fwd_fused(_t(x, dtype), _t(y, dtype), inv_tau)
    np.testing.assert_allclose(trow.numpy(), np.asarray(jrow), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tcol.numpy(), np.asarray(jcol), rtol=1e-5,
                               atol=1e-5)
    jdx, jdy, jdt = jkernel.bwd_fused(_j(x, dtype), _j(y, dtype), inv_tau,
                                      jrow, jcol, bm=8, bn=16,
                                      interpret=True, b_norm=b_norm,
                                      with_diag=with_diag)
    tdx, tdy, tdt = tops.bwd_fused(_t(x, dtype), _t(y, dtype), inv_tau,
                                   torch.tensor(np.asarray(jrow)),
                                   torch.tensor(np.asarray(jcol)),
                                   b_norm=b_norm, with_diag=with_diag)
    assert tdx.dtype == torch.float32 and tdy.dtype == torch.float32
    tol = TOL[dtype]
    np.testing.assert_allclose(tdx.numpy(), np.asarray(jdx),
                               atol=tol["grad"], rtol=0)
    np.testing.assert_allclose(tdy.numpy(), np.asarray(jdy),
                               atol=tol["grad"], rtol=0)
    np.testing.assert_allclose(float(tdt), float(jdt), rtol=tol["dtau"],
                               atol=1e-6)


def test_fused_loss_and_lse_matches_reference():
    x, y = _pair(16, 8, seed=11)
    tl, tr, tc = tops.fused_loss_and_lse(_t(x), _t(y), torch.tensor(-1.0))
    jl, jr, jc = jops.fused_loss_and_lse(_j(x), _j(y), jnp.asarray(-1.0),
                                         True)
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-5)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5)


def test_similarity_and_normalized_train_loss_match_reference():
    x, y = _pair(12, 6, seed=13)
    np.testing.assert_allclose(
        tcl.similarity(_t(x), _t(y), 0.5).numpy(),
        np.asarray(jcl.similarity(_j(x), _j(y), 0.5)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tcl.normalized_train_loss(_t(x), _t(y)).numpy(),
        np.asarray(jcl.normalized_train_loss(_j(x), _j(y))), rtol=1e-5)
