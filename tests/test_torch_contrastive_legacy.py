"""Port parity: the legacy 4-pass contrastive pair against the JAX
reference on the CPU.

``row_col_lse`` and ``grads`` (their plain versions on a CPU tensor) are
held against the reference's ``kernel.row_col_lse`` / ``kernel.grads``
(Pallas in interpret mode, explicit blocks), ``grads`` over ``b_norm`` and
``with_diag``; ``fused_loss_and_lse_4pass`` and
``fused_contrastive_loss_4pass`` against the reference's ops of the same
names, and against the port's fused loss. Ragged B, which the reference's
kernels do not take, is held against the closed-form oracle.

Tolerances are the reference's (tests/test_fused_contrastive.py:71-117):
f32 LSE 1e-5 relative, dX / dY 1e-5 abs, dlog_tau 1e-4 rel and 1e-6 abs;
2e-2 under bf16 inputs. The 4-pass path against the fused one: loss 1e-6
rel, dX / dY 1e-6 abs, dlog_tau 1e-5 rel and 1e-7 abs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.contrastive_loss import kernel as jkernel
from repro.kernels.contrastive_loss import ops as jops
from repro_torch.kernels.contrastive_loss import ops as tops
from repro_torch.kernels.contrastive_loss.ref import (contrastive_fwd_ref,
                                                      contrastive_grads_ref)

torch.set_num_threads(1)

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": dict(lse=1e-5, grad=1e-5, dtau=1e-4, dtau_abs=1e-6),
       "bfloat16": dict(lse=2e-2, grad=2e-2, dtau=2e-2, dtau_abs=2e-2)}
SHAPES = [(64, 32, 16, 32), (96, 48, 32, 32)]      # (B, D, bm, bn)
INV_TAU = 1 / 0.07


def _pair(b, d, seed):
    rng = np.random.default_rng(seed)
    x, y = (rng.standard_normal((b, d)).astype(np.float32) for _ in range(2))
    return (x / np.linalg.norm(x, axis=1, keepdims=True),
            y / np.linalg.norm(y, axis=1, keepdims=True))


def _t(a, dtype="float32"):
    return torch.tensor(np.asarray(a, np.float32)).to(TDT[dtype])


def _j(a, dtype="float32"):
    return jnp.asarray(a, JDT[dtype])


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _check_grads(got, ref, tol):
    for a, r in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(_np(a), _np(r), atol=tol["grad"], rtol=0)
    np.testing.assert_allclose(float(got[2]), float(ref[2]),
                               rtol=tol["dtau"], atol=tol["dtau_abs"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,d,bm,bn", SHAPES)
def test_row_col_lse_matches_reference_kernel(b, d, bm, bn, dtype):
    x, y = _pair(b, d, seed=b + d)
    jrow, jcol = jkernel.row_col_lse(_j(x, dtype), _j(y, dtype), INV_TAU,
                                     bm=bm, bn=bn, interpret=True)
    trow, tcol = tops.row_col_lse(_t(x, dtype), _t(y, dtype), INV_TAU)
    assert trow.dtype == torch.float32 and trow.shape == (b,)
    tol = TOL[dtype]["lse"]
    np.testing.assert_allclose(_np(trow), _np(jrow), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(tcol), _np(jcol), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_diag", [True, False])
@pytest.mark.parametrize("b_norm", [None, "3B"])
@pytest.mark.parametrize("b,d,bm,bn", SHAPES)
def test_grads_matches_reference_kernel(b, d, bm, bn, b_norm, with_diag,
                                        dtype):
    x, y = _pair(b, d, seed=2 * b + d)
    bn_arg = None if b_norm is None else 3 * b
    jrow, jcol = jkernel.row_col_lse(_j(x), _j(y), INV_TAU, bm=bm, bn=bn,
                                     interpret=True)
    ref = jkernel.grads(_j(x, dtype), _j(y, dtype), INV_TAU, jrow, jcol,
                        bm=bm, bn=bn, interpret=True, b_norm=bn_arg,
                        with_diag=with_diag)
    got = tops.grads(_t(x, dtype), _t(y, dtype), INV_TAU,
                     torch.tensor(_np(jrow)), torch.tensor(_np(jcol)),
                     b_norm=bn_arg, with_diag=with_diag)
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.float32
    assert got[0].shape == (b, d) and got[2].shape == ()
    _check_grads(got, ref, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,d,bm,bn", SHAPES)
def test_4pass_ops_match_reference(b, d, bm, bn, dtype):
    x, y = _pair(b, d, seed=3 * b + d)
    lt = -0.8
    tol = TOL[dtype]
    jl, jr, jc = jops.fused_loss_and_lse_4pass(
        _j(x, dtype), _j(y, dtype), jnp.asarray(lt), True, bm, bn)
    tl, tr, tc = tops.fused_loss_and_lse_4pass(_t(x, dtype), _t(y, dtype),
                                               torch.tensor(lt))
    assert float(tl) == pytest.approx(float(jl), rel=tol["lse"],
                                      abs=tol["lse"])
    np.testing.assert_allclose(_np(tr), _np(jr), rtol=tol["lse"],
                               atol=tol["lse"])
    np.testing.assert_allclose(_np(tc), _np(jc), rtol=tol["lse"],
                               atol=tol["lse"])
    jout = jops.fused_contrastive_loss_4pass(_j(x, dtype), _j(y, dtype),
                                             jnp.asarray(lt), True, bm, bn)
    tout = tops.fused_contrastive_loss_4pass(_t(x, dtype), _t(y, dtype),
                                             torch.tensor(lt))
    assert float(tout[0]) == pytest.approx(float(jout[0]), rel=tol["lse"],
                                           abs=tol["lse"])
    assert tout[1].dtype == torch.float32 and tout[2].dtype == torch.float32
    _check_grads(tout[1:], jout[1:], tol)


def test_4pass_matches_the_fused_loss():
    """The reference's old-vs-new check (test_fused_contrastive.py:106-117)
    on the port: 4-pass values against the fused loss and its autograd."""
    x, y = _pair(96, 32, seed=4)
    xr, yr = _t(x).requires_grad_(), _t(y).requires_grad_()
    lt = torch.tensor(-0.5, requires_grad=True)
    l_new = tops.fused_contrastive_loss(xr, yr, lt)
    gx, gy, gt = torch.autograd.grad(l_new, (xr, yr, lt))
    l_old, dx, dy, dtau = tops.fused_contrastive_loss_4pass(
        _t(x), _t(y), torch.tensor(-0.5))
    assert not l_old.requires_grad and not dx.requires_grad
    assert float(l_old) == pytest.approx(float(l_new.detach()), rel=1e-6)
    np.testing.assert_allclose(dx.numpy(), gx.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(dy.numpy(), gy.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(float(dtau), float(gt), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("b", [1, 7, 37])
def test_4pass_takes_a_ragged_batch(b):
    """The reference's kernels ask for B % bm == 0; the port's do not. Held
    against the closed-form oracle (softmax over the materialised matrix)."""
    x, y = _pair(b, 12, seed=b + 50)
    lt = torch.tensor(-1.3)
    loss, dx, dy, dtau = tops.fused_contrastive_loss_4pass(_t(x), _t(y), lt)
    ref_loss, ref_row, ref_col, _ = contrastive_fwd_ref(_t(x), _t(y), lt)
    _, row, col = tops.fused_loss_and_lse_4pass(_t(x), _t(y), lt)
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-5, abs=1e-5)
    np.testing.assert_allclose(row.numpy(), ref_row.numpy(), rtol=1e-5)
    np.testing.assert_allclose(col.numpy(), ref_col.numpy(), rtol=1e-5)
    _check_grads((dx, dy, dtau), contrastive_grads_ref(_t(x), _t(y), lt),
                 TOL["float32"])


def test_a_cpu_call_never_touches_the_kernel_library(monkeypatch):
    def refuse():
        raise AssertionError("the kernel library was asked for on the CPU")

    monkeypatch.setattr(tops.LIB, "lib", refuse)
    before = (tops.ROW_COL_LSE_COUNTER.count, tops.GRADS_COUNTER.count)
    x, y = _pair(16, 8, seed=6)
    loss, dx, dy, dtau = tops.fused_contrastive_loss_4pass(
        _t(x), _t(y), torch.tensor(-1.0))
    row, col = tops.row_col_lse(_t(x), _t(y), 2.0)
    tops.grads(_t(x), _t(y), 2.0, row, col, b_norm=48, with_diag=False)
    assert np.isfinite(float(loss)) and torch.isfinite(dx).all()
    assert (tops.ROW_COL_LSE_COUNTER.count,
            tops.GRADS_COUNTER.count) == before
