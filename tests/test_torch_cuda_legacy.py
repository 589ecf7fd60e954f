"""The legacy 4-pass contrastive kernels (``row_col_lse`` and ``grads``)
against their plain PyTorch versions, on the card, with their launch
counters. Every test here needs a CUDA card and the CUDA toolkit; on a host
without a card they skip (the card is looked for inside a fixture, never at
import). Run them on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_legacy.py

Tolerances are those of the fused pair's card tests
(tests/test_torch_cuda_train.py): LSE 5e-5 abs (fp32 sums of up to 2048
exponentials of values up to ~15 in another order); dX / dY 1e-6 abs and
dlog_tau 1e-4 rel in f32, the reference's (tests/test_kernels.py); under
bf16 inputs dX / dY within 2^-6 of the tensor's max |ref| (dA rounds to
bf16 on both sides) and dlog_tau 2e-2 rel. At B = 1 and 2 the 4-pass
path's dX / dY stay within 1e-6 of the plain oracle: the backward recomputes
A and needs exp(A − row_lse) + exp(A − col_lse) − 2 to cancel exactly at
B = 1, which holds only while every kernel forms A in the same order.
"""
import pytest
import torch

from repro_torch.kernels.contrastive_loss import ops as cl_ops
from repro_torch.kernels.contrastive_loss.ref import (contrastive_grads_ref,
                                                      grads_ref, loss_ref,
                                                      row_col_lse_ref)

pytestmark = pytest.mark.cuda

LSE_TOL = 5e-5


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.device import resolve_device
    resolve_device("cuda")
    return torch.Generator(device="cuda").manual_seed(0)


def _unit(n, d, gen, dtype):
    x = torch.randn((n, d), generator=gen, device="cuda")
    return (x / x.norm(dim=1, keepdim=True)).to(dtype)


def _grad_tol(ref, dtype):
    if dtype == torch.float32:
        return 1e-6
    return 2.0 ** -6 * float(ref.abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,d", [(2048, 512), (1000, 512), (512, 1024),
                                 (64, 24), (1, 32), (130, 200), (300, 1500)])
def test_row_col_lse_kernel_matches_plain(gen, b, d, dtype):
    x, y = _unit(b, d, gen, dtype), _unit(b, d, gen, dtype)
    inv_tau = torch.tensor(1 / 0.07, device="cuda")
    before = cl_ops.ROW_COL_LSE_COUNTER.count
    row, col = cl_ops.row_col_lse(x, y, inv_tau)
    ref_row, ref_col = row_col_lse_ref(x, y, inv_tau)
    torch.cuda.synchronize()
    assert cl_ops.ROW_COL_LSE_COUNTER.count == before + 1
    assert row.dtype == torch.float32 and row.shape == (b,)
    assert float((row - ref_row).abs().max()) <= LSE_TOL
    assert float((col - ref_col).abs().max()) <= LSE_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,d", [(1, 64), (32, 40), (33, 40), (512, 256),
                                 (1000, 256), (1408, 64), (1409, 64),
                                 (4097, 32)])
def test_row_col_lse_kernel_at_each_plan_tile(gen, b, d, dtype):
    """Every tile edge ``lse_plan`` picks (32, 64, 128) and the batch sizes
    where it changes or a tile turns ragged."""
    x, y = _unit(b, d, gen, dtype), _unit(b, d, gen, dtype)
    inv_tau = torch.tensor(1 / 0.07, device="cuda")
    row, col = cl_ops.row_col_lse(x, y, inv_tau)
    ref_row, ref_col = row_col_lse_ref(x, y, inv_tau)
    torch.cuda.synchronize()
    assert float((row - ref_row).abs().max()) <= LSE_TOL
    assert float((col - ref_col).abs().max()) <= LSE_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,d", [(2048, 1024), (1000, 24), (512, 256)])
def test_row_col_lse_kernel_repeats_bit_for_bit(gen, b, d, dtype):
    x, y = _unit(b, d, gen, dtype), _unit(b, d, gen, dtype)
    inv_tau = torch.tensor(1 / 0.07, device="cuda")
    first = cl_ops.row_col_lse(x, y, inv_tau)
    second = cl_ops.row_col_lse(x, y, inv_tau)
    torch.cuda.synchronize()
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("b,d", [(1, 64), (1, 1024), (2, 64), (2, 512)])
def test_4pass_path_cancels_exactly_at_tiny_batches(gen, b, d):
    x, y = _unit(b, d, gen, torch.float32), _unit(b, d, gen, torch.float32)
    lt = torch.tensor(-1.0, device="cuda")
    loss, dx, dy, dtau = cl_ops.fused_contrastive_loss_4pass(x, y, lt)
    rx, ry, rt = contrastive_grads_ref(x, y, lt)
    xr, yr, ltr = (t.clone().requires_grad_() for t in (x, y, lt))
    gx, gy, _ = torch.autograd.grad(
        cl_ops.fused_contrastive_loss(xr, yr, ltr), (xr, yr, ltr))
    torch.cuda.synchronize()
    assert abs(float(loss - loss_ref(x, y, lt))) <= LSE_TOL
    for got, r, f in ((dx, rx, gx), (dy, ry, gy)):
        assert float((got - r).abs().max()) <= 1e-6
        assert float((got - f).abs().max()) <= 1e-6
    if b == 1:   # one pair: dA = 1 + 1 − 2 = 0, bit for bit
        assert not bool(dx.any()) and not bool(dy.any())
    assert abs(float(dtau - rt)) <= 1e-4 * abs(float(rt)) + 1e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b_norm,with_diag", [(None, True), ("3B", False),
                                              (None, False), ("3B", True)])
@pytest.mark.parametrize("b,d", [(2048, 512), (1000, 512), (130, 200),
                                 (1, 24), (1000, 1024), (130, 24)])
def test_grads_kernel_matches_plain(gen, b, d, b_norm, with_diag, dtype):
    x, y = _unit(b, d, gen, dtype), _unit(b, d, gen, dtype)
    inv_tau = torch.tensor(1 / 0.07, device="cuda")
    row, col = row_col_lse_ref(x, y, inv_tau)
    bn_arg = None if b_norm is None else 3 * b
    before = (cl_ops.GRADS_COUNTER.count, cl_ops.BWD_COUNTER.count)
    got = cl_ops.grads(x, y, inv_tau, row, col, b_norm=bn_arg,
                       with_diag=with_diag)
    ref = grads_ref(x, y, inv_tau, row, col, b_norm=bn_arg,
                    with_diag=with_diag)
    torch.cuda.synchronize()
    assert (cl_ops.GRADS_COUNTER.count,
            cl_ops.BWD_COUNTER.count) == (before[0] + 1, before[1])
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.float32
    for g, r in zip(got[:2], ref[:2]):
        assert float((g - r).abs().max()) <= _grad_tol(r, dtype)
    rtol = 1e-4 if dtype == torch.float32 else 2e-2
    assert abs(float(got[2] - ref[2])) <= rtol * abs(float(ref[2])) + 1e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,d", [(2048, 1024), (1000, 24)])
def test_grads_kernel_repeats_bit_for_bit(gen, b, d, dtype):
    x, y = _unit(b, d, gen, dtype), _unit(b, d, gen, dtype)
    inv_tau = torch.tensor(1 / 0.07, device="cuda")
    row, col = row_col_lse_ref(x, y, inv_tau)
    first = cl_ops.grads(x, y, inv_tau, row, col, b_norm=3 * b,
                         with_diag=False)
    second = cl_ops.grads(x, y, inv_tau, row, col, b_norm=3 * b,
                          with_diag=False)
    torch.cuda.synchronize()
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("b,d", [(2048, 512), (777, 256)])
def test_4pass_path_matches_the_fused_loss_and_the_oracle(gen, b, d):
    x, y = _unit(b, d, gen, torch.float32), _unit(b, d, gen, torch.float32)
    lt = torch.tensor(-1.0, device="cuda")
    counts = (cl_ops.ROW_COL_LSE_COUNTER.count, cl_ops.GRADS_COUNTER.count)
    loss, dx, dy, dtau = cl_ops.fused_contrastive_loss_4pass(x, y, lt)
    torch.cuda.synchronize()
    assert (cl_ops.ROW_COL_LSE_COUNTER.count,
            cl_ops.GRADS_COUNTER.count) == (counts[0] + 1, counts[1] + 1)
    xr, yr, ltr = (t.clone().requires_grad_() for t in (x, y, lt))
    fused = cl_ops.fused_contrastive_loss(xr, yr, ltr)
    gx, gy, gt = torch.autograd.grad(fused, (xr, yr, ltr))
    assert abs(float(loss - fused.detach())) <= LSE_TOL
    assert abs(float(loss - loss_ref(x, y, lt))) <= LSE_TOL
    rx, ry, rt = contrastive_grads_ref(x, y, lt)
    for got, f, r in ((dx, gx, rx), (dy, gy, ry)):
        assert float((got - f).abs().max()) <= 1e-6
        assert float((got - r).abs().max()) <= 1e-6
    assert abs(float(dtau - gt)) <= 1e-4 * abs(float(gt)) + 1e-6
    assert abs(float(dtau - rt)) <= 1e-4 * abs(float(rt)) + 1e-6


def test_legacy_kernels_refuse_what_they_do_not_take(gen):
    x = _unit(8, 1100, gen, torch.float32)
    row, col = row_col_lse_ref(x, x, 1.0)
    with pytest.raises(ValueError, match="D <="):
        cl_ops.grads(x, x, 1.0, row, col)
    with pytest.raises(TypeError):
        cl_ops.row_col_lse(x.half(), x.half(), 1.0)
    with pytest.raises(ValueError, match="contiguous"):
        cl_ops.row_col_lse(x.T, x.T, 1.0)
