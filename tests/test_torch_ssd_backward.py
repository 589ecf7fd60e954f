"""Port parity: the SSD scan's backward on the CPU. ``ssd_chunked_bwd``
(the plain version of ``csrc/ssd_bwd.cu``, in the kernel's chunked order)
against ``jax.vjp`` of the reference's ``ssd_chunked``
(``repro/models/ssm.py:71``) plus the ``D·x`` its mixer adds, from the same
numpy inputs; the differentiable ``ssd_scan`` (``ops._Scan``, the Function
the card runs) through ``gradcheck`` in float64 and against autograd of
the plain forward; its plumbing; and the Mamba-2 mixer's gradients through
it.

Tolerance: 2e-5 of each gradient's max |value|, the repo's ``GA_RTOL``;
fp32 on both sides, sums in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.ssm import ssd_chunked as jssd_chunked
from repro_torch.configs import get_arch, smoke_variant
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import (chunk_of, ssd_chunked,
                                              ssd_chunked_bwd)
from repro_torch.models import ssm as tssm

torch.set_num_threads(1)

GA_RTOL = 2e-5
NAMES = ("x", "dt", "A", "Bm", "Cm", "D", "init_state")


def _inputs(seed, b, l, h, p, n, init, dfinal):
    """(x, dt, A, Bm, Cm, D, init_state or None), dy, dfinal or None as
    float32 numpy: dt = softplus(N)·0.5, A = -exp(0.3·N), B and C at
    0.5·N (the reference test's laws)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((b, l, h, p)).astype(f)
    dt = (np.log1p(np.exp(rng.standard_normal((b, l, h)))) * 0.5).astype(f)
    A = (-np.exp(rng.standard_normal(h) * 0.3)).astype(f)
    Bm = (rng.standard_normal((b, l, n)) * 0.5).astype(f)
    Cm = (rng.standard_normal((b, l, n)) * 0.5).astype(f)
    D = rng.uniform(0.5, 1.5, h).astype(f)
    s0 = rng.standard_normal((b, h, p, n)).astype(f) if init else None
    dy = rng.standard_normal((b, l, h, p)).astype(f)
    df = rng.standard_normal((b, h, p, n)).astype(f) if dfinal else None
    return (x, dt, A, Bm, Cm, D, s0), dy, df


def _close(name, got, want, rtol=GA_RTOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    scale = np.abs(want).max()
    assert scale > 0, name
    err = np.abs(got - want).max()
    assert err <= rtol * scale, f"{name}: {err:.3g} > {rtol} · {scale:.3g}"


def _reference_grads(args, dy, df, chunk, with_d=True):
    """jax.vjp of the reference's ssd_chunked (+ D·x) at the numpy
    inputs: gradients by NAMES (None for an absent init_state)."""
    x, dt, A, Bm, Cm, D, s0 = (None if a is None else jnp.asarray(a)
                               for a in args)
    c = min(chunk, x.shape[1])

    def f(x, dt, A, Bm, Cm, D, s0):
        y, final = jssd_chunked(x, dt, A, Bm, Cm, c, s0)
        if with_d:
            y = y + D[None, None, :, None] * x
        return y, final

    (y, final), vjp = jax.vjp(f, x, dt, A, Bm, Cm, D, s0)
    cot = (jnp.asarray(dy),
           jnp.zeros_like(final) if df is None else jnp.asarray(df))
    return dict(zip(NAMES, vjp(cot)))


CASES = {
    # (b, l, h, p, n, chunk, init_state, dfinal)
    "one chunk": (2, 16, 3, 8, 6, 16, False, False),
    "chunks, state in and out": (2, 32, 3, 8, 6, 8, True, True),
    "ragged, one chunk": (1, 12, 2, 4, 5, 16, True, False),
    "ragged, chunks": (2, 18, 2, 4, 5, 6, False, True),
    "mamba2 head": (1, 64, 2, 64, 16, 32, True, True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_matches_reference_vjp(case):
    b, l, h, p, n, chunk, init, dfinal = CASES[case]
    args, dy, df = _inputs(sum(map(ord, case)), b, l, h, p, n, init, dfinal)
    want = _reference_grads(args, dy, df, chunk)
    t = [None if a is None else torch.from_numpy(a) for a in args]
    got = ssd_chunked_bwd(*t, torch.from_numpy(dy),
                          None if df is None else torch.from_numpy(df),
                          chunk_of(l, chunk))
    for name, g in zip(NAMES, got):
        if name == "init_state" and not init:
            assert g is None and want[name] is None
            continue
        _close(f"{case} d{name}", g.numpy(), np.asarray(want[name]))


def test_plain_backward_without_d():
    args, dy, _ = _inputs(5, 2, 24, 2, 8, 6, True, False)
    want = _reference_grads(args, dy, None, 8, with_d=False)
    t = [torch.from_numpy(a) for a in args]
    t[5] = None
    got = ssd_chunked_bwd(*t, torch.from_numpy(dy), None, 8)
    assert got[5] is None
    for name, g in zip(NAMES, got):
        if name != "D":
            _close(f"d{name}", g.numpy(), np.asarray(want[name]))


def test_scan_function_gradcheck_float64():
    rng = np.random.default_rng(7)
    b, l, h, p, n, chunk = 1, 8, 2, 4, 3, 4

    def leaf(shape, scale=1.0, fn=None):
        a = rng.standard_normal(shape) * scale
        a = a if fn is None else fn(a)
        return torch.tensor(a, dtype=torch.float64, requires_grad=True)

    args = (leaf((b, l, h, p)), leaf((b, l, h), 1.0,
                                     lambda a: np.log1p(np.exp(a)) * 0.5),
            leaf((h,), 0.3, lambda a: -np.exp(a)), leaf((b, l, n), 0.5),
            leaf((b, l, n), 0.5), leaf((h,), 0.5), leaf((b, h, p, n)))

    def scan(x, dt, A, Bm, Cm, D, s0):
        return ssd_ops.ssd_scan(x, dt, A, Bm, Cm, D, chunk=chunk,
                                init_state=s0)

    y, _ = scan(*args)
    assert type(y.grad_fn).__name__ == "_ScanBackward"
    assert torch.autograd.gradcheck(scan, args, eps=1e-6, atol=1e-8,
                                    rtol=1e-6)


def _torch_args(seed, b, l, h, p, n, dtype=torch.float32, grad=True):
    args, dy, df = _inputs(seed, b, l, h, p, n, True, True)
    t = [torch.from_numpy(a) for a in args]
    t = [a.to(dtype) if i in (0, 3, 4) else a for i, a in enumerate(t)]
    return ([a.requires_grad_(grad) for a in t], torch.from_numpy(dy),
            torch.from_numpy(df))


def test_scan_function_matches_autograd_of_plain_forward():
    """The Function's gradients equal autograd through ``ssd_chunked``
    when both outputs are read, and when only y is (the final state's
    gradient then reaches the backward as None)."""
    for read_final in (True, False):
        t, dy, df = _torch_args(11, 2, 48, 3, 16, 8)
        y, final = ssd_ops.ssd_scan(*t[:6], chunk=16, init_state=t[6])
        loss = (y * dy).sum() + ((final * df).sum() if read_final else 0)
        got = torch.autograd.grad(loss, t)
        y2, final2 = ssd_chunked(t[0], t[1], t[2], t[3], t[4], 16, t[6],
                                 t[5])
        loss2 = (y2 * dy).sum() + ((final2 * df).sum() if read_final else 0)
        want = torch.autograd.grad(loss2, t)
        for name, g, w in zip(NAMES, got, want):
            _close(f"d{name} (final read: {read_final})", g.numpy(),
                   w.numpy())


def test_scan_function_plumbing():
    """Gradients come in each input's dtype (bf16 x, B, C give bf16), None
    for an input that needs none; no forward without grad mode is
    differentiable, and the CPU path counts no kernel launch."""
    t, dy, _ = _torch_args(13, 1, 32, 2, 16, 8, torch.bfloat16)
    t[2].requires_grad_(False)
    before = (ssd_ops.COUNTER.count, ssd_ops.BWD_COUNTER.count)
    y, _ = ssd_ops.ssd_scan(*t[:6], chunk=16, init_state=t[6])
    (y * dy).sum().backward()
    for name, a in zip(NAMES, t):
        if name == "A":
            assert a.grad is None
        else:
            assert a.grad is not None and a.grad.dtype == a.dtype, name
            assert bool(torch.isfinite(a.grad.float()).all()), name
    assert t[0].grad.dtype == torch.bfloat16
    assert (ssd_ops.COUNTER.count, ssd_ops.BWD_COUNTER.count) == before
    with torch.no_grad():
        y, final = ssd_ops.ssd_scan(*t[:6], chunk=16, init_state=t[6])
    assert y.grad_fn is None and final.grad_fn is None


def test_scan_function_through_split_views():
    """x, B and C as the mixer passes them, views of one (b, l, h·p + 2n)
    buffer: the buffer's gradient is the three inputs' gradients laid side
    by side."""
    b, l, h, p, n = 2, 32, 2, 16, 8
    t, dy, df = _torch_args(17, b, l, h, p, n)
    buf = torch.cat([t[0].detach().reshape(b, l, h * p), t[3].detach(),
                     t[4].detach()], dim=-1).requires_grad_()
    x = buf[..., :h * p].reshape(b, l, h, p)
    Bm, Cm = buf[..., h * p:h * p + n], buf[..., h * p + n:]
    assert x.data_ptr() == buf.data_ptr()
    y, final = ssd_ops.ssd_scan(x, *t[1:3], Bm, Cm, t[5], chunk=16,
                                init_state=t[6])
    ((y * dy).sum() + (final * df).sum()).backward()
    y2, final2 = ssd_ops.ssd_scan(*t[:6], chunk=16, init_state=t[6])
    ((y2 * dy).sum() + (final2 * df).sum()).backward()
    g = buf.grad
    np.testing.assert_array_equal(
        g[..., :h * p].reshape(b, l, h, p).numpy(), t[0].grad.numpy())
    np.testing.assert_array_equal(g[..., h * p:h * p + n].numpy(),
                                  t[3].grad.numpy())
    np.testing.assert_array_equal(g[..., h * p + n:].numpy(),
                                  t[4].grad.numpy())


@pytest.mark.parametrize("arch", ["mamba2-130m", "jamba-1.5-large-398b"])
def test_mixer_gradients_reach_every_leaf(arch):
    """Every leaf of a smoke Mamba-2 mixer gets a non-zero gradient, and y
    comes out of the differentiable scan."""
    cfg = smoke_variant(get_arch(arch))
    params = tssm.init_ssm_params(cfg, torch.Generator().manual_seed(0),
                                  device="cpu")
    live = {k: v.detach().requires_grad_() for k, v in params.items()}
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 2 * cfg.ssm.chunk, cfg.d_model)).astype(np.float32))
    seen = []
    real = ssd_ops.ssd_scan

    def spy(*a, **k):
        out = real(*a, **k)
        seen.append(type(out[0].grad_fn).__name__)
        return out
    tssm.ssd_scan, saved = spy, tssm.ssd_scan
    try:
        out, _ = tssm.mamba_mixer(live, cfg, x)
    finally:
        tssm.ssd_scan = saved
    assert seen == ["_ScanBackward"]
    out.square().mean().backward()
    assert set(live) == {"in_z", "in_x", "in_B", "in_C", "in_dt", "conv_w",
                         "dt_bias", "A_log", "D", "out"}
    for name, leaf in live.items():
        assert leaf.grad is not None and bool(
            (leaf.grad.abs() > 0).any()), name


@pytest.mark.parametrize("n,p,want", [(128, 64, 64), (256, 64, 16),
                                      (64, 32, 32), (16, 16, 16)])
def test_backward_plan_fits_shared_memory(n, p, want):
    plan = ssd_ops.ssd_bwd_plan(2, 4096, 24, p, n)
    assert plan.p_block == want
    assert plan.smem == ssd_ops.bwd_smem_bytes(want, n) <= ssd_ops.MAX_SMEM
    assert plan.grid == (64, 48, p // want)
    nsub, npb = 64, p // want
    assert plan.scratch == (48 * nsub * p * n, 48 * nsub,
                            24 * npb * 2 * 4096 * n, 24 * npb * 2 * 4096 * n,
                            npb * 2 * 4096 * 24, 2 * nsub * npb * 24,
                            2 * nsub * npb * 24)


def test_backward_plan_refuses_what_the_kernel_does_not_take():
    for p, n in ((24, 128), (64, 12), (64, 264)):
        with pytest.raises(ValueError, match="multiple"):
            ssd_ops.ssd_bwd_plan(1, 64, 2, p, n)
    with pytest.raises(ValueError, match="65535"):
        ssd_ops.ssd_bwd_plan(512, 64, 256, 64, 128)


def test_backward_wrapper_runs_only_on_the_card():
    t, dy, _ = _torch_args(19, 1, 64, 2, 16, 8, grad=False)
    with pytest.raises(ValueError, match="runs on cuda"):
        ssd_ops.ssd_scan_bwd(*t, torch.zeros(1, 2, 1, 16, 8),
                             torch.zeros(1, 2, 16, 8), dy)

