"""Port parity: the SSD scan's plain versions and the CPU path of the
``ssd_scan`` wrapper against the JAX reference on the CPU: the Pallas
kernel in interpret mode (``repro.kernels.ssd_scan.ops.ssd_scan``), the
sequential oracle ``ssd_ref`` and the model's ``ssd_chunked``, from the
same numpy inputs.

Tolerance: 2e-5 of max |y| (and of max |state|), the reference's own
(tests/test_kernels.py); 5e-5 at the decay extremes, as there. fp32
throughout, sums in another order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ops as jssd_ops
from repro.kernels.ssd_scan import ref as jssd_ref
from repro.models.ssm import ssd_chunked as jssd_chunked
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import (chunk_of, segsum, ssd_chunked,
                                              ssd_ref)

torch.set_num_threads(1)

TOL = 2e-5


def _inputs(seed, b, l, h, p, n, decay=None):
    """(x, dt, A, Bm, Cm, D) as float32 numpy: the reference test's laws
    (dt = softplus(N)·0.5, A = -exp(0.3·N), B and C at 0.5·N); ``decay``
    = (dt, A) fixes both."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((b, l, h)))) * 0.5).astype(
        np.float32)
    A = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    if decay is not None:
        dt = np.full((b, l, h), decay[0], np.float32)
        A = np.asarray(decay[1], np.float32)
    Bm = (rng.standard_normal((b, l, n)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((b, l, n)) * 0.5).astype(np.float32)
    D = rng.uniform(0.5, 1.5, h).astype(np.float32)
    return x, dt, A, Bm, Cm, D


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    scale = float(np.abs(want).max()) + 1e-6
    np.testing.assert_allclose(np.asarray(got) / scale, want / scale,
                               atol=tol)


SHAPES = [(2, 128, 4, 32, 16, 32), (1, 64, 2, 64, 32, 64),
          (1, 256, 8, 16, 8, 128), (2, 96, 3, 32, 16, 32)]


@pytest.mark.parametrize("b,l,h,p,n,chunk", SHAPES)
def test_wrapper_matches_the_reference_kernel_and_oracle(b, l, h, p, n,
                                                         chunk):
    x, dt, A, Bm, Cm, D = _inputs(l + h, b, l, h, p, n)
    want = jssd_ops.ssd_scan(*map(jnp.asarray, (x, dt, A, Bm, Cm, D)),
                             chunk=chunk, interpret=True)
    want_y, want_state = jssd_ref.ssd_ref(*map(jnp.asarray,
                                               (x, dt, A, Bm, Cm, D)))
    before = ssd_ops.COUNTER.count
    y, state = ssd_ops.ssd_scan(*map(torch.from_numpy, (x, dt, A, Bm, Cm, D)),
                                chunk=chunk)
    assert ssd_ops.COUNTER.count == before     # the plain version ran
    assert y.dtype == state.dtype == torch.float32
    _close(y.numpy(), want)
    _close(y.numpy(), want_y)
    _close(state.numpy(), want_state)
    ty, tstate = ssd_ref(*map(torch.from_numpy, (x, dt, A, Bm, Cm, D)))
    _close(ty.numpy(), want_y)
    _close(tstate.numpy(), want_state)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("b,l,h,p,n,chunk", SHAPES[:2])
def test_chunked_matches_the_model_chunked(b, l, h, p, n, chunk,
                                           with_state):
    x, dt, A, Bm, Cm, _ = _inputs(11, b, l, h, p, n)
    s0 = (np.random.default_rng(12).standard_normal((b, h, p, n)).astype(
        np.float32) if with_state else None)
    want_y, want_state = jssd_chunked(
        *map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk,
        None if s0 is None else jnp.asarray(s0))
    y, state = ssd_chunked(*map(torch.from_numpy, (x, dt, A, Bm, Cm)), chunk,
                           None if s0 is None else torch.from_numpy(s0))
    _close(y.numpy(), want_y)
    _close(state.numpy(), want_state)


def test_initial_state_and_d_against_the_recurrence():
    """The reference's oracle starts from zero: scanning the second half
    from the first half's final state must give the whole sequence's
    tail and final state; D adds D·x."""
    x, dt, A, Bm, Cm, D = _inputs(13, 2, 128, 4, 32, 16)
    want_y, want_state = jssd_ref.ssd_ref(*map(jnp.asarray,
                                               (x, dt, A, Bm, Cm, D)))
    t = [torch.from_numpy(a) for a in (x, dt, A, Bm, Cm)]
    head = [a[:, :64] if a.dim() > 1 else a for a in t]
    tail = [a[:, 64:] if a.dim() > 1 else a for a in t]
    Dt = torch.from_numpy(D)
    _, mid = ssd_ops.ssd_scan(*head, Dt, chunk=32)
    y2, state = ssd_ops.ssd_scan(*tail, Dt, chunk=32, init_state=mid)
    _close(y2.numpy(), np.asarray(want_y)[:, 64:])
    _close(state.numpy(), want_state)
    _, mid_rec = ssd_ref(*head, Dt)
    y_rec, state_rec = ssd_ref(*tail, Dt, init_state=mid_rec)
    _close(y_rec.numpy(), np.asarray(want_y)[:, 64:])
    _close(state_rec.numpy(), want_state)


def test_decay_extremes_stay_finite():
    """dt 3, A -5: the exps above the diagonal would overflow; the plain
    versions never take them."""
    x, dt, A, Bm, Cm, _ = _inputs(12, 1, 64, 2, 16, 8,
                                  decay=(3.0, [-5.0, -0.001]))
    want_y, want_state = jssd_ref.ssd_ref(*map(jnp.asarray,
                                               (x, dt, A, Bm, Cm)))
    want_k = jssd_ops.ssd_scan(*map(jnp.asarray, (x, dt, A, Bm, Cm)),
                               chunk=32, interpret=True)
    y, state = ssd_ops.ssd_scan(*map(torch.from_numpy, (x, dt, A, Bm, Cm)),
                                chunk=32)
    assert torch.isfinite(y).all() and torch.isfinite(state).all()
    _close(y.numpy(), want_y, 5e-5)
    _close(y.numpy(), want_k, 5e-5)
    _close(state.numpy(), want_state, 5e-5)


def test_segsum_is_the_reference_segsum():
    from repro.models.ssm import _segsum as jsegsum
    a = np.random.default_rng(3).standard_normal((2, 3, 9)).astype(
        np.float32)
    want = np.asarray(jsegsum(jnp.asarray(a)))
    got = segsum(torch.from_numpy(a)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], atol=1e-6)


@pytest.mark.parametrize("l,chunk,ok", [(244, 256, 244), (512, 256, 256),
                                        (32, 32, 32), (1, 256, 1),
                                        (300, 256, None), (40, 32, None),
                                        (0, 32, None)])
def test_chunk_rule(l, chunk, ok):
    """A sequence is at most one chunk or a whole number of chunks (the
    reference's ``min(chunk, l)`` and ``l % chunk == 0``); the rest is
    refused with a ValueError on the CPU path too, never padded."""
    if ok is not None:
        assert chunk_of(l, chunk) == ok
        return
    with pytest.raises(ValueError, match="SSD scan"):
        chunk_of(l, chunk)
    if l:
        x, dt, A, Bm, Cm, D = _inputs(0, 1, l, 2, 16, 8)
        with pytest.raises(ValueError, match="multiple of it"):
            ssd_ops.ssd_scan(*map(torch.from_numpy, (x, dt, A, Bm, Cm, D)),
                             chunk=chunk)


def test_wrapper_refuses_bad_shapes_and_devices():
    x, dt, A, Bm, Cm, D = map(torch.from_numpy,
                              _inputs(0, 1, 32, 2, 16, 8))
    with pytest.raises(ValueError, match="shape"):
        ssd_ops.ssd_scan(x, dt[..., :1], A, Bm, Cm, D, chunk=32)
    with pytest.raises(ValueError, match="shape"):
        ssd_ops.ssd_scan(x, dt, A, Bm, Cm[:, :, :4], D, chunk=32)
    with pytest.raises(ValueError, match="shape"):
        ssd_ops.ssd_scan(x, dt, A, Bm, Cm, D, chunk=32,
                         init_state=torch.zeros(1, 2, 16, 4))
    with pytest.raises(ValueError, match="expected x"):
        ssd_ops.ssd_scan(x[0], dt, A, Bm, Cm, D, chunk=32)
    # a meta tensor launches nothing: the outputs' shapes and dtypes (the
    # dry run's branch), after the same checks
    meta = [t.to("meta") for t in (x, dt, A, Bm, Cm, D)]
    y, final = ssd_ops.ssd_scan(*meta, chunk=32)
    assert y.is_meta and (y.shape, y.dtype) == (x.shape, torch.float32)
    assert final.shape == (1, 2, 16, 8)
    with pytest.raises(ValueError, match="shape"):
        ssd_ops.ssd_scan(meta[0], meta[1][..., :1], *meta[2:], chunk=32)


def test_bf16_inputs_accumulate_in_f32():
    """Under ``bf16`` the mixer passes bf16 x, B, C and f32 dt: the plain
    version widens them exactly and returns f32 y and state, the same as
    on the widened inputs."""
    x, dt, A, Bm, Cm, D = map(torch.from_numpy,
                              _inputs(5, 2, 64, 2, 32, 16))
    xb, Bb, Cb = (t.bfloat16() for t in (x, Bm, Cm))
    y, state = ssd_ops.ssd_scan(xb, dt, A, Bb, Cb, D, chunk=32)
    y32, state32 = ssd_ops.ssd_scan(xb.float(), dt, A, Bb.float(),
                                    Cb.float(), D, chunk=32)
    assert y.dtype == state.dtype == torch.float32
    assert torch.equal(y, y32) and torch.equal(state, state32)
