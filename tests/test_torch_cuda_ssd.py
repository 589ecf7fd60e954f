"""The SSM path's CUDA kernel on the card: the SSD chunked-scan kernel
against its plain PyTorch version (``ssd_chunked``) and the sequential
recurrence (``ssd_ref``), and the Mamba-2 model's prefill through the
kernel against the plain path. Every test here needs a CUDA card and the
CUDA toolkit; on a host without a card they skip (the card is looked for
inside a fixture, never at import). The backward kernel
(``csrc/ssd_bwd.cu``) is held against the plain backward
``ssd_chunked_bwd`` in float64, bit for bit on a rerun, and through the
differentiable ``ssd_scan``; the smoke Mamba-2 trains through
``--mode lm`` on the card, and a smoke Mixtral step runs the flash
backward against the plain path. Run them on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_ssd.py

Tolerance: 2e-5 of the tensor's max |value|, for y and the final state,
f32 and bf16 inputs alike: the reference's own kernel-vs-``ssd_chunked``
tolerance (tests/test_kernels.py). Both sides read the same values and
accumulate in fp32; the kernel sums in another order and in sub-chunks of
64 tokens, its f32 products split 3×TF32 (about 2^-21 of each product).
Two launches on the same inputs give the same bits. The edges are those of
the launch plan (``ops.ssd_plan``): one token, a sub-chunk and one token
either side of it, a cluster of one to eight CTAs along the sequence, one,
two and more sub-chunks per CTA, one or two staging buffers, each head_dim
block.
"""
import dataclasses
import functools
from unittest import mock

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import (chunk_of, ssd_chunked,
                                              ssd_chunked_bwd, ssd_ref)

pytestmark = pytest.mark.cuda

TOL_REL = 2e-5


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.device import resolve_device
    resolve_device("cuda")
    return torch.Generator(device="cuda").manual_seed(0)


def _inputs(gen, b, l, h, p, n, dtype, init=False, split=True):
    """x, B, C as the mixer's split views of one buffer (or contiguous),
    dt softplus'd, A negative, D random, optional initial state."""
    if split:
        buf = torch.randn((b, l, h * p + 2 * n), generator=gen,
                          device="cuda").to(dtype)
        x = buf[..., :h * p].reshape(b, l, h, p)
        Bm, Cm = buf[..., h * p:h * p + n], buf[..., h * p + n:]
    else:
        x = torch.randn((b, l, h, p), generator=gen, device="cuda").to(dtype)
        Bm, Cm = (torch.randn((b, l, n), generator=gen, device="cuda")
                  .to(dtype) for _ in range(2))
    dt = F.softplus(torch.randn((b, l, h), generator=gen, device="cuda"))
    A = -torch.exp(0.3 * torch.randn((h,), generator=gen, device="cuda"))
    D = torch.rand((h,), generator=gen, device="cuda")
    s0 = (torch.randn((b, h, p, n), generator=gen, device="cuda") if init
          else None)
    return x, dt, A, Bm, Cm, D, s0


def _ref_chunk(l):
    """The plain version's chunk for a sequence of l tokens: 256 where the
    chunk rule takes it, else the largest divisor of l up to 64 (l 513:
    57). One chunk of 513 tokens would make the plain version's own fp32
    running sums of dt·A the larger error; the kernel's result does not
    depend on the chunk but by rounding."""
    if l <= 256 or l % 256 == 0:
        return chunk_of(l, 256)
    return max(c for c in range(1, 65) if l % c == 0)


def _assert_close(got, ref):
    err = (got - ref).abs().max().item()
    assert bool(torch.isfinite(got).all())
    assert err <= TOL_REL * ref.abs().max().item(), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,l,h,p,n,chunk,init", [
    (1, 256, 24, 64, 128, 256, False),    # one chunk, Mamba-2-130M widths
    (1, 244, 24, 64, 128, 256, True),     # ragged: a chunk of 244
    (1, 1024, 24, 64, 128, 256, False),   # four chunks
    (8, 256, 24, 64, 128, 256, True),     # the timed serving batch
    (2, 96, 3, 32, 16, 32, True),         # smoke widths, 3 chunks
    (1, 13, 2, 16, 8, 32, False),         # a 13-token chunk, least widths
    (1, 65, 2, 16, 8, 65, True),          # one token past a sub-chunk
    (2, 200, 4, 48, 256, 100, True),      # the largest state, p 48
])
def test_ssd_kernel_matches_plain(gen, b, l, h, p, n, chunk, init, dtype):
    x, dt, A, Bm, Cm, D, s0 = _inputs(gen, b, l, h, p, n, dtype, init)
    y, f = ssd_ops.ssd_scan(x, dt, A, Bm, Cm, D, chunk=chunk, init_state=s0)
    yr, fr = ssd_chunked(x, dt, A, Bm, Cm, chunk_of(l, chunk), s0, D)
    assert y.shape == (b, l, h, p) and f.shape == (b, h, p, n)
    assert y.dtype == f.dtype == torch.float32
    _assert_close(y, yr)
    _assert_close(f, fr)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,l,init,use_d,split", [
    (1, 1, False, True, True),            # one token
    (1, 63, True, True, True),            # one sub-chunk, one row short
    (1, 64, False, False, True),          # exactly one sub-chunk
    (1, 65, True, True, False),           # one token into a second one
    (1, 244, True, True, True),           # the serving prefill, ragged
    (1, 256, False, True, False),
    (1, 513, True, True, True),           # 9 sub-chunks: 5 CTAs of 2
    (1, 1024, False, True, True),         # 8 CTAs of 2 sub-chunks
    (1, 1024, True, False, False),
    (8, 256, True, True, True),           # the timed serving batch
])
def test_ssd_kernel_at_the_plans_edges(gen, b, l, init, use_d, split,
                                       dtype):
    x, dt, A, Bm, Cm, D, s0 = _inputs(gen, b, l, 24, 64, 128, dtype, init,
                                      split)
    D = D if use_d else None
    chunk = l if l > 256 and l % 256 else 256   # the chunk rule takes it
    y, f = ssd_ops.ssd_scan(x, dt, A, Bm, Cm, D, chunk=chunk, init_state=s0)
    yr, fr = ssd_chunked(x, dt, A, Bm, Cm, _ref_chunk(l), s0, D)
    _assert_close(y, yr)
    _assert_close(f, fr)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("l,force", [
    (513, dict(max_cluster=2)),            # 5 sub-chunks a CTA, restaged
    (513, dict(max_cluster=3, stages=1)),  # one buffer, restaged
    (1024, dict(max_cluster=1)),           # one CTA walks 16 sub-chunks
    (256, dict(p_block=64)),
    (256, dict(p_block=16)),
    (200, dict(max_cluster=2, p_block=16, stages=1)),
])
def test_ssd_kernel_under_each_plan(gen, l, force, dtype):
    """Plans the shape rule does not pick at Mamba-2-130M's widths: more
    sub-chunks per CTA than two staging buffers hold, one buffer, one CTA,
    each head_dim block; the result is the same function."""
    x, dt, A, Bm, Cm, D, s0 = _inputs(gen, 2, l, 24, 64, 128, dtype, True)
    plan = functools.partial(ssd_ops.ssd_plan, **force)
    chunk = l if l > 256 and l % 256 else 256
    with mock.patch.object(ssd_ops, "ssd_plan", plan):
        y, f = ssd_ops.ssd_scan(x, dt, A, Bm, Cm, D, chunk=chunk,
                                init_state=s0)
    yr, fr = ssd_chunked(x, dt, A, Bm, Cm, _ref_chunk(l), s0, D)
    _assert_close(y, yr)
    _assert_close(f, fr)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_copies_a_view_off_16_byte_units(gen, dtype):
    """x, B and C one element into their buffer: not 16-byte aligned, so
    the wrapper copies them to contiguous tensors, as its docstring says;
    the result is the scan of the same values."""
    b, l, h, p, n = 1, 130, 4, 32, 16
    buf = torch.randn((b, l, h * p + 2 * n + 1), generator=gen,
                      device="cuda").to(dtype)
    x = buf[..., 1:1 + h * p].reshape(b, l, h, p)
    Bm, Cm = buf[..., 1 + h * p:1 + h * p + n], buf[..., 1 + h * p + n:]
    assert x.data_ptr() % 16 != 0
    _, dt, A, _, _, D, s0 = _inputs(gen, b, l, h, p, n, dtype, True)
    y, f = ssd_ops.ssd_scan(x, dt, A, Bm, Cm, D, chunk=256, init_state=s0)
    yr, fr = ssd_chunked(x.contiguous(), dt, A, Bm.contiguous(),
                         Cm.contiguous(), chunk_of(l, 256), s0, D)
    _assert_close(y, yr)
    _assert_close(f, fr)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_matches_the_recurrence(gen, dtype):
    x, dt, A, Bm, Cm, D, s0 = _inputs(gen, 2, 128, 4, 32, 16, dtype,
                                      init=True, split=False)
    dt = dt * 0.5
    y, f = ssd_ops.ssd_scan(x, dt, A, Bm, Cm, D, chunk=32, init_state=s0)
    yr, fr = ssd_ref(x, dt, A, Bm, Cm, D, init_state=s0)
    _assert_close(y, yr)
    _assert_close(f, fr)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_decay_extremes_stay_finite(gen, dtype):
    """dt 3 and A -5: exp(cum_i - cum_j) above the diagonal would be
    inf; the kernel never evaluates it, so no NaN."""
    x, _, _, Bm, Cm, D, _ = _inputs(gen, 1, 256, 24, 64, 128, dtype)
    dt = torch.full((1, 256, 24), 3.0, device="cuda")
    A = torch.tensor([-5.0, -0.001] * 12, device="cuda")
    y, f = ssd_ops.ssd_scan(x, dt, A, Bm, Cm, D, chunk=256)
    yr, fr = ssd_ref(x, dt, A, Bm, Cm, D)
    _assert_close(y, yr)
    _assert_close(f, fr)


@pytest.mark.parametrize("l,dtype", [(512, torch.bfloat16),
                                     (1024, torch.float32),
                                     (244, torch.float32)])
def test_ssd_kernel_is_bit_identical_across_launches(gen, l, dtype):
    args = _inputs(gen, 2, l, 24, 64, 128, dtype, init=True)
    runs = [ssd_ops.ssd_scan(*args[:6], chunk=256, init_state=args[6])
            for _ in range(3)]
    for y, f in runs[1:]:
        assert torch.equal(y, runs[0][0]) and torch.equal(f, runs[0][1])


def test_ssd_kernel_without_d_or_state_and_counts_launches(gen):
    x, dt, A, Bm, Cm, _, _ = _inputs(gen, 1, 64, 2, 16, 8, torch.float32)
    before = ssd_ops.COUNTER.count
    y, f = ssd_ops.ssd_scan(x, dt, A, Bm, Cm, chunk=64)
    assert ssd_ops.COUNTER.count == before + 1
    yr, fr = ssd_chunked(x, dt, A, Bm, Cm, 64)
    _assert_close(y, yr)
    _assert_close(f, fr)


# the backward kernel against the plain backward evaluated in float64 (so
# the error is the kernel's own): 2e-5 of each gradient's max |value|
# (TOL_REL) for dx, ddt, dB, dC and d(init); dA and dD are sums over b·l
# (and p) of terms that cancel, where fp32 sums in any order carry ~1e-5
# of the largest term, so 1e-4 of their max. bf16 dx, dB, dC are the fp32
# result rounded: 2^-8 of |ref| more per element (one ulp at a boundary)
GRAD_SUM_TOL_REL = 1e-4
BF16_ULP = 2.0 ** -8
GRAD_NAMES = ("dx", "ddt", "dA", "dB", "dC", "dD", "dinit")


def _bwd_case(gen, b, l, h, p, n, dtype, init, dfinal, split=True):
    x, dt, A, Bm, Cm, D, s0 = _inputs(gen, b, l, h, p, n, dtype, init,
                                      split)
    dy = torch.randn((b, l, h, p), generator=gen, device="cuda")
    df = (torch.randn((b, h, p, n), generator=gen, device="cuda") if dfinal
          else None)
    return (x, dt, A, Bm, Cm, D, s0), dy, df


def _kernel_grads(args, dy, df):
    """The forward kernel with its saved states, then the backward kernel:
    the seven gradients."""
    y, final, states = ssd_ops._launch(*args, save_states=True)
    return ssd_ops.ssd_scan_bwd(*args, states, final, dy, df)


def _assert_grads_close(got, args, dy, df, chunk):
    x, dt, A, Bm, Cm, D, s0 = args
    ref = ssd_chunked_bwd(
        *(None if t is None else t.double() for t in args), dy.double(),
        None if df is None else df.double(), chunk)
    for name, g, r in zip(GRAD_NAMES, got, ref):
        if r is None:
            assert g is None, name
            continue
        assert bool(torch.isfinite(g.float()).all()), name
        scale = r.abs().max().item()
        lim = (GRAD_SUM_TOL_REL if name in ("dA", "dD") else TOL_REL) * scale
        err = (g.double() - r).abs()
        if g.dtype == torch.bfloat16:
            err = err - BF16_ULP * r.abs()
        assert err.max().item() <= lim, (name, err.max().item(), lim)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,l,h,p,n,init,dfinal", [
    (1, 256, 24, 64, 128, False, False),   # one chunk, Mamba-2-130M
    (1, 244, 24, 64, 128, True, True),     # ragged, state in and out
    (2, 1024, 24, 64, 128, False, False),  # 16 sub-chunks a sequence
    (1, 1, 2, 16, 8, True, True),          # one token
    (1, 65, 2, 16, 8, True, False),        # one token past a sub-chunk
    (2, 200, 4, 48, 256, True, True),      # the largest state: p_block 16
    (1, 128, 8, 32, 64, False, True),      # p_block 32
])
def test_ssd_backward_kernel_matches_plain(gen, b, l, h, p, n, init, dfinal,
                                           dtype):
    args, dy, df = _bwd_case(gen, b, l, h, p, n, dtype, init, dfinal)
    before = ssd_ops.BWD_COUNTER.count
    got = _kernel_grads(args, dy, df)
    assert ssd_ops.BWD_COUNTER.count == before + 1
    assert got[0].dtype == got[3].dtype == got[4].dtype == dtype
    _assert_grads_close(got, args, dy, df, _ref_chunk(l))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_backward_kernel_is_bit_identical_across_runs(gen, dtype):
    args, dy, df = _bwd_case(gen, 2, 1024, 24, 64, 128, dtype, True, True)
    one = _kernel_grads(args, dy, df)
    two = _kernel_grads(args, dy, df)
    for name, a, b in zip(GRAD_NAMES, one, two):
        assert torch.equal(a, b), name


def test_ssd_scan_under_grad_mode_runs_both_kernels(gen):
    """With an input that requires grad, ssd_scan is differentiable on the
    card: the forward kernel once (no plain version), the backward kernel
    once on backward, and the gradients autograd takes through the plain
    forward; the mixer's split views get theirs without a copy."""
    b, l, h, p, n = 2, 512, 4, 64, 128
    args, dy, df = _bwd_case(gen, b, l, h, p, n, torch.float32, True, True)
    leaves = [t.detach().requires_grad_() for t in args]
    counts = (ssd_ops.COUNTER.count, ssd_ops.BWD_COUNTER.count)
    y, final = ssd_ops.ssd_scan(*leaves[:6], chunk=256, init_state=leaves[6])
    assert type(y.grad_fn).__name__ == "_ScanBackward"
    ((y * dy).sum() + (final * df).sum()).backward()
    assert (ssd_ops.COUNTER.count, ssd_ops.BWD_COUNTER.count) == (
        counts[0] + 1, counts[1] + 1)
    got = [t.grad for t in leaves]
    _assert_grads_close(got, args, dy, df, 256)
    plain = [t.detach().requires_grad_() for t in args]
    yr, fr = ssd_chunked(*plain[:5], 64, plain[6], plain[5])
    ((yr * dy).sum() + (fr * df).sum()).backward()
    for name, g, t in zip(GRAD_NAMES, got, plain):
        scale = t.grad.abs().max().item()
        tol = GRAD_SUM_TOL_REL if name in ("dA", "dD") else 1e-4
        assert (g - t.grad).abs().max().item() <= tol * scale, name


def test_mamba_lm_command_line_trains_on_the_card(gen):
    """``--mode lm --arch mamba2-130m --smoke`` on the card: every layer
    launches the scan forward and backward once a step, and the losses are
    those of the plain path (the scan's plain version, autograd) to fp32
    summation order."""
    from repro_torch.launch import train
    from repro_torch.models import ssm as ssm_lib
    argv = ["--mode", "lm", "--arch", "mamba2-130m", "--smoke", "--steps",
            "3", "--batch", "2", "--seq", "64"]
    counts = (ssd_ops.COUNTER.count, ssd_ops.BWD_COUNTER.count)
    rep = train.main(argv)
    layers = 2
    assert (ssd_ops.COUNTER.count - counts[0],
            ssd_ops.BWD_COUNTER.count - counts[1]) == (3 * layers,
                                                       3 * layers)

    def plain(x, dt, A, Bm, Cm, D=None, *, chunk, init_state=None):
        return ssd_chunked(x, dt, A, Bm, Cm, chunk_of(x.shape[1], chunk),
                           init_state, D)
    with mock.patch.object(ssm_lib, "ssd_scan", plain):
        ref = train.main(argv)
    assert np.all(np.isfinite(rep["losses"]))
    np.testing.assert_allclose(rep["losses"], ref["losses"], rtol=1e-5)


def test_mixtral_smoke_training_step_matches_plain_path(gen):
    """One f32 ``lm_step`` of the smoke Mixtral on the card, the flash
    kernels against chunked attention from the same weights and batch:
    loss and every gradient leaf within 1e-4 of its max."""
    from repro_torch import interop
    from repro_torch.configs import get_arch, smoke_variant
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import frontends
    from repro_torch.models import transformer as tf
    cfg = smoke_variant(get_arch("mixtral-8x22b"))
    params = interop.init_params(cfg, gen, "cuda")
    batch = frontends.synthetic_inputs(cfg, 2, 64, np.random.default_rng(0),
                                       device="cuda")
    out = {}
    for attn in ("pallas", "chunked"):
        pcfg = dataclasses.replace(cfg, attn_impl=attn)
        before = fa_ops.BWD_COUNTER.count
        loss, _, grads = value_and_grad(
            lambda p: tf.lm_loss(pcfg, p, batch, precision="f32",
                                 moe_args={"dispatch": "dense"}), params)
        out[attn] = (loss.item(), dict(interop.leaves(grads)),
                     fa_ops.BWD_COUNTER.count - before)
    (lk, gk, nk), (lp, gp, npl) = out["pallas"], out["chunked"]
    assert nk == cfg.n_layers and npl == 0
    assert abs(lk - lp) <= 1e-4 * abs(lp)
    for path, g in gp.items():
        assert (gk[path] - g).abs().max().item() <= 1e-4 * max(
            g.abs().max().item(), 1e-30), path


def test_ssd_kernel_refuses_what_it_does_not_take(gen):
    x, dt, A, Bm, Cm, D, _ = _inputs(gen, 1, 64, 2, 32, 16, torch.float32)
    with pytest.raises(ValueError, match="multiple of it"):
        ssd_ops.ssd_scan(x[:, :40], dt[:, :40], A, Bm[:, :40], Cm[:, :40],
                         D, chunk=32)
    with pytest.raises(TypeError, match="one dtype"):
        ssd_ops.ssd_scan(x.half(), dt, A, Bm.half(), Cm.half(), D, chunk=64)
    with pytest.raises(TypeError, match="one dtype"):
        ssd_ops.ssd_scan(x, dt, A, Bm.bfloat16(), Cm, D, chunk=64)
    with pytest.raises(TypeError, match="float32"):
        ssd_ops.ssd_scan(x, dt.bfloat16(), A, Bm, Cm, D, chunk=64)
    with pytest.raises(ValueError, match="multiple of 16"):
        ssd_ops.ssd_scan(x[..., :24], dt, A, Bm, Cm, D, chunk=64)
    with pytest.raises(ValueError, match="up to 256"):
        big = torch.zeros((1, 64, 260), device="cuda")
        ssd_ops.ssd_scan(x, dt, A, big, big, D, chunk=64)
    with pytest.raises(ValueError, match="multiple of 8"):
        odd = torch.zeros((1, 64, 12), device="cuda")
        ssd_ops.ssd_scan(x, dt, A, odd, odd, D, chunk=64)
    with pytest.raises(ValueError, match="contiguous last"):
        ssd_ops.ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3), dt,
                         A, Bm, Cm, D, chunk=64)
    with pytest.raises(ValueError, match="shape"):
        ssd_ops.ssd_scan(x, dt[:, :, :1], A, Bm, Cm, D, chunk=64)
    with pytest.raises(ValueError, match="one device"):
        ssd_ops.ssd_scan(x, dt.cpu(), A, Bm, Cm, D, chunk=64)


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_mamba_prefill_kernel_path_matches_plain_path(gen, precision):
    """The smoke Mamba-2 at chunk 256 (so 300 tokens is refused and 512
    is two chunks): logits and caches of the kernel path against the
    mixer with the scan's plain version swapped in."""
    from repro_torch import interop
    from repro_torch.configs import get_arch, smoke_variant
    from repro_torch.models import ssm as ssm_lib
    from repro_torch.models import transformer as tf
    cfg = smoke_variant(get_arch("mamba2-130m"))
    cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm,
                                                           chunk=256))
    params = interop.init_params(cfg, gen, "cuda")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        4, cfg.vocab, (2, 512))).cuda()

    def plain(x, dt, A, Bm, Cm, D=None, *, chunk, init_state=None):
        return ssd_chunked(x, dt, A, Bm, Cm, chunk_of(x.shape[1], chunk),
                           init_state, D)

    before = ssd_ops.COUNTER.count
    kl, kc = tf.prefill(cfg, params, {"tokens": toks}, precision=precision,
                        collect_cache_len=1024)
    assert ssd_ops.COUNTER.count == before + cfg.n_layers
    with mock.patch.object(ssm_lib, "ssd_scan", plain):
        pl, pc = tf.prefill(cfg, params, {"tokens": toks},
                            precision=precision, collect_cache_len=1024)
    assert ssd_ops.COUNTER.count == before + cfg.n_layers
    # f32: fp32 sums in another order through 2 layers; bf16: the two
    # paths' fp32 y round to bf16 apart at boundary crossings (2^-8
    # relative), and 2 layers carry that into the logits
    tol = 1e-4 if precision == "f32" else 5e-2
    assert (kl - pl).abs().max().item() <= tol * pl.abs().max().item()
    for leaf in ("ssm", "conv"):
        a, b = getattr(kc[0], leaf).float(), getattr(pc[0], leaf).float()
        assert (a - b).abs().max().item() <= tol * b.abs().max().item()
    with pytest.raises(ValueError, match="multiple of it"):
        tf.prefill(cfg, params, {"tokens": toks[:, :300]},
                   precision=precision)


def test_ssd_kernel_is_one_device_kernel_per_call(gen):
    from torch.profiler import ProfilerActivity, profile, schedule
    args = _inputs(gen, 1, 1024, 24, 64, 128, torch.bfloat16, init=True)
    ssd_ops.ssd_scan(*args[:6], chunk=256, init_state=args[6])
    torch.cuda.synchronize()
    # tracing starts one step early, on a small op: the tracer's start-up
    # can miss the first records of a window
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True,
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        prof.step()
        for _ in range(3):
            ssd_ops.ssd_scan(*args[:6], chunk=256, init_state=args[6])
        torch.cuda.synchronize()
        prof.step()
    names = [e.name for e in prof.events()
             if str(getattr(e, "device_type", "")).endswith("CUDA")
             and not e.name.startswith("ProfilerStep")]
    assert len(names) == 3 and all("ssd_scan_kernel" in n for n in names), \
        names
