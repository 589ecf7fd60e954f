"""The hybrid serving path's kernels on the card at Jamba-1.5-Large's
shapes, and a small hybrid model's prefill and decode on the kernel path
against the plain path. Every test here needs a CUDA card and the CUDA
toolkit; on a host without a card they skip (the card is looked for inside
a fixture, never at import). Run them on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_hybrid.py

- ``flash_fwd`` at head dim 128, 64 query heads over 8 kv heads (a group
  of 8), causal, no window, over 256 and 512 tokens.
- ``decode_attention`` at 8 slots, the same heads, over a linear cache of
  1024, ragged lengths including 0 and the serving state (~300 valid).
- ``ssd_scan`` at 256 heads of 64, state 128: b 1 × l 244 and 256, b 8 × l
  512 (two chunks), with and without an initial state, x, B and C as the
  mixer's split views of one (b, l, 16640) buffer (no copy).
- A two-period hybrid model at smoke width (attention every 2 layers, MoE
  every 2, 4 experts, an expert share of 2) in f32: prefill and 6 decode
  steps on the kernel path (flash, scan and decode kernels) against the
  plain path (chunked attention, the scan's plain version, einsum
  decode).

Tolerances, each with its reason:
- flash f32 5e-5 abs on out and lse (the kernel's products split 3×TF32:
  ~2^-21 of each; fp32 sums in another order); bf16 out 1.6e-2 (one bf16
  ulp at |out| < 2 where both sides round the same fp32 value).
- decode f32 2e-5 abs (the reference's); bf16 per element 2 bf16 ulps of
  |ref| plus 1e-3 of max |ref| (tests/test_torch_cuda_decode.py).
- ssd_scan 2e-5 of max |y| and of max |state| (the reference's own
  kernel-vs-ssd_chunked tolerance; fp32 sums in 64-token sub-chunks).
- The model: logits 1e-3 abs (unit-scale logits through 4 layers that
  differ only in summation order, ~1e-6; a wrong mask, position, state or
  chunk moves them by ~1e-1), caches 1e-3 of each leaf's max.
"""
import contextlib
import dataclasses
from unittest import mock

import pytest
import torch
import torch.nn.functional as F

pytestmark = pytest.mark.cuda

BF16_ULP = 2.0 ** -7
H, KV, D = 64, 8, 128
SSD_H, SSD_P, SSD_N = 256, 64, 128


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.device import resolve_device
    resolve_device("cuda")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [256, 512])
def test_flash_fwd_at_jamba_shape(gen, s, dtype):
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_fwd_ref
    q = torch.randn((H, s, D), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((KV, s, D), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    out, lse = fa_ops.flash_fwd(q, k, v, causal=True)
    ref_out, ref_lse = flash_fwd_ref(q, k, v, causal=True)
    tol = 5e-5 if dtype == torch.float32 else 1.6e-2
    assert float((out.float() - ref_out.float()).abs().max()) <= tol
    assert float((lse - ref_lse).abs().max()) <= 5e-5


def _decode_close(got, ref):
    if ref.dtype == torch.bfloat16:
        r = ref.float().abs()
        limit = 2 * BF16_ULP * r + 1e-3 * r.max()
    else:
        limit = torch.full_like(ref, 2e-5)
    err = (got.float() - ref.float()).abs()
    assert bool((err <= limit).all()), float(err.max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_at_jamba_shape(gen, dtype):
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    b, t = 8, 1024
    q = torch.randn((b, H, D), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((b, KV, t, D), generator=gen, device="cuda")
            .to(dtype) for _ in range(2))
    assert dec_ops.launch_plan(q, k).group == 8
    ar = torch.arange(t, device="cuda")
    for lens in ([0, 1, 255, 256, 257, t, 301, t - 5],
                 [296 + 7 * i for i in range(b)]):
        valid = ar[None, :] < torch.tensor(lens, device="cuda")[:, None]
        got = dec_ops.decode_attention(q, k, v, valid)
        _decode_close(got, decode_attention_ref(q, k, v, valid))
        if lens[0] == 0:
            assert bool((got[0] == 0).all())


def _ssd_inputs(gen, b, l, dtype, init):
    buf = torch.randn((b, l, SSD_H * SSD_P + 2 * SSD_N), generator=gen,
                      device="cuda").to(dtype)
    x = buf[..., :SSD_H * SSD_P].reshape(b, l, SSD_H, SSD_P)
    Bm = buf[..., SSD_H * SSD_P:SSD_H * SSD_P + SSD_N]
    Cm = buf[..., SSD_H * SSD_P + SSD_N:]
    dt = F.softplus(torch.randn((b, l, SSD_H), generator=gen,
                                device="cuda"))
    A = -torch.exp(0.3 * torch.randn((SSD_H,), generator=gen,
                                     device="cuda"))
    D_ = torch.rand((SSD_H,), generator=gen, device="cuda")
    s0 = (torch.randn((b, SSD_H, SSD_P, SSD_N), generator=gen,
                      device="cuda") if init else None)
    return x, dt, A, Bm, Cm, D_, s0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,l,init", [(1, 244, True), (1, 256, False),
                                      (8, 512, False), (8, 512, True)])
def test_ssd_scan_at_jamba_shape(gen, b, l, init, dtype):
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.kernels.ssd_scan.ref import chunk_of, ssd_chunked
    x, dt, A, Bm, Cm, D_, s0 = _ssd_inputs(gen, b, l, dtype, init)
    for view in (x, Bm, Cm):
        assert ssd_ops._aligned(view) is view
    y, f = ssd_ops.ssd_scan(x, dt, A, Bm, Cm, D_, chunk=256, init_state=s0)
    # the plain version in chunks of at most 64 (a chunk of 512 carries
    # more fp32 error than the kernel's 64-token sub-chunks)
    yr, fr = ssd_chunked(x, dt, A, Bm, Cm, chunk_of(l, 64 if l > 256
                                                    else 256), s0, D_)
    assert bool(torch.isfinite(y).all() and torch.isfinite(f).all())
    assert float((y - yr).abs().max()) <= 2e-5 * float(yr.abs().max())
    assert float((f - fr).abs().max()) <= 2e-5 * float(fr.abs().max())


def _plain_scan(x, dt, A, Bm, Cm, D=None, *, chunk, init_state=None):
    from repro_torch.kernels.ssd_scan.ref import chunk_of, ssd_chunked
    return ssd_chunked(x, dt, A, Bm, Cm, chunk_of(x.shape[1], chunk),
                       init_state, D)


def test_hybrid_kernel_path_matches_plain_path(gen):
    from repro_torch import interop
    from repro_torch.configs import get_arch, smoke_variant
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import ssm as ssm_lib
    from repro_torch.models import transformer as tf
    cfg = dataclasses.replace(smoke_variant(get_arch("jamba-1.5-large-398b")),
                              n_layers=4)
    share = (1, 2)
    params = interop.init_params(cfg, gen, "cuda", experts=share)
    margs = {"dispatch": "dense", "experts": share}
    toks = torch.randint(4, cfg.vocab, (3, 70), generator=gen,
                         device="cuda")
    plen, out = 64, {}
    counters = (fa_ops.COUNTER, dec_ops.COUNTER, ssd_ops.COUNTER)
    with torch.no_grad():
        for name, impl in (("kernel", "pallas"), ("plain", "chunked")):
            pcfg = dataclasses.replace(cfg, attn_impl=impl)
            patch = (mock.patch.object(ssm_lib, "ssd_scan", _plain_scan)
                     if name == "plain" else contextlib.nullcontext())
            before = [c.count for c in counters]
            with patch:
                logits, caches = tf.prefill(
                    pcfg, params, {"tokens": toks[:, :plen]},
                    precision="f32", moe_args=margs, collect_cache_len=128)
                steps = [logits]
                for i in range(6):
                    logits, caches = tf.decode_step(
                        pcfg, params, toks[:, plen + i:plen + i + 1],
                        plen + i, caches, precision="f32", moe_args=margs)
                    steps.append(logits)
            out[name] = (steps, caches,
                         [c.count - n for c, n in zip(counters, before)])
    assert out["kernel"][2] == [2, 2 * 6, 2]   # flash, decode, ssd launches
    assert out["plain"][2] == [0, 0, 0]
    for a, b in zip(out["kernel"][0], out["plain"][0]):
        assert float((a - b).abs().max()) <= 1e-3
    for ck, cp in zip(out["kernel"][1], out["plain"][1]):
        assert type(ck) is type(cp)
        for a, b in zip(ck, cp):
            assert float((a - b).abs().max()) <= 1e-3 * float(b.abs().max())
