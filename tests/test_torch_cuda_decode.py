"""The decode path's CUDA kernel on the card: the split-K decode-attention
kernel against its plain PyTorch version, and the continuous engine
against the lockstep engine on the kernel path. Every test here needs a
CUDA card and the CUDA toolkit; on a host without a card they skip (the
card is looked for inside a fixture, never at import). Run them on the card
with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_decode.py

Tolerances, each with its reason:
- f32: 2e-5 abs, the reference's (tests/test_decode_kernel.py); fp32 sums
  over the keys in another order.
- bf16, per element: 2 bf16 ulps of |ref| (2^-7 relative each) plus 1e-3
  of the tensor's max |ref|. Both sides accumulate in fp32 and round the
  same value to bf16, so an element moves by at most the ulp of a
  rounding-boundary crossing; the 1e-3·max term covers elements near zero,
  where fp32 sums in another order cancel. The reference's 5e-2 abs is as
  large as the outputs (~0.05 rms over 1000 keys).
- A length-0 row is exactly zero; a (b, t) mask with equal rows, stale
  entries past each length, and the batch a row sits in change nothing,
  bit for bit. The kernel skips the 16-key units and the chunks that the
  mask kills; skipping them changes no bit.
- The log-sum-exp (``return_lse``): 2e-5 abs against the plain version's
  fp32 log-sum-exp of the same scores (fp32 sums of exponentials in
  another order; bf16 products are exact in fp32), -1e30 exactly on a row
  with no valid key, and the output with it the output without it, bit for
  bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

pytestmark = pytest.mark.cuda

BF16_ULP = 2.0 ** -7


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.device import resolve_device
    resolve_device("cuda")
    return torch.Generator(device="cuda").manual_seed(0)


def _qkv(gen, b, h, kv, t, d, dtype):
    q = torch.randn((b, h, d), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((b, kv, t, d), generator=gen, device="cuda")
            .to(dtype) for _ in range(2))
    return q, k, v


def _lengths_mask(b, t):
    """Per-slot lengths 0, 1, ragged middles and t."""
    lens = [0, 1, t // 2 - 3, t, t // 3, max(1, t - 5), 7, t // 5][:b]
    lens = torch.tensor(lens + [t // 3] * (b - len(lens)), device="cuda")
    return torch.arange(t, device="cuda")[None, :] < lens[:, None], lens


def _assert_close(got, ref):
    if ref.dtype == torch.bfloat16:
        r = ref.float().abs()
        limit = 2 * BF16_ULP * r + 1e-3 * r.max()
    else:
        limit = torch.full_like(ref, 2e-5)
    err = (got.float() - ref.float()).abs()
    assert bool((err <= limit).all()), float(err.max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kv,t,d", [
    (8, 32, 8, 8192, 64),     # the timed serving shape (Llama-3.2-1B)
    (1, 32, 8, 8192, 64),     # one lockstep request
    (2, 4, 2, 64, 64),        # smoke llama
    (3, 8, 2, 300, 64),       # ragged t
    (2, 16, 2, 1000, 128),    # head dim 128, group 8
    (1, 24, 8, 517, 64),      # group 3
    (2, 40, 2, 700, 64),      # group 20: two head groups per row
    (3, 4, 4, 1, 64),         # one key
])
def test_decode_kernel_matches_plain(gen, b, h, kv, t, d, dtype):
    q, k, v = _qkv(gen, b, h, kv, t, d, dtype)
    valid, lens = _lengths_mask(b, t)
    before = dec_ops.COUNTER.count
    got = dec_ops.decode_attention(q, k, v, valid)
    assert dec_ops.COUNTER.count == before + 1
    ref = decode_attention_ref(q, k, v, valid)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (b, h, d)
    _assert_close(got, ref)
    empty = lens == 0
    assert bool((got[empty] == 0).all())
    shared = torch.arange(t, device="cuda") < max(1, t * 3 // 4)
    _assert_close(dec_ops.decode_attention(q, k, v, shared),
                  decode_attention_ref(q, k, v, shared))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_bit_identities(gen, dtype):
    """Shared mask == equal per-row masks, stale entries move nothing, and
    a row's result does not depend on the batch it sits in."""
    b, h, kv, t, d = 8, 32, 8, 2000, 64
    q, k, v = _qkv(gen, b, h, kv, t, d, dtype)
    shared = torch.arange(t, device="cuda") < 1234
    a = dec_ops.decode_attention(q, k, v, shared)
    per_row = dec_ops.decode_attention(q, k, v,
                                       shared[None, :].expand(b, t))
    assert torch.equal(a, per_row)
    valid, _ = _lengths_mask(b, t)
    clean = dec_ops.decode_attention(q, k, v, valid)
    keep = valid[:, None, :, None]
    stale = torch.full((), 1e6, dtype=dtype, device="cuda")
    dirty = dec_ops.decode_attention(q, torch.where(keep, k, stale),
                                     torch.where(keep, v, stale), valid)
    assert torch.equal(clean, dirty)
    for i in (0, 3, 7):
        alone = dec_ops.decode_attention(q[i:i + 1].contiguous(),
                                         k[i:i + 1], v[i:i + 1],
                                         valid[i:i + 1])
        assert torch.equal(alone[0], clean[i])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kv,t,d", [
    (6, 32, 8, 2048, 64),     # group 4, as Llama-3.2-1B
    (6, 8, 8, 1000, 64),      # group 1
    (6, 16, 2, 1300, 128),    # d 128, group 8
])
def test_decode_kernel_skips_dead_chunks_and_units_exactly(gen, b, h, kv, t,
                                                           d, dtype):
    """Lengths that kill every key, all but one, whole 16-key units and
    whole 256-key chunks (0, 1, 255, 256, 257, t): the kernel matches its
    plain version and gives the same bits over a cache whose dead entries
    hold other values; a full cache matches too."""
    q, k, v = _qkv(gen, b, h, kv, t, d, dtype)
    lens = torch.tensor([0, 1, 255, 256, 257, t], device="cuda")
    valid = torch.arange(t, device="cuda")[None, :] < lens[:, None]
    got = dec_ops.decode_attention(q, k, v, valid)
    _assert_close(got, decode_attention_ref(q, k, v, valid))
    assert bool((got[0] == 0).all())
    keep = valid[:, None, :, None]
    other = torch.randn(k.shape, generator=gen, device="cuda").to(dtype)
    dirty = dec_ops.decode_attention(q, torch.where(keep, k, other),
                                     torch.where(keep, v, 3 * other), valid)
    assert torch.equal(got, dirty)
    full = torch.ones(t, dtype=torch.bool, device="cuda")
    _assert_close(dec_ops.decode_attention(q, k, v, full),
                  decode_attention_ref(q, k, v, full))


def test_decode_kernel_refuses_what_it_does_not_take(gen):
    q, k, v = _qkv(gen, 2, 4, 2, 64, 64, torch.float16)
    valid = torch.ones(64, dtype=torch.bool, device="cuda")
    with pytest.raises(TypeError):
        dec_ops.decode_attention(q, k, v, valid)
    q, k, v = _qkv(gen, 2, 4, 2, 64, 64, torch.float32)
    with pytest.raises(TypeError):
        dec_ops.decode_attention(q.bfloat16(), k, v, valid)
    with pytest.raises(ValueError, match="contiguous"):
        # t == d here, so the transposed cache has the right shape
        dec_ops.decode_attention(q, k.transpose(2, 3), v, valid)
    q, k, v = _qkv(gen, 2, 4, 2, 64, 32, torch.float32)
    with pytest.raises(ValueError, match="head dims"):
        dec_ops.decode_attention(q, k, v, valid)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kv,t,d", [
    (1, 32, 8, 4096, 64),     # Llama-3.2-1B's slice of its ring over 2
    (2, 64, 8, 8192, 128),    # Jamba's heads, a shorter slice
    (8, 16, 4, 1000, 64),     # ragged t, group 4
])
def test_decode_kernel_lse_matches_plain(gen, b, h, kv, t, d, dtype):
    q, k, v = _qkv(gen, b, h, kv, t, d, dtype)
    valid, _ = _lengths_mask(b, t)
    if b == 1:                    # a slice past the row's keys, then some
        valid = torch.zeros_like(valid)
    out, lse = dec_ops.decode_attention(q, k, v, valid, return_lse=True)
    ref, ref_lse = decode_attention_ref(q, k, v, valid, return_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(out, dec_ops.decode_attention(q, k, v, valid))
    _assert_close(out, ref)
    live = valid.any(-1)
    assert bool((lse[~live] == -1e30).all())
    if bool(live.any()):
        assert float((lse - ref_lse)[live].abs().max()) <= 2e-5
    if b == 1:
        valid[0, :t // 3] = True
        out, lse = dec_ops.decode_attention(q, k, v, valid, return_lse=True)
        ref, ref_lse = decode_attention_ref(q, k, v, valid, return_lse=True)
        _assert_close(out, ref)
        assert float((lse - ref_lse).abs().max()) <= 2e-5


def test_continuous_engine_matches_lockstep_on_the_kernel_path(gen):
    """A smoke llama on the card with attn='pallas' (flash prefill, decode
    kernel): every ContinuousEngine request equals Engine.generate run
    alone, token for token."""
    from repro_torch import interop
    from repro_torch.configs import get_arch, smoke_variant
    from repro_torch.serving import ContinuousEngine, Engine
    cfg = smoke_variant(get_arch("llama3.2-1b"))
    params = interop.init_params(cfg, torch.Generator().manual_seed(0),
                                 "cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(4, cfg.vocab, (n,)).astype(np.int32)
               for n in (8, 5, 11, 3, 7, 9)]
    budgets = [6, 4, 8, 5, 1, 6]
    eng = Engine(cfg, params, cache_len=64, attn="pallas")
    before = dec_ops.COUNTER.count
    ce = ContinuousEngine(cfg, params, cache_len=64, num_slots=2,
                          attn="pallas")
    got = ce.run([(p, m, i) for i, (p, m) in enumerate(zip(prompts,
                                                             budgets))])
    assert dec_ops.COUNTER.count > before
    for i, (p, m) in enumerate(zip(prompts, budgets)):
        row = eng.generate(p[None, :], m, temperature=0.0)[0]
        want = []
        for tok in row:
            want.append(int(tok))
            if tok == eng.eos_id:
                break
        np.testing.assert_array_equal(got[i], want)
