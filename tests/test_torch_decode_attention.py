"""Port parity: the decode-attention wrapper (its plain version on a CPU
tensor) against the reference's Pallas kernel in interpret mode and its
``decode_attention_ref``, from the same numpy inputs.

Tolerances: f32 2e-5 and bf16 5e-2, the reference's own
(tests/test_decode_kernel.py); the port's plain version and the
reference's oracle sum in fp32 in another order. A length-0 row is exactly
zero, and stale entries past each length move nothing, bit for bit.

The log-sum-exp the wrapper returns on request (``return_lse``), which a
rank holding a slice of a cache's sequence merges its partial through: the
plain version's against a float64 log-sum-exp of the masked scores (1e-5,
fp32 scores), -1e30 on a row with no valid key; and a cache cut into P =
2, 3 and 4 slices, each through the plain version and then
``models.attention.merge_partials``, equal to the whole call within 1e-6
(f32), with slices and a whole row without a valid key, under (t,) and
(b, t) masks.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.ops import decode_attention as jax_decode
from repro.kernels.decode_attention.ref import decode_attention_ref as jax_ref
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.decode_attention.ref import (NEG_INF,
                                                      decode_attention_ref)
from repro_torch.models.attention import merge_partials

torch.set_num_threads(1)

TOL = {"float32": 2e-5, "bfloat16": 5e-2}


def _inputs(b, h, kv, t, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, kv, t, d)).astype(np.float32)
    v = rng.standard_normal((b, kv, t, d)).astype(np.float32)
    return q, k, v


def _jax(fn, q, k, v, valid, dtype, **kw):
    jd = getattr(jnp, dtype)
    out = fn(jnp.asarray(q, jd), jnp.asarray(k, jd), jnp.asarray(v, jd),
             jnp.asarray(valid), **kw)
    return np.asarray(out.astype(jnp.float32))


def _port(q, k, v, valid, dtype):
    td = getattr(torch, dtype)
    out = dec_ops.decode_attention(torch.tensor(q).to(td),
                                   torch.tensor(k).to(td),
                                   torch.tensor(v).to(td),
                                   torch.tensor(valid))
    assert out.dtype == td
    return out.float().numpy()


def _lengths(b, t):
    """0 (a free slot), 1, ragged middles, t (a full cache)."""
    lens = [0, 1, t // 2 - 3, t][:b] + [t // 3] * max(0, b - 4)
    return np.arange(t)[None, :] < np.asarray(lens)[:, None]


@pytest.mark.parametrize("b,h,kv,t,d", [
    (2, 8, 2, 256, 64),
    (1, 4, 4, 128, 32),
    (3, 6, 2, 512, 128),
    (1, 16, 1, 256, 64),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_shared_mask_matches_reference(b, h, kv, t, d, dtype):
    q, k, v = _inputs(b, h, kv, t, d, b * t + h)
    valid = np.arange(t) < (t * 3 // 4)
    got = _port(q, k, v, valid, dtype)
    ref = _jax(jax_ref, q, k, v, valid, dtype)
    kern = _jax(jax_decode, q, k, v, valid, dtype, block_k=64,
                interpret=True)
    np.testing.assert_allclose(got, ref, rtol=TOL[dtype], atol=TOL[dtype])
    np.testing.assert_allclose(got, kern, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("b,h,kv,t,d", [
    (4, 8, 2, 256, 64),
    (3, 4, 4, 128, 32),
    (2, 16, 1, 256, 64),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_per_slot_mask_matches_reference(b, h, kv, t, d, dtype):
    q, k, v = _inputs(b, h, kv, t, d, 7 * b + t + h)
    valid = _lengths(b, t)
    got = _port(q, k, v, valid, dtype)
    kern = _jax(jax_decode, q, k, v, valid, dtype, block_k=64,
                interpret=True)
    np.testing.assert_allclose(got, _jax(jax_ref, q, k, v, valid, dtype),
                               rtol=TOL[dtype], atol=TOL[dtype])
    np.testing.assert_allclose(got, kern, rtol=TOL[dtype], atol=TOL[dtype])
    np.testing.assert_array_equal(got[0], np.zeros((h, d), np.float32))


def test_shared_mask_equals_equal_per_slot_rows():
    b, h, kv, t, d = 3, 6, 2, 128, 32
    q, k, v = (torch.tensor(x) for x in _inputs(b, h, kv, t, d, 11))
    shared = torch.arange(t) < 77
    a = dec_ops.decode_attention(q, k, v, shared)
    rows = dec_ops.decode_attention(q, k, v, shared[None, :].expand(b, t))
    assert torch.equal(a, rows)


def test_stale_entries_never_leak():
    b, h, kv, t, d = 2, 4, 2, 128, 32
    q, k, v = (torch.tensor(x) for x in _inputs(b, h, kv, t, d, 12))
    valid = torch.arange(t)[None, :] < torch.tensor([5, 100])[:, None]
    clean = dec_ops.decode_attention(q, k, v, valid)
    keep = valid[:, None, :, None]
    dirty = dec_ops.decode_attention(q, torch.where(keep, k, 1e6),
                                     torch.where(keep, v, 1e6), valid)
    assert torch.equal(clean, dirty)


def test_full_ring_matches_reference():
    b, h, kv, t, d = 2, 4, 2, 128, 32
    q, k, v = _inputs(b, h, kv, t, d, 0)
    valid = np.ones((t,), bool)
    np.testing.assert_allclose(
        _port(q, k, v, valid, "float32"),
        _jax(jax_decode, q, k, v, valid, "float32", block_k=32,
             interpret=True), atol=2e-5)


def test_single_valid_slot_returns_its_value_row():
    b, h, kv, t, d = 1, 2, 2, 64, 16
    q, k, v = _inputs(b, h, kv, t, d, 1)
    valid = np.arange(t) == 5
    got = _port(q, k, v, valid, "float32")
    np.testing.assert_allclose(got[0, 0], v[0, 0, 5], atol=2e-5)
    np.testing.assert_allclose(
        got, _jax(jax_decode, q, k, v, valid, "float32", block_k=32,
                  interpret=True), atol=2e-5)


def test_plain_version_counts_no_launch_and_checks_shapes():
    q, k, v = (torch.tensor(x) for x in _inputs(2, 4, 2, 16, 8, 2))
    before = dec_ops.COUNTER.count
    dec_ops.decode_attention(q, k, v, torch.ones(16, dtype=torch.bool))
    assert dec_ops.COUNTER.count == before
    assert torch.equal(
        dec_ops.decode_attention(q, k, v, torch.ones(16, dtype=torch.bool)),
        decode_attention_ref(q, k, v, torch.ones(16, dtype=torch.bool)))
    with pytest.raises(ValueError, match="bool"):
        dec_ops.decode_attention(q, k, v, torch.ones(16))
    with pytest.raises(ValueError):
        dec_ops.decode_attention(q[:, :3], k, v,
                                 torch.ones(16, dtype=torch.bool))


def test_chunk_length_depends_on_t_alone():
    assert dec_ops.chunk_len(1) == 256
    assert dec_ops.chunk_len(8192) == 256
    assert dec_ops.chunk_len(32768) == 512
    for t in (1, 300, 8192, 10 ** 6):
        c = dec_ops.chunk_len(t)
        assert c % dec_ops.CHUNK_ALIGN == 0 and -(-t // c) <= dec_ops.MAX_CHUNKS
        assert c % (4 * dec_ops.UNIT) == 0     # whole units for 4 warps


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ring", [False, True])
def test_dead_chunks_and_units_match_reference(dtype, ring):
    """Per-slot lengths that kill every key, all but one, whole 16-key
    units and whole 256-key chunks (0, 1, 255, 256, 257, t), or a full
    ring: the plain version against the reference's Pallas kernel (256-key
    blocks, so the dead blocks are swept there) and its oracle."""
    b, h, kv, t, d = 6, 8, 2, 1024, 64
    q, k, v = _inputs(b, h, kv, t, d, 21 + ring)
    if ring:
        valid = np.ones((t,), bool)
    else:
        lens = np.array([0, 1, 255, 256, 257, t])
        valid = np.arange(t)[None, :] < lens[:, None]
    got = _port(q, k, v, valid, dtype)
    np.testing.assert_allclose(got, _jax(jax_ref, q, k, v, valid, dtype),
                               rtol=TOL[dtype], atol=TOL[dtype])
    np.testing.assert_allclose(
        got, _jax(jax_decode, q, k, v, valid, dtype, block_k=256,
                  interpret=True), rtol=TOL[dtype], atol=TOL[dtype])
    if not ring:
        np.testing.assert_array_equal(got[0], np.zeros((h, d), np.float32))


# (t,) or (b, t) masks; per slot: no valid key, one, a few in the first
# slice alone, and a full row
LSE_MASKS = {"shared": np.arange(96) < 37,
             "per_slot": np.arange(96)[None, :] < np.array([0, 1, 5, 96])[
                 :, None]}


@pytest.mark.parametrize("mask", sorted(LSE_MASKS))
def test_plain_lse_is_the_float64_log_sum_exp(mask):
    b, h, kv, t, d = 4, 8, 2, 96, 64
    q, k, v = _inputs(b, h, kv, t, d, 31)
    valid = LSE_MASKS[mask]
    tq, tk, tv, tm = (torch.tensor(x) for x in (q, k, v, valid))
    out, lse = dec_ops.decode_attention(tq, tk, tv, tm, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (b, h)
    assert torch.equal(out, dec_ops.decode_attention(tq, tk, tv, tm))
    s = np.einsum("bkgd,bktd->bkgt", q.reshape(b, kv, h // kv, d).astype(
        np.float64), k.astype(np.float64)) * d ** -0.5
    m = np.broadcast_to(valid, (b, t))[:, None, None, :]
    s = np.where(m, s, -np.inf)
    top = s.max(-1, keepdims=True)
    with np.errstate(invalid="ignore"):
        want = (top[..., 0] + np.log(np.exp(s - top).sum(-1))).reshape(b, h)
    live = np.broadcast_to(valid, (b, t)).any(-1)
    np.testing.assert_allclose(lse.numpy()[live], want[live], rtol=0,
                               atol=1e-5)
    assert (lse.numpy()[~live] == NEG_INF).all()
    assert (out.numpy()[~live] == 0).all()


class _Gathered:
    """A stand-in for the axis of ``parts`` ranks: ``all_gather`` checks
    that it is handed rank ``index``'s packed partial and returns every
    rank's, stacked in rank order."""

    def __init__(self, packed, index):
        self.packed, self.index, self.size = packed, index, len(packed)

    def all_gather(self, t):
        assert torch.equal(t, self.packed[self.index])
        return torch.stack(self.packed)


@pytest.mark.parametrize("mask", sorted(LSE_MASKS))
@pytest.mark.parametrize("parts", [2, 3, 4])
def test_a_split_cache_merges_to_the_whole_call(parts, mask):
    b, h, kv, t, d = 4, 8, 2, 96, 64
    q, k, v = (torch.tensor(x) for x in _inputs(b, h, kv, t, d, 32))
    valid = torch.tensor(LSE_MASKS[mask])
    whole = dec_ops.decode_attention(q, k, v, valid)
    n = t // parts
    got = []
    for r in range(parts):
        cut = slice(r * n, (r + 1) * n)
        got.append(dec_ops.decode_attention(
            q, k[:, :, cut].contiguous(), v[:, :, cut].contiguous(),
            valid[..., cut], return_lse=True))
    packed = [torch.cat([o, l[..., None]], dim=-1) for o, l in got]
    # a row's slice without a valid key: zeros and -1e30 (every case has
    # some: the shared mask ends in the first half, rows 0 and 2 of the
    # per-slot one hold 0 and 5 keys)
    empty = 0
    for r, (o, l) in enumerate(got):
        dead = ~valid[..., r * n:(r + 1) * n].expand(b, n).any(-1)
        assert (l[dead] == NEG_INF).all() and (o[dead] == 0).all()
        empty += int(dead.sum())
    assert empty > 0
    merged = [merge_partials(o, l, _Gathered(packed, r))
              for r, (o, l) in enumerate(got)]
    for m in merged:            # every rank ends with the same bits
        assert torch.equal(m, merged[0])
    np.testing.assert_allclose(merged[0].numpy(), whole.numpy(), rtol=0,
                               atol=1e-6)
    if mask == "per_slot":      # no valid key on any rank: zeros
        assert (merged[0][0] == 0).all()
