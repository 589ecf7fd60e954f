"""Port parity: the fused similarity→top-k wrapper (its plain version on a
CPU tensor), ``merge_topk`` and the class-axis split the CUDA kernel uses,
against the JAX reference (``ops.similarity_topk`` in interpret mode and
``similarity_topk_ref``).

Ordering must match exactly: values descending, ties to the lower class
id. Values agree to 1e-5 (fp32 dot products of unit vectors summed in
another order, times inv_tau = 2).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.similarity_topk import ops as jops
from repro.kernels.similarity_topk import ref as jref
from repro_torch.kernels.similarity_topk import ops as tops
from repro_torch.kernels.similarity_topk.ref import similarity_topk_ref

torch.set_num_threads(1)

VTOL = dict(rtol=1e-5, atol=1e-5)


def _pair(seed, b, n, d):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, d)).astype(np.float32)
    c = rng.standard_normal((n, d)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    return x, c


def _both(x, c, k, inv_tau=2.0):
    vt, it = tops.similarity_topk(torch.tensor(x), torch.tensor(c), k,
                                  inv_tau=inv_tau)
    vj, ij = jops.similarity_topk(jnp.asarray(x), jnp.asarray(c), k,
                                  inv_tau=inv_tau, interpret=True)
    vr, ir = jref.similarity_topk_ref(jnp.asarray(x), jnp.asarray(c), k,
                                      inv_tau)
    assert vt.dtype == torch.float32 and it.dtype == torch.int32
    return (vt.numpy(), it.numpy()), (np.asarray(vj), np.asarray(ij)), \
        (np.asarray(vr), np.asarray(ir))


@pytest.mark.parametrize("k", [1, 5, 64])
@pytest.mark.parametrize("b,n,d", [
    (5, 137, 16),      # row padding, n a multiple of no block
    (16, 1000, 32),
    (3, 64, 8),        # k == n edge for k = 64
])
def test_matches_reference_ordering(b, n, d, k):
    x, c = _pair(b * n + d, b, n, d)
    (vt, it), (vj, ij), (vr, ir) = _both(x, c, k)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(it, ir)
    np.testing.assert_allclose(vt, vj, **VTOL)
    np.testing.assert_allclose(vt, vr, **VTOL)


@pytest.mark.parametrize("k", [5, 64])
def test_planted_ties_lower_id_wins(k):
    x, c = _pair(1, 4, 300, 16)
    dup = [3, 130, 257, 299]
    c[dup] = c[dup[0]]
    x[0] = c[dup[0]]
    (vt, it), (vj, ij), _ = _both(x, c, k)
    assert it[0, :4].tolist() == dup
    assert len(set(vt[0, :4].tolist())) == 1
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_allclose(vt, vj, **VTOL)


def test_all_classes_identical_returns_first_k_ids():
    x, c = _pair(2, 3, 70, 8)
    c[:] = c[0]
    (vt, it), (_, ij), _ = _both(x, c, 64)
    np.testing.assert_array_equal(it, np.tile(np.arange(64), (3, 1)))
    np.testing.assert_array_equal(it, ij)


@pytest.mark.parametrize("m,k", [(10, 3), (40, 40), (97, 64)])
def test_merge_topk_matches_reference(m, k):
    rng = np.random.default_rng(m)
    v = rng.integers(-3, 4, (5, m)).astype(np.float32)   # many exact ties
    i = np.stack([rng.permutation(10 * m)[:m] for _ in range(5)]) \
        .astype(np.int32)
    i[:, -1] = tops.IDX_PAD
    v[:, -1] = tops.NEG
    vt, it = tops.merge_topk(torch.tensor(v), torch.tensor(i), k)
    vj, ij = jops.merge_topk(jnp.asarray(v), jnp.asarray(i), k)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    with pytest.raises(ValueError):
        tops.merge_topk(torch.tensor(v), torch.tensor(i), m + 1)


@pytest.mark.parametrize("b,n,k", [(16, 512, 5), (64, 21841, 64),
                                   (3, 100, 64), (1, 5, 5)])
def test_class_split_then_merge_equals_global(b, n, k):
    """The kernel's design in plain PyTorch: per-chunk top-k partials with
    global ids (empty slots NEG / IDX_PAD), merged by ``merge_topk``, give
    the global answer bit for bit, ties included."""
    plan = tops.topk_plan(b, n, 512, k, 4, sms=132)
    chunk, parts = plan.chunk, plan.parts
    assert chunk % tops.CLASS_ALIGN == 0 and parts <= tops.MAX_PARTIALS
    assert (parts - 1) * chunk < n <= parts * chunk
    x, c = _pair(n + k, b, n, 8)
    c[n // 2] = c[0]                                # a tie across chunks
    x[0] = c[0]
    xt, ct = torch.tensor(x), torch.tensor(c)
    logits = (xt @ ct.T) * 3.0
    pool_v, pool_i = [], []
    for p in range(parts):
        lo, hi = p * chunk, min(n, (p + 1) * chunk)
        v = torch.full((b, k), tops.NEG)
        i = torch.full((b, k), tops.IDX_PAD, dtype=torch.int32)
        order = torch.sort(-logits[:, lo:hi], dim=1, stable=True).indices
        m = min(k, hi - lo)
        v[:, :m] = torch.gather(logits[:, lo:hi], 1, order[:, :m])
        i[:, :m] = (order[:, :m] + lo).to(torch.int32)
        pool_v.append(v)
        pool_i.append(i)
    vm, im = tops.merge_topk(torch.cat(pool_v, 1), torch.cat(pool_i, 1), k)
    vg, ig = similarity_topk_ref(xt, ct, k, 3.0)
    torch.testing.assert_close(im, ig, rtol=0, atol=0)
    torch.testing.assert_close(vm, vg, rtol=0, atol=0)


def test_bf16_inputs_accumulate_in_fp32():
    x, c = _pair(9, 6, 200, 32)
    xb, cb = torch.tensor(x).bfloat16(), torch.tensor(c).bfloat16()
    vt, it = tops.similarity_topk(xb, cb, 5, inv_tau=2.0)
    vj, ij = jops.similarity_topk(jnp.asarray(x, jnp.bfloat16),
                                  jnp.asarray(c, jnp.bfloat16), 5,
                                  inv_tau=2.0, interpret=True)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), **VTOL)


def test_classify_and_validation():
    x, c = _pair(4, 7, 50, 16)
    ids = tops.classify(torch.tensor(x), torch.tensor(c), inv_tau=5.0)
    np.testing.assert_array_equal(
        ids.numpy(), np.asarray(jops.classify(jnp.asarray(x), jnp.asarray(c),
                                              inv_tau=5.0, interpret=True)))
    xt, ct = torch.tensor(x), torch.tensor(c)
    with pytest.raises(ValueError):
        tops.similarity_topk(xt, ct, 51)             # k > n
    with pytest.raises(ValueError):
        tops.similarity_topk(xt, ct, 0)
    with pytest.raises(ValueError):
        tops.similarity_topk(xt, torch.zeros((200, 16)), tops.MAX_K + 1)
    with pytest.raises(ValueError):
        tops.similarity_topk(xt, ct[:, :8], 3)       # widths differ
    # a meta tensor launches nothing: the outputs' shapes and dtypes (the
    # dry run's branch), after the same checks
    meta = torch.zeros((7, 16), device="meta")
    vals, idx = tops.similarity_topk(meta, meta, 3)
    assert vals.is_meta and (vals.shape, vals.dtype) == ((7, 3),
                                                         torch.float32)
    assert (idx.shape, idx.dtype) == ((7, 3), torch.int32)
    with pytest.raises(ValueError):
        tops.similarity_topk(meta, meta[:, :8], 3)


def test_block_rows_and_the_class_split():
    """16 image rows per CTA up to b = 16, else 64 (16 where a 64-row image
    block of width d does not fit in shared memory); fewer rows per CTA
    means more row blocks sharing the card, so fewer CTAs along the class
    axis; other sizes are refused."""
    assert tops.row_block(16) == 16 and tops.row_block(17) == 64
    assert tops.row_block(64, d=1024) == 16
    at16 = tops.topk_plan(64, 21841, 512, 5, 4, 132, block_rows=16)
    at64 = tops.topk_plan(64, 21841, 512, 5, 4, 132, block_rows=64)
    assert (at16.row_blocks, at64.row_blocks) == (4, 1)
    assert at16.parts < at64.parts
    x, c = _pair(9, 4, 100, 8)
    with pytest.raises(ValueError, match="block_rows"):
        tops.similarity_topk(torch.tensor(x), torch.tensor(c), 5,
                             block_rows=32)
    want = tops.similarity_topk(torch.tensor(x), torch.tensor(c), 5)
    for rows in tops.BLOCK_ROWS:
        got = tops.similarity_topk(torch.tensor(x), torch.tensor(c), 5,
                                   block_rows=rows)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
