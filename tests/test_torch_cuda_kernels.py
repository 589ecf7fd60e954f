"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Every test here needs a CUDA card and the CUDA toolkit; on a
host without a card they skip (the card is looked for inside a fixture,
never at import). Run them on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py

Tolerances: flash f32, 5e-5 (fp32 sums over the keys in another order,
and the kernel's products split 3×TF32: about 2^-21 of each product, a few
1e-6 on a score at d 64, tests/test_torch_tf32_split.py);
flash bf16 outputs, 1.6e-2 (one bf16 ulp at |out| < 2 after the same fp32
result rounds), against the plain version that rounds p to bf16 before
p·v as the tensor-core kernel does (the kernel rounds the running-max p,
the plain version the normalised p: each term moves by at most 2^-9 of
itself, far below one output ulp); lse 5e-5 in both dtypes (fp32 on both
sides); top-k values, 1e-4 (fp32 dot products of unit vectors
times 1/0.07), with indices equal wherever the plain version's values are
further apart than that; the fused contrastive forward, LSE 5e-5 (fp32
sums of up to 2048 exponentials of values up to ~15 in another order) and
bit for bit equal to ``row_col_lse`` (one launch sequence serves both); at
B = 1 the fused backward's dA = exp(A − row_lse) + exp(A − col_lse) − 2
cancels to exactly 0, which holds only while every kernel forms A in the
same order.
"""
import pytest
import torch

from repro_torch.kernels.contrastive_loss import ops as cl_ops
from repro_torch.kernels.contrastive_loss.ref import fwd_fused_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import NEG_INF, flash_fwd_ref
from repro_torch.kernels.similarity_topk import ops as topk_ops
from repro_torch.kernels.similarity_topk.ref import similarity_topk_ref

from profile_windows import device_kernel_names

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.device import resolve_device
    resolve_device("cuda")
    return torch.Generator(device="cuda").manual_seed(0)


def _qkv(gen, bh, bkv, s, d, dtype):
    q = torch.randn((bh, s, d), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((bkv, s, d), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-5),
                                       (torch.bfloat16, 1.6e-2)])
@pytest.mark.parametrize("b,h,kv,s,d,causal,window,padded", [
    (16, 12, 12, 196, 64, False, None, False),   # image tower
    (64, 16, 16, 16, 64, False, None, True),     # text tower, padding bias
    (2, 8, 2, 200, 128, False, None, True),      # GQA, head dim 128
    (2, 4, 4, 131, 64, True, None, False),
    (2, 4, 4, 131, 64, True, 40, False),
    (3, 2, 2, 1, 64, False, None, False),        # one token
])
def test_flash_kernel_matches_plain(gen, b, h, kv, s, d, causal, window,
                                    padded, dtype, tol):
    q, k, v = _qkv(gen, b * h, b * kv, s, d, dtype)
    bias = None
    if padded:
        lens = torch.randint(1, s + 1, (b,), generator=gen, device="cuda")
        bias = torch.where(torch.arange(s, device="cuda")[None, :]
                           < lens[:, None], 0.0, NEG_INF).float()
    before = fa_ops.COUNTER.count
    out, lse = fa_ops.flash_fwd(q, k, v, bias, causal=causal, window=window)
    assert fa_ops.COUNTER.count == before + 1
    ref_out, ref_lse = flash_fwd_ref(q, k, v, bias, causal=causal,
                                     window=window)
    torch.cuda.synchronize()
    assert out.dtype == dtype and lse.dtype == torch.float32
    assert float((out.float() - ref_out.float()).abs().max()) <= tol
    assert float((lse - ref_lse).abs().max()) <= 5e-5


@pytest.mark.parametrize("b,h,kv,s,t,d,causal,window,padded", [
    (256, 12, 12, 196, 196, 64, False, None, False),  # image microbatch
    (256, 16, 16, 16, 16, 64, False, None, True),     # text microbatch
    (1, 32, 8, 512, 512, 64, True, 8192, False),      # prefill, GQA 4
    (2, 8, 2, 200, 200, 128, True, None, False),      # d 128, causal
    (2, 4, 4, 300, 300, 64, True, 70, False),         # window < tiles
    (3, 2, 2, 1, 1, 64, False, None, False),          # one token
    (2, 4, 2, 70, 133, 64, False, None, True),        # t % 64 != 0, s != t
    (2, 4, 4, 40, 40, 128, False, None, True),        # 3 warps, 48-key tile
])
def test_flash_tc_kernel_matches_plain_at_its_edges(gen, b, h, kv, s, t, d,
                                                    causal, window, padded):
    """The bf16 tensor-core forward at the main paths' shapes and at the
    edges of its plan (warps, key tile, ragged s and t, masks)."""
    q = torch.randn((b * h, s, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    k, v = (torch.randn((b * kv, t, d), generator=gen, device="cuda")
            .to(torch.bfloat16) for _ in range(2))
    bias = None
    if padded:
        lens = torch.randint(1, t + 1, (b,), generator=gen, device="cuda")
        bias = torch.where(torch.arange(t, device="cuda")[None, :]
                           < lens[:, None], 0.0, NEG_INF).float()
    before = fa_ops.COUNTER.count
    out, lse = fa_ops.flash_fwd(q, k, v, bias, causal=causal, window=window)
    assert fa_ops.COUNTER.count == before + 1
    ref_out, ref_lse = flash_fwd_ref(q, k, v, bias, causal=causal,
                                     window=window)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and bool(out.isfinite().all())
    assert float((out.float() - ref_out.float()).abs().max()) <= 1.6e-2
    assert float((lse - ref_lse).abs().max()) <= 5e-5


@pytest.mark.parametrize("b,h,kv,s,t,d,causal,window,padded", [
    (2, 4, 4, 1, 1, 64, False, None, False),          # one token
    (2, 4, 1, 7, 7, 128, False, None, True),          # GQA 4, d 128
    (2, 4, 4, 8, 8, 64, True, None, False),           # one 8-key step
    (2, 8, 2, 9, 9, 64, False, None, True),
    (2, 4, 4, 15, 15, 128, True, 4, False),
    (2, 4, 1, 16, 16, 64, False, None, True),         # text tower, GQA 4
    (2, 4, 4, 17, 17, 64, True, None, True),
    (2, 12, 12, 196, 196, 64, False, None, False),    # image tower
    (2, 8, 2, 257, 257, 128, True, None, False),
    (1, 8, 2, 520, 520, 64, True, 100, False),        # window < tiles
    (2, 4, 4, 9, 17, 64, False, None, True),          # s != t
    (2, 4, 4, 17, 9, 128, False, None, False),
    (1, 4, 1, 196, 520, 64, False, None, True),       # t past 8 tiles
])
def test_flash_f32_kernel_matches_plain_at_its_edges(gen, b, h, kv, s, t, d,
                                                     causal, window, padded):
    """The split 3×TF32 forward at the edges of its 16-row, 8-key tiling
    (s, t of 1, 7, 8, 9, 15, 16, 17, 196, 257, 520), GQA groups 1 and 4,
    head dims 64 and 128, causal, windowed and bias masks: out and lse
    within the f32 limit (5e-5) of the plain fp32 version."""
    q = torch.randn((b * h, s, d), generator=gen, device="cuda")
    k, v = (torch.randn((b * kv, t, d), generator=gen, device="cuda")
            for _ in range(2))
    bias = None
    if padded:
        lens = torch.randint(1, t + 1, (b,), generator=gen, device="cuda")
        bias = torch.where(torch.arange(t, device="cuda")[None, :]
                           < lens[:, None], 0.0, NEG_INF).float()
    before = fa_ops.COUNTER.count
    out, lse = fa_ops.flash_fwd(q, k, v, bias, causal=causal, window=window)
    assert fa_ops.COUNTER.count == before + 1
    ref_out, ref_lse = flash_fwd_ref(q, k, v, bias, causal=causal,
                                     window=window)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and bool(out.isfinite().all())
    assert float((out - ref_out).abs().max()) <= 5e-5
    assert float((lse - ref_lse).abs().max()) <= 5e-5


def test_flash_kernel_refuses_what_it_does_not_take(gen):
    q, k, v = _qkv(gen, 4, 4, 8, 64, torch.float16)
    with pytest.raises(TypeError):
        fa_ops.flash_fwd(q, k, v)
    q, k, v = _qkv(gen, 4, 4, 8, 32, torch.float32)
    with pytest.raises(ValueError, match="head dims"):
        fa_ops.flash_fwd(q, k, v)
    q, k, v = _qkv(gen, 4, 4, 8, 64, torch.float32)
    with pytest.raises(ValueError, match="contiguous"):
        fa_ops.flash_fwd(q.transpose(1, 2).contiguous().transpose(1, 2),
                         k, v)
    # the bf16 kernel copies 16-byte rows: an unaligned start is refused
    q, k, v = _qkv(gen, 4, 4, 8, 64, torch.bfloat16)
    flat = torch.empty(q.numel() + 1, dtype=torch.bfloat16, device="cuda")
    shifted = flat[1:].view(q.shape)
    shifted.copy_(q)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    before = fa_ops.COUNTER.count
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa_ops.flash_fwd(shifted, k, v)
    assert fa_ops.COUNTER.count == before


def test_flash_kernels_refuse_shapes_the_grid_cannot_hold(gen):
    """More query blocks (forward) or key blocks (backward) than a grid's
    65535 rows: a ValueError before anything launches."""
    q = torch.empty((1, 65535 * 64 + 1, 64), device="cuda")
    k = torch.empty((1, 1, 64), device="cuda")
    before = fa_ops.COUNTER.count
    with pytest.raises(ValueError, match="query blocks"):
        fa_ops.flash_fwd(q, k, k, causal=False)
    assert fa_ops.COUNTER.count == before
    del q
    t = 65535 * fa_ops.F32_MAX_KEY_BLOCK[64] + 1
    q = torch.empty((1, 1, 64), device="cuda")
    k = torch.empty((1, t, 64), device="cuda")
    lse = torch.zeros((1, 1), device="cuda")
    before = fa_ops.BWD_COUNTER.count
    with pytest.raises(ValueError, match="key blocks"):
        fa_ops.flash_bwd(q, k, k, None, q, lse, q, causal=False)
    assert fa_ops.BWD_COUNTER.count == before


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_launches_take_only_their_plans_bytes(gen, dtype, d):
    """A plan's ``smem`` is what the launch allocates: each C entry takes
    it and refuses other bytes than its own layout's for that plan, before
    anything runs (outputs untouched); the plan's own bytes launch."""
    bh, s = 4, 196
    q, k, v = _qkv(gen, bh, bh, s, d, dtype)
    stream = torch.cuda.current_stream().cuda_stream
    fwd = fa_ops.fwd_plan(bh, s, s, d, dtype)
    code = 0 if dtype == torch.float32 else 1
    for smem, ok in ((fwd.smem - 16, False), (fwd.smem + 16, False),
                     (fwd.smem, True)):
        out = torch.full_like(q, 7.0)
        lse = torch.full((bh, s), 7.0, device="cuda")
        rc = fa_ops.LIB.lib().repro_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), None, out.data_ptr(),
            lse.data_ptr(), code, bh, s, s, d, 1, 1, 0, -1,
            float(d ** -0.5), fwd.warps, fwd.key_tile, smem, stream)
        torch.cuda.synchronize()
        assert (rc == 0) == ok, (smem, rc)
        assert bool((lse == 7.0).all()) != ok
    out, lse = fa_ops.flash_fwd(q, k, v, causal=False)
    dout = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
    bwd = fa_ops.bwd_plan(bh, s, s, d, dtype)
    part = torch.empty((max(bwd.dq_part_floats, 1),), device="cuda")
    for smem, ok in ((bwd.smem - 16, False), (bwd.smem + 16, False),
                     (bwd.smem, True)):
        delta = torch.full((bh, s), 7.0, device="cuda")
        grads = [torch.full_like(x, 7.0) for x in (q, k, v)]
        rc = fa_ops.BWD_LIB.lib().repro_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), None, out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            *(x.data_ptr() for x in grads), part.data_ptr(), code, bh, s, s,
            d, bwd.key_block, smem, 1, 1, 0, -1, float(d ** -0.5), stream)
        torch.cuda.synchronize()
        assert (rc == 0) == ok, (smem, rc)
        assert bool((delta == 7.0).all()) != ok
        assert bool((grads[1] == 7.0).all()) != ok


def _unit(n, d, gen, dtype):
    x = torch.randn((n, d), generator=gen, device="cuda")
    return (x / x.norm(dim=1, keepdim=True)).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,k", [(16, 512, 5), (64, 21841, 64),
                                   (5, 137, 1), (70, 3000, 17), (1, 64, 64)])
def test_topk_kernel_matches_plain(gen, b, n, k, dtype):
    x, c = _unit(b, 512, gen, dtype), _unit(n, 512, gen, dtype)
    before = topk_ops.COUNTER.count
    vals, idx = topk_ops.similarity_topk(x, c, k, inv_tau=1 / 0.07)
    assert topk_ops.COUNTER.count == before + 1
    _assert_topk(vals, idx, x, c, k)


def _assert_topk(vals, idx, x, c, k, tol=1e-4):
    """Values within tol of the plain version's, and the ids equal wherever
    the plain version's neighbouring values are further apart than tol."""
    ref_v, ref_i = similarity_topk_ref(x, c, min(k + 1, c.shape[0]),
                                       1 / 0.07)
    torch.cuda.synchronize()
    assert float((vals - ref_v[:, :k]).abs().max()) <= tol
    gap_up = torch.full_like(ref_v, float("inf"))
    gap_up[:, 1:] = ref_v[:, :-1] - ref_v[:, 1:]
    gap_down = torch.full_like(ref_v, float("inf"))
    gap_down[:, :-1] = gap_up[:, 1:]
    apart = (gap_up > tol) & (gap_down > tol)
    assert bool(((idx == ref_i[:, :k]) | ~apart[:, :k]).all())


@pytest.mark.parametrize("b", [3, 40])
def test_topk_kernel_ties_go_to_the_lower_id(gen, b):
    x, c = _unit(b, 64, gen, torch.float32), _unit(5000, 64, gen,
                                                   torch.float32)
    dup = [11, 700, 2500, 4999]
    c[dup] = c[dup[0]].clone()
    x[0] = c[dup[0]]
    plan = topk_ops.topk_plan(b, 5000, 64, 8, 4,
                              torch.cuda.get_device_properties(0)
                              .multi_processor_count)
    assert len({i // plan.chunk for i in dup}) == 4   # one tie per CTA
    for k in (8, 64):
        vals, idx = topk_ops.similarity_topk(x, c, k, inv_tau=10.0)
        assert idx[0, :4].tolist() == dup
        assert len(set(vals[0, :4].tolist())) == 1
    same = c.clone()
    same[:] = c[0]
    _, idx = topk_ops.similarity_topk(x, same, 64)
    assert idx.tolist() == [list(range(64))] * b


@pytest.mark.parametrize("b,rows", [(17, 16), (33, 16), (65, 64),
                                    (70, 64)])
def test_topk_kernel_rows_past_a_whole_block(gen, b, rows):
    """b not a multiple of the image rows per CTA, at k 64: the last row
    block is partial; its rows past b take no part."""
    x, c = _unit(b, 512, gen, torch.float32), _unit(3000, 512, gen,
                                                    torch.float32)
    vals, idx = topk_ops.similarity_topk(x, c, 64, inv_tau=1 / 0.07,
                                         block_rows=rows)
    assert vals.shape == (b, 64) and idx.shape == (b, 64)
    _assert_topk(vals, idx, x, c, 64)


def test_topk_kernel_is_one_device_kernel_per_call(gen):
    """One call: one launch, which also merges the CTAs' partials."""
    for b, n in ((16, 512), (64, 21841)):
        x, c = _unit(b, 512, gen, torch.float32), _unit(n, 512, gen,
                                                        torch.float32)
        topk_ops.similarity_topk(x, c, 5)          # scratch made here
        torch.cuda.synchronize()

        def three_calls():
            for _ in range(3):
                topk_ops.similarity_topk(x, c, 5)
        # a window whose device records the tracer lost is taken again
        names = device_kernel_names(three_calls)
        assert len(names) == 3, names
        assert all("topk_kernel" in n for n in names), names


@pytest.mark.parametrize("rows", [16, 64])
def test_topk_kernel_matches_plain_at_each_block_size(gen, rows):
    x, c = _unit(40, 512, gen, torch.float32), _unit(3000, 512, gen,
                                                     torch.float32)
    vals, _ = topk_ops.similarity_topk(x, c, 5, inv_tau=1 / 0.07,
                                       block_rows=rows)
    ref_v, _ = similarity_topk_ref(x, c, 5, 1 / 0.07)
    assert float((vals - ref_v).abs().max()) <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,d", [(2048, 512), (1000, 512), (1, 512),
                                 (130, 200)])
def test_fwd_fused_kernel_matches_plain_and_row_col_lse(gen, b, d, dtype):
    x, y = _unit(b, d, gen, dtype), _unit(b, d, gen, dtype)
    it = torch.tensor(1 / 0.07, device="cuda")
    before = (cl_ops.FWD_COUNTER.count, cl_ops.ROW_COL_LSE_COUNTER.count)
    row, col = cl_ops.fwd_fused(x, y, it)
    assert cl_ops.FWD_COUNTER.count == before[0] + 1
    assert cl_ops.ROW_COL_LSE_COUNTER.count == before[1]
    ref_row, ref_col = fwd_fused_ref(x, y, it)
    assert float((row - ref_row).abs().max()) <= 5e-5
    assert float((col - ref_col).abs().max()) <= 5e-5
    lrow, lcol = cl_ops.row_col_lse(x, y, it)
    assert torch.equal(row, lrow) and torch.equal(col, lcol)
    again = cl_ops.fwd_fused(x, y, it)
    assert torch.equal(again[0], row) and torch.equal(again[1], col)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 512, 1024])
def test_fwd_fused_lets_the_backward_cancel_at_one_pair(gen, d, dtype):
    """B = 1: row_lse = col_lse = A, so dA = 1 + 1 − 2 = 0 bit for bit
    when the backward recomputes A in the forward's order."""
    x, y = _unit(1, d, gen, dtype), _unit(1, d, gen, dtype)
    it = torch.tensor(1 / 0.07, device="cuda")
    row, col = cl_ops.fwd_fused(x, y, it)
    dx, dy, _ = cl_ops.bwd_fused(x, y, it, row, col)
    assert not bool(dx.any()) and not bool(dy.any())


def test_fwd_fused_is_the_tile_sweep_and_its_combine(gen):
    """One call: the two device kernels of row_col_lse's sequence."""
    x, y = (_unit(2048, 512, gen, torch.float32) for _ in range(2))
    cl_ops.fwd_fused(x, y, 1 / 0.07)
    torch.cuda.synchronize()
    # a window whose device records the tracer lost is taken again
    names = device_kernel_names(lambda: cl_ops.fwd_fused(x, y, 1 / 0.07))
    assert any("contrastive_lse_tile_kernel" in n for n in names), names
    assert any("contrastive_lse_combine_kernel" in n for n in names), names
