"""The two redesigned forward kernels, on the CPU: their launch plans (pure
host arithmetic), the plain flash forward's bf16 rounding of p, and the
build cache's hash over the headers a kernel source includes.

- ``contrastive_loss.ops.lse_plan`` picks ``row_col_lse``'s tile edge
  (128, or 64 / 32 where 128 would leave SMs idle); the tiles cover B and
  the scratch is 4 · ⌈B/T⌉ · B floats.
- ``flash_attention.ops.fwd_plan`` picks the kernels' warps (16 query
  rows each) and key tile: 16-key steps in bf16, 8-key steps (tiles of at
  most 32) in f32 (the split 3×TF32 kernel), and every plan's shared memory
  fits one CTA.
- ``flash_fwd_ref`` rounds p to bf16 for bf16 inputs, as the tensor-core
  kernel does; its f32 output is the unrounded formula, bit for bit, and
  its bf16 output still matches the reference's Pallas forward (interpret
  mode) at the port's bf16 parity tolerance (2e-2,
  tests/test_torch_attention.py).
- ``KernelLibrary.path`` changes when an included ``csrc`` header changes.
- ``decode_attention.ops.decode_plan`` keeps the chunking a function of t
  alone, sizes the CTAs per row to fill the card once and no further, and
  sizes the partials' scratch; ``similarity_topk.ops.topk_plan`` splits
  the class axis into ranges of whole lanes that fill the card once, within
  the merge's buffers, and counts the CTA's shared memory as the kernel
  does.
- ``ssd_scan.ops.ssd_plan`` cuts the sequence's 64-token sub-chunks into
  at most 8 segments of whole sub-chunks (one CTA each, one cluster per
  (batch, head, head_dim block)), covers a ragged tail, fits one CTA's
  shared memory at every state size up to 256 in both dtypes, gives the
  card at least 132 CTAs at the serving prefill, and refuses what the
  kernel does not take.
- ``contrastive_loss.ops.fwd_fused`` runs ``row_col_lse``'s launch
  sequence: one C signature, ``lse_plan``'s tile and scratch.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_fwd_bh
from repro_torch.kernels import build
from repro_torch.kernels.contrastive_loss import ops as cl_ops
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.similarity_topk import ops as topk_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.flash_attention.ref import (NEG_INF, _scores,
                                                     flash_fwd_ref)

torch.set_num_threads(1)


@pytest.mark.parametrize("b", [1, 2, 31, 32, 33, 130, 512, 1000, 1408,
                               1409, 2048, 4097, 8192, 65536])
def test_lse_plan_covers_b_and_sizes_its_scratch(b):
    plan = cl_ops.lse_plan(b)
    assert plan.tile in cl_ops.LSE_TILES
    assert plan.tiles == -(-b // plan.tile)
    assert (plan.tiles - 1) * plan.tile < b <= plan.tiles * plan.tile
    assert plan.grid == (plan.tiles, plan.tiles)
    assert plan.scratch_floats == 4 * plan.tiles * b
    # the largest edge that still gives every SM a tile, else the smallest
    fills = [t for t in cl_ops.LSE_TILES if (-(-b // t)) ** 2 >= cl_ops.SMS]
    assert plan.tile == (fills[0] if fills else cl_ops.LSE_TILES[-1])


@pytest.mark.parametrize("b,tile,tiles", [
    (1, 32, 1), (512, 32, 16), (1000, 64, 16), (1408, 64, 22),
    (1409, 128, 12), (2048, 128, 16), (8192, 128, 64)])
def test_lse_plan_at_the_bench_shapes(b, tile, tiles):
    plan = cl_ops.lse_plan(b)
    assert (plan.tile, plan.tiles) == (tile, tiles)


@pytest.mark.parametrize("b", [1, 512, 1000, 1408, 1409, 2048, 8192])
def test_lse_plan_keeps_bf16_tiles_at_64(b):
    """bf16 takes the f32 plan's edge capped at 64 (a 128 tile spills);
    the tiles still cover B and the scratch follows the edge."""
    plan = cl_ops.lse_plan(b, torch.bfloat16)
    assert plan.tile == min(cl_ops.lse_plan(b).tile, 64)
    assert (plan.tiles - 1) * plan.tile < b <= plan.tiles * plan.tile
    assert plan.scratch_floats == 4 * plan.tiles * b


@pytest.mark.parametrize("bh,s,t,d,warps,key_tile,blocks", [
    (3072, 196, 196, 64, 4, 64, 4),    # image tower, training microbatch
    (192, 196, 196, 64, 4, 64, 4),     # image tower, serving
    (4096, 16, 16, 64, 1, 16, 1),      # text tower, training microbatch
    (1024, 16, 16, 64, 1, 16, 1),      # text tower, serving
    (32, 512, 512, 64, 4, 64, 8),      # Llama-3.2-1B prefill
    (16, 200, 200, 128, 4, 64, 4),     # head dim 128
    (16, 4096, 4096, 80, 4, 64, 64),   # head dim 80, HuBERT at s 4096
    (6, 1, 1, 64, 1, 16, 1),           # one token
    (8, 40, 40, 64, 3, 48, 1),
    (8, 70, 33, 64, 4, 48, 2)])
def test_flash_fwd_plan(bh, s, t, d, warps, key_tile, blocks):
    plan = fa_ops.fwd_plan(bh, s, t, d, torch.bfloat16)
    assert (plan.warps, plan.key_tile) == (warps, key_tile)
    assert plan.grid == (bh, blocks)
    assert 16 * plan.warps * blocks >= s
    # f32: the same warps and grid, key tiles of 32 in 8-key steps
    f32 = fa_ops.fwd_plan(bh, s, t, d, torch.float32)
    assert (f32.warps, f32.grid) == (warps, (bh, blocks))
    assert f32.key_tile == min(32, -(-t // 8) * 8)


@pytest.mark.parametrize("d", [64, 80, 128])
@pytest.mark.parametrize("s,warps,key_tile,blocks", [
    (1, 1, 8, 1), (16, 1, 16, 1), (196, 4, 32, 4), (200, 4, 32, 4),
    (520, 4, 32, 9), (8704, 4, 32, 136)])
def test_flash_fwd_f32_plan(s, warps, key_tile, blocks, d):
    """The split 3×TF32 forward: 16 query rows per warp, key tiles of 32 in
    steps of 8 (s = t = 196 stages 200 keys, not 256), the grid covering s;
    at d 64 three CTAs of a 32-key plan share an SM (228 KB, 1 KB of it
    reserved per CTA)."""
    plan = fa_ops.fwd_plan(32, s, s, d, torch.float32)
    assert (plan.warps, plan.key_tile, plan.grid) == (warps, key_tile,
                                                      (32, blocks))
    assert plan.smem <= fa_ops.SMEM_LIMIT
    if d == 64:
        assert 3 * (plan.smem + 1024) <= 228 * 1024


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 80, 128])
def test_flash_plans_fit_shared_memory(d, dtype):
    """Every forward and backward plan, over s and t from 1 to 8704, fits
    the 227 KB a CTA may hold; the f32 backward's largest key block is the
    largest multiple of 16 keys that fits, and a longer t splits."""
    for n in (1, 7, 8, 9, 15, 16, 17, 48, 64, 65, 96, 97, 196, 200, 208,
              209, 256, 257, 520, 8192, 8704):
        assert fa_ops.fwd_plan(8, n, n, d, dtype).smem <= fa_ops.SMEM_LIMIT
        assert fa_ops.bwd_plan(8, n, n, d, dtype).smem <= fa_ops.SMEM_LIMIT
    if dtype == torch.float32:
        top = fa_ops.F32_MAX_KEY_BLOCK[d]
        assert top == {64: 208, 80: 160, 128: 96}[d]
        assert fa_ops.bwd_plan(8, top, top, d, dtype).key_blocks == 1
        assert fa_ops.bwd_plan(8, top + 1, top + 1, d,
                               dtype)[:2] == (top, 2)
        assert fa_ops._f32_bwd_smem(top + 16, d) > fa_ops.SMEM_LIMIT


def _flash_inputs(bh, bkv, s, d, dtype, padded, seed):
    rng = np.random.default_rng(seed)
    q = torch.tensor(rng.standard_normal((bh, s, d)).astype(
        np.float32)).to(dtype)
    k, v = (torch.tensor(rng.standard_normal((bkv, s, d)).astype(
        np.float32)).to(dtype) for _ in range(2))
    bias = None
    if padded:
        lens = np.maximum(1, rng.integers(1, s + 1, bh // 2))
        bias = torch.tensor(np.where(np.arange(s)[None, :] < lens[:, None],
                                     0.0, NEG_INF).astype(np.float32))
    return q, k, v, bias


def _unrounded_fwd(q, k, v, bias, causal, window):
    """The forward formula with nothing rounded but the output."""
    _, _, vf, scores = _scores(q, k, v, bias, causal, window)
    lse = torch.logsumexp(scores, dim=-1)
    out = torch.matmul(torch.exp(scores - lse[..., None]), vf)
    return out.to(q.dtype), lse


@pytest.mark.parametrize("causal,window,padded,group", [
    (False, None, True, 1), (True, None, False, 2), (True, 5, False, 1)])
def test_flash_fwd_ref_f32_is_the_unrounded_formula(causal, window, padded,
                                                    group):
    q, k, v, bias = _flash_inputs(4, 4 // group, 21, 64, torch.float32,
                                  padded, 5)
    got = flash_fwd_ref(q, k, v, bias, causal=causal, window=window)
    ref = _unrounded_fwd(q, k, v, bias, causal, window)
    for a, r in zip(got, ref):
        assert torch.equal(a, r)


def test_flash_fwd_ref_bf16_rounds_p():
    """bf16: out is p·v with p rounded to bf16 (not the fp32 p); lse is
    the unrounded fp32 log-sum-exp."""
    q, k, v, _ = _flash_inputs(2, 2, 17, 64, torch.bfloat16, False, 6)
    out, lse = flash_fwd_ref(q, k, v, None, causal=False)
    *_, scores = _scores(q, k, v, None, False, None)
    p = torch.exp(scores - lse[..., None]).to(torch.bfloat16).float()
    want = torch.matmul(p, v.float()).to(torch.bfloat16)
    assert torch.equal(out, want)
    unrounded, unrounded_lse = _unrounded_fwd(q, k, v, None, False, None)
    assert torch.equal(lse, unrounded_lse)
    assert not torch.equal(out, unrounded)


@pytest.mark.parametrize("causal,window,padded", [
    (False, None, True), (True, None, False), (True, 6, False),
    (False, None, False)])
def test_flash_fwd_ref_bf16_matches_reference_kernel(causal, window,
                                                     padded):
    bh, s, d = 4, 24, 64
    q, k, v, bias = _flash_inputs(bh, bh, s, d, torch.bfloat16, padded, 8)
    jargs = [jnp.asarray(x.float().numpy(), jnp.bfloat16)
             for x in (q, k, v)]
    jbias = None if bias is None else jnp.asarray(
        np.repeat(bias.numpy(), 2, axis=0))
    tbias = None if bias is None else bias.repeat_interleave(2, dim=0)
    out, lse = flash_fwd_bh(*jargs, jbias, causal=causal, window=window,
                            block_q=8, block_k=8, interpret=True)
    got_out, got_lse = flash_fwd_ref(q, k, v, tbias, causal=causal,
                                     window=window)
    np.testing.assert_allclose(got_out.float().numpy(),
                               np.asarray(out.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse),
                               rtol=2e-2, atol=2e-2)


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)


def test_kernel_library_path_hashes_included_headers(tmp_path):
    _write(tmp_path / "k.cu", '#include <cuda_runtime.h>\n#include "a.cuh"\n'
           'int x;\n')
    _write(tmp_path / "a.cuh", '#pragma once\n#include "b.cuh"\n')
    _write(tmp_path / "b.cuh", "// b\n")
    src = str(tmp_path / "k.cu")
    assert build.source_files(src) == [src, str(tmp_path / "a.cuh"),
                                       str(tmp_path / "b.cuh")]
    lib = build.KernelLibrary("k", src, {})
    first = lib.path
    assert lib.path == first                      # stable while unchanged
    _write(tmp_path / "b.cuh", "// b, edited\n")  # a header two levels down
    second = lib.path
    assert second != first
    _write(tmp_path / "k.cu", '#include "a.cuh"\nint y;\n')
    assert lib.path not in (first, second)


def test_flash_libraries_hash_the_shared_header():
    for lib in (fa_ops.LIB, fa_ops.BWD_LIB):
        files = build.source_files(lib.source)
        assert files[0] == lib.source
        assert [os.path.basename(f) for f in files[1:]] == ["tc.cuh"]


@pytest.mark.parametrize("b,kv,g,t,d,blocks,chunk,chunks,group,ctas", [
    (8, 8, 4, 8192, 64, 4, 256, 32, 4, 8),      # Llama-3.2-1B, 8 slots
    (1, 8, 4, 8192, 64, 4, 256, 32, 4, 32),     # one lockstep request
    (2, 2, 8, 1000, 128, 2, 256, 4, 8, 4),      # d 128, group 8
    (2, 2, 20, 700, 64, 2, 256, 3, 16, 3),      # group 20: two CTAs per row
    (2, 8, 1, 1000, 64, 4, 256, 4, 4, 4),       # group 1
    (3, 4, 1, 1, 64, 4, 256, 1, 4, 1),          # one key
    (8, 8, 4, 32768, 64, 4, 512, 64, 4, 8),     # long cache
    (64, 8, 4, 8192, 64, 4, 256, 32, 4, 1),     # a row per CTA fills the card
    (128, 8, 4, 8192, 64, 4, 256, 32, 4, 1),    # more rows than the card
    (1, 1, 4, 524288, 64, 4, 8192, 64, 4, 64),  # the longest cache
])
def test_decode_plan(b, kv, g, t, d, blocks, chunk, chunks, group, ctas):
    plan = dec_ops.decode_plan(b, kv, g, t, d, sms=132, blocks_per_sm=blocks)
    assert (plan.chunk_len, plan.n_chunks, plan.group,
            plan.ctas_per_row) == (chunk, chunks, group, ctas)
    assert plan.chunk_len == dec_ops.chunk_len(t)           # t alone
    assert plan.grid == (b * kv, ctas, -(-g // group))
    assert plan.scratch_floats == b * kv * g * chunks * (d + 2)
    per_cta = -(-chunks // ctas)                              # chunks per CTA
    assert per_cta * plan.chunk_len <= dec_ops.MAX_CTA_KEYS
    assert ctas == -(-chunks // per_cta)                      # balanced
    rows = b * kv * plan.grid[2]
    if rows * ctas > 132 * blocks:                            # one wave
        assert ctas == 1 or per_cta * plan.chunk_len == dec_ops.MAX_CTA_KEYS


def test_decode_plan_refuses_a_cache_past_the_kernel():
    with pytest.raises(ValueError, match="t <="):
        dec_ops.decode_plan(1, 1, 4, dec_ops.MAX_T + 1, 64, 132, 4)
    assert dec_ops.head_group(4) == 4 and dec_ops.head_group(5) == 8
    assert dec_ops.head_group(16) == 16 and dec_ops.head_group(40) == 16


@pytest.mark.parametrize("b,n,d,k,item,rows,chunk,parts,nb", [
    (16, 512, 512, 5, 4, 16, 16, 32, 2),        # zero-shot serving request
    (64, 21841, 512, 5, 4, 64, 176, 125, 2),    # 64 images x ImageNet-21k
    (64, 21841, 512, 64, 4, 64, 176, 125, 1),   # k 64: one merge buffer
    (16, 21841, 512, 5, 4, 16, 96, 228, 2),     # two CTAs per SM
    (64, 21841, 512, 5, 2, 64, 96, 228, 2),     # bf16: two CTAs per SM
    (70, 3000, 512, 17, 4, 64, 48, 63, 2),      # two row blocks
    (64, 1000, 1024, 5, 4, 16, 32, 32, 2),      # wide rows: 16 per CTA
    (1, 64, 512, 64, 4, 16, 16, 4, 1),
    (3, 40000, 8, 5, 4, 16, 160, 250, 2),       # 16 groups of 16
])
def test_topk_plan(b, n, d, k, item, rows, chunk, parts, nb):
    plan = topk_ops.topk_plan(b, n, d, k, item, sms=132)
    assert (plan.rows, plan.chunk, plan.parts,
            plan.merge_buffers) == (rows, chunk, parts, nb)
    assert plan.row_blocks == -(-b // rows)
    assert plan.chunk % topk_ops.CLASS_ALIGN == 0
    assert (parts - 1) * chunk < n <= parts * chunk
    assert parts <= topk_ops.MAX_PARTIALS
    assert plan.groups == -(-parts // topk_ops.MERGE_GROUP) <= 16
    assert plan.stride == -(-parts * k // 4) * 4
    assert plan.group_stride == -(-plan.groups * k // 4) * 4
    assert plan.smem <= topk_ops.SMEM_MAX
    # a merge's buffers reuse the sweep's memory and never ask for more
    assert plan.smem == topk_ops.smem_bytes(rows, d, k, item)
    assert (topk_ops.warps(rows) * nb * 4 * topk_ops.MERGE_GROUP * k * 4
            <= plan.smem)


def test_topk_plan_smem_and_row_blocks():
    # the image block (64 x (512 + 4) fp32), a 3-stage ring of 128 classes
    # x 36 fp32, the lists (64 x 5 x 8 bytes)
    # and the half warps' runs (8 warps x 2 x 5 x 8 bytes)
    assert topk_ops.smem_bytes(64, 512, 5, 4) == (
        64 * 516 * 4 + 3 * 128 * 36 * 4 + 64 * 5 * 8 + 8 * 2 * 5 * 8)
    assert topk_ops.smem_bytes(16, 512, 5, 2) == (
        16 * 520 * 2 + 4 * 128 * 40 * 2 + 16 * 5 * 8 + 4 * 2 * 5 * 8)
    # a merge's buffers: two rows of 16 partials x 64, values and ids, two
    # sets, per warp (more than the sweep at d 8)
    assert topk_ops.smem_bytes(64, 8, 64, 4, 2) == 8 * 2 * 4 * 16 * 64 * 4
    assert topk_ops.row_block(16) == 16 and topk_ops.row_block(17) == 64
    assert topk_ops.row_block(64, d=1024) == 16
    forced = topk_ops.topk_plan(64, 21841, 512, 5, 4, 132, block_rows=16)
    assert forced.rows == 16 and forced.row_blocks == 4
    with pytest.raises(ValueError, match="shared memory"):
        topk_ops.topk_plan(64, 100, 1024, 5, 4, 132, block_rows=64)


def test_serving_libraries_hash_the_shared_header():
    """decode.cu, topk.cu and ssd.cu take cp.async (and ldmatrix, mma) from
    the flash kernels' header; an edit to it rebuilds them too."""
    for lib in (dec_ops.LIB, topk_ops.LIB, ssd_ops.LIB):
        files = build.source_files(lib.source)
        assert files[0] == lib.source
        assert [os.path.basename(f) for f in files[1:]] == ["tc.cuh"]
        assert files[1] == build.source_files(fa_ops.LIB.source)[1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,l,h,p,n", [
    (1, 1, 24, 64, 128), (1, 63, 24, 64, 128), (1, 64, 24, 64, 128),
    (1, 65, 24, 64, 128), (1, 244, 24, 64, 128), (1, 256, 24, 64, 128),
    (1, 513, 24, 64, 128), (1, 1024, 24, 64, 128), (8, 256, 24, 64, 128),
    (1, 4096, 24, 64, 128), (2, 200, 4, 48, 256), (1, 13, 2, 16, 8),
    (2, 96, 3, 32, 16)])
def test_ssd_plan_covers_the_sequence(b, l, h, p, n, dtype):
    plan = ssd_ops.ssd_plan(b, l, h, p, n, dtype)
    sub = ssd_ops.SUB
    assert plan.subchunks == -(-l // sub)
    # whole sub-chunks, none of the cluster's CTAs empty
    assert 1 <= plan.cluster <= ssd_ops.MAX_CLUSTER
    assert plan.cluster * plan.per_cta >= plan.subchunks
    assert (plan.cluster - 1) * plan.per_cta < plan.subchunks
    assert plan.per_cta == -(-plan.subchunks // ssd_ops.MAX_CLUSTER)
    assert p % plan.p_block == 0 and plan.p_block in ssd_ops.P_BLOCKS
    assert plan.grid == (plan.cluster * b * h, p // plan.p_block)
    assert plan.ctas == plan.grid[0] * plan.grid[1]
    assert plan.stages in (1, 2) and (plan.stages == 1 or plan.per_cta > 1)
    item = torch.finfo(dtype).bits // 8
    assert plan.smem == ssd_ops.smem_bytes(item, plan.p_block, n,
                                           plan.stages, plan.per_cta)
    assert plan.smem <= ssd_ops.MAX_SMEM
    # no other head_dim block takes fewer waves of the card
    def waves(q):
        return -(-q.ctas // (ssd_ops.SMS * ssd_ops.ctas_per_sm(q.smem,
                                                               q.p_block)))
    for pb in ssd_ops.P_BLOCKS:
        if p % pb == 0:
            assert waves(plan) <= waves(ssd_ops.ssd_plan(b, l, h, p, n, dtype,
                                                         p_block=pb))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 8])
def test_ssd_plan_fills_the_card_at_the_serving_prefill(b, dtype):
    for l in (244, 256):
        plan = ssd_ops.ssd_plan(b, l, 24, 64, 128, dtype)
        assert plan.ctas >= ssd_ops.SMS
        assert plan.cluster == 4 and plan.per_cta == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [16, 48, 64, 128])
def test_ssd_plan_fits_shared_memory_at_every_state_size(p, dtype):
    for n in range(8, 257, 8):
        for l in (1, 256, 1024, 8192):
            plan = ssd_ops.ssd_plan(1, l, 24, p, n, dtype)
            assert plan.smem <= ssd_ops.MAX_SMEM
    # the layout: staged B, C, x in the input dtype, the states in fp32
    assert ssd_ops.smem_bytes(4, 32, 128, 1, 2) == (
        2 * 64 * 136 * 4 + 64 * 32 * 4 + 2 * 64 * 4 + 64 * 36 * 4 + 64 * 4
        + 2 * 32 * 136 * 4 + 16)
    assert (ssd_ops.smem_bytes(2, 32, 128, 2, 2) - ssd_ops.smem_bytes(
        2, 32, 128, 1, 2) == 2 * 64 * 136 * 2 + 64 * 32 * 2 + 2 * 64 * 4)
    # one sub-chunk a CTA: the carried state in the staged B's place, where
    # it fits (f32 up to 64 columns, bf16 up to 32)
    for item, pb, fits in ((4, 64, True), (4, 32, True), (2, 32, True),
                           (2, 64, False)):
        saved = (ssd_ops.smem_bytes(item, pb, 128, 1, 2)
                 - ssd_ops.smem_bytes(item, pb, 128, 1, 1))
        assert saved == (pb * 136 * 4 if fits else 0)


def test_ssd_plan_takes_forced_choices_and_refuses_the_rest():
    plan = ssd_ops.ssd_plan(1, 513, 24, 64, 128, torch.float32,
                            max_cluster=2, p_block=16, stages=1)
    assert (plan.cluster, plan.per_cta, plan.p_block, plan.stages) == (
        2, 5, 16, 1)
    for kw in (dict(p_block=48), dict(max_cluster=9), dict(max_cluster=0),
               dict(stages=3)):
        with pytest.raises(ValueError):
            ssd_ops.ssd_plan(1, 256, 24, 64, 128, torch.float32, **kw)
    for p, n in ((24, 128), (64, 12), (64, 264), (64, 0)):
        with pytest.raises(ValueError, match="multiple of"):
            ssd_ops.ssd_plan(1, 256, 24, p, n, torch.float32)


def test_fwd_fused_runs_row_col_lses_launches():
    """One C signature (the tile edge passed in), one plan: the fused
    forward allocates ``lse_plan``'s scratch, 4 · ⌈B/T⌉ · B floats, and no
    64-tile forward is left."""
    sig = cl_ops.LIB.signatures
    assert sig["repro_contrastive_fwd"] == sig[
        "repro_contrastive_row_col_lse"]
    assert not hasattr(cl_ops, "FWD_TILE")
    for b in (2048, 1000):
        plan = cl_ops.lse_plan(b)
        assert plan.scratch_floats == 4 * plan.tiles * b
    with open(cl_ops.LIB.source) as f:
        text = f.read()
    assert "contrastive_fwd_tile_kernel" not in text
    assert "contrastive_fwd_combine_kernel" not in text
