"""The two redesigned forward kernels, on the CPU: their launch plans (pure
host arithmetic), the plain flash forward's bf16 rounding of p, and the
build cache's hash over the headers a kernel source includes.

- ``contrastive_loss.ops.lse_plan`` picks ``row_col_lse``'s tile edge
  (128, or 64 / 32 where 128 would leave SMs idle); the tiles cover B and
  the scratch is 4 · ⌈B/T⌉ · B floats.
- ``flash_attention.ops.fwd_plan`` picks the bf16 kernel's warps (16 query
  rows each) and key tile; f32 needs no plan.
- ``flash_fwd_ref`` rounds p to bf16 for bf16 inputs, as the tensor-core
  kernel does; its f32 output is the unrounded formula, bit for bit, and
  its bf16 output still matches the reference's Pallas forward (interpret
  mode) at the port's bf16 parity tolerance (2e-2,
  tests/test_torch_attention.py).
- ``KernelLibrary.path`` changes when an included ``csrc`` header changes.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_fwd_bh
from repro_torch.kernels import build
from repro_torch.kernels.contrastive_loss import ops as cl_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
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


@pytest.mark.parametrize("bh,s,t,d,warps,key_tile,blocks", [
    (3072, 196, 196, 64, 4, 64, 4),    # image tower, training microbatch
    (192, 196, 196, 64, 4, 64, 4),     # image tower, serving
    (4096, 16, 16, 64, 1, 16, 1),      # text tower, training microbatch
    (1024, 16, 16, 64, 1, 16, 1),      # text tower, serving
    (32, 512, 512, 64, 4, 64, 8),      # Llama-3.2-1B prefill
    (16, 200, 200, 128, 4, 64, 4),     # head dim 128
    (6, 1, 1, 64, 1, 16, 1),           # one token
    (8, 40, 40, 64, 3, 48, 1),
    (8, 70, 33, 64, 4, 48, 2)])
def test_flash_fwd_plan(bh, s, t, d, warps, key_tile, blocks):
    plan = fa_ops.fwd_plan(bh, s, t, d, torch.bfloat16)
    assert (plan.warps, plan.key_tile) == (warps, key_tile)
    assert plan.grid == (bh, blocks)
    assert 16 * plan.warps * blocks >= s
    assert fa_ops.fwd_plan(bh, s, t, d, torch.float32).warps == 0


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
