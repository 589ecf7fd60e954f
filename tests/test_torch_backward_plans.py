"""The training step's two backward kernels, on the CPU: their launch plans
(pure host arithmetic) and the plain flash backward's bf16 operand rounding.

- ``contrastive_loss.ops.bwd_plan`` cuts the other rows into slices so the
  two sweeps fill the card; the scratch it asks for stays within
  ``MAX_SLICES`` × (dX + dY) plus one dlog_tau partial per dX CTA, no slice
  is empty, and ``bwd_buffers`` (what the wrapper allocates) matches it.
- ``flash_attention.ops.bwd_plan`` picks the kernels' key block and the dq
  partials past one block: bf16 64 or 256 (128 at d 128) keys, f32 (the
  split 3×TF32 kernel) t rounded up to 16 keys, at most 208 at d 64 and
  96 at d 128.
- ``flash_bwd_ref`` rounds p and ds to bf16 for bf16 inputs, as the
  tensor-core kernel does; its f32 output is the unrounded formula, bit for
  bit, and its bf16 output still matches the reference's blockwise Pallas
  backward (interpret mode) at the reference's bf16 gradient tolerance
  (1e-1, tests/test_attention_backends.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_bwd_bh, flash_fwd_bh
from repro_torch.kernels.contrastive_loss import ops as cl_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import (NEG_INF, _scores,
                                                     flash_bwd_ref,
                                                     flash_fwd_ref)

torch.set_num_threads(1)


@pytest.mark.parametrize("b", [1, 130, 1000, 2048, 8192, 65536])
@pytest.mark.parametrize("d", [24, 512, 1024])
def test_contrastive_bwd_plan_bounds_its_scratch(b, d):
    plan = cl_ops.bwd_plan(b, d)
    tiles = -(-b // cl_ops.BWD_TILE)
    assert plan.blocks == -(-b // cl_ops.BWD_ROWS)
    assert 1 <= plan.slices <= min(tiles, cl_ops.MAX_SLICES)
    # every slice holds at least one 128-row tile and together they hold all
    assert (plan.slices - 1) * plan.tiles_per_slice < tiles
    assert plan.slices * plan.tiles_per_slice >= tiles
    assert plan.grid == (plan.blocks, 2, plan.slices)
    assert plan.dtau_floats == plan.blocks * plan.slices
    assert plan.partial_floats == (0 if plan.slices == 1
                                   else plan.slices * 2 * b * d)
    assert plan.partial_floats <= cl_ops.MAX_SLICES * 2 * b * d
    # at least a full wave of one CTA per SM where the other rows allow it
    ctas = 2 * plan.blocks * plan.slices
    assert ctas >= cl_ops.SMS or plan.slices == min(tiles,
                                                    cl_ops.MAX_SLICES)


def test_contrastive_bwd_plan_at_the_main_shapes():
    assert cl_ops.bwd_plan(2048, 512).grid == (64, 2, 3)
    assert cl_ops.bwd_plan(8192, 1024).slices == 1       # no partials
    assert cl_ops.bwd_plan(8192, 1024).scratch_floats == 256
    assert cl_ops.bwd_plan(1, 32).scratch_floats == 1


@pytest.mark.parametrize("b,d", [(1, 24), (1000, 512), (2048, 1024)])
def test_contrastive_bwd_buffers_are_what_the_plan_says(b, d):
    plan, dx, dy, dtau, part = cl_ops.bwd_buffers(b, d, "cpu")
    assert plan == cl_ops.bwd_plan(b, d)
    assert dx.shape == dy.shape == (b, d) and dtau.shape == ()
    assert part.shape == (plan.scratch_floats,)
    assert all(t.dtype == torch.float32 for t in (dx, dy, dtau, part))


@pytest.mark.parametrize("t,d,block,blocks", [
    (1, 64, 64, 1), (16, 64, 64, 1), (64, 64, 64, 1), (65, 64, 256, 1),
    (196, 64, 256, 1), (256, 64, 256, 1), (257, 64, 256, 2),
    (8192, 64, 256, 32), (64, 128, 64, 1), (65, 128, 128, 1),
    (200, 128, 128, 2), (64, 80, 64, 1), (65, 80, 160, 1),
    (160, 80, 160, 1), (161, 80, 160, 2), (4096, 80, 160, 26)])
def test_flash_bwd_plan(t, d, block, blocks):
    bh, s = 24, 300
    plan = fa_ops.bwd_plan(bh, s, t, d, torch.bfloat16)
    assert (plan.key_block, plan.key_blocks) == (block, blocks)
    assert plan.dq_part_floats == (0 if blocks == 1
                                   else blocks * bh * s * d)
    # f32: t in 16-key steps up to the largest block that fits
    f32 = fa_ops.bwd_plan(bh, s, t, d, torch.float32)
    assert f32.key_block == min(-(-t // 16) * 16,
                                fa_ops.F32_MAX_KEY_BLOCK[d])
    assert f32.key_blocks * f32.key_block >= t > (f32.key_blocks - 1) * \
        f32.key_block


@pytest.mark.parametrize("t,d,block,blocks", [
    (1, 64, 16, 1), (16, 64, 16, 1), (196, 64, 208, 1), (200, 64, 208, 1),
    (208, 64, 208, 1), (209, 64, 208, 2), (520, 64, 208, 3),
    (8704, 64, 208, 42), (1, 128, 16, 1), (16, 128, 16, 1),
    (96, 128, 96, 1), (97, 128, 96, 2), (196, 128, 96, 3),
    (200, 128, 96, 3), (520, 128, 96, 6), (8704, 128, 96, 91),
    (1, 80, 16, 1), (160, 80, 160, 1), (161, 80, 160, 2),
    (4096, 80, 160, 26)])
def test_flash_bwd_f32_plan(t, d, block, blocks):
    """The split 3×TF32 backward: one block holds a tower head's keys
    (the image tower's 196 in 208, 13 warps) and writes dq itself; past 208
    keys at d 64 (160 at d 80, 96 at d 128) the keys split, with fp32 dq
    partials."""
    bh, s = 24, t
    plan = fa_ops.bwd_plan(bh, s, t, d, torch.float32)
    assert (plan.key_block, plan.key_blocks) == (block, blocks)
    assert plan.dq_part_floats == (0 if blocks == 1
                                   else blocks * bh * s * d)
    assert plan.smem <= fa_ops.SMEM_LIMIT


def _unrounded(q, k, v, bias, out, lse, dout, causal, window):
    """The backward formula with nothing rounded but the outputs."""
    bh, s, d = q.shape
    bkv, t = k.shape[0], k.shape[1]
    qf, kf, vf, scores = _scores(q, k, v, bias, causal, window)
    p = torch.exp(scores - lse.float()[..., None])
    do = dout.float()
    delta = torch.sum(do * out.float(), dim=-1)
    ds = p * (torch.matmul(do, vf.transpose(1, 2)) - delta[..., None])
    dq = torch.matmul(ds, kf) * (d ** -0.5)
    dk = torch.matmul(ds.transpose(1, 2), qf).reshape(bkv, -1, t, d).sum(1)
    dv = torch.matmul(p.transpose(1, 2), do).reshape(bkv, -1, t, d).sum(1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _flash_inputs(bh, bkv, s, d, dtype, padded, seed):
    rng = np.random.default_rng(seed)
    q, dout = (torch.tensor(rng.standard_normal((bh, s, d)).astype(
        np.float32)).to(dtype) for _ in range(2))
    k, v = (torch.tensor(rng.standard_normal((bkv, s, d)).astype(
        np.float32)).to(dtype) for _ in range(2))
    bias = None
    if padded:
        lens = np.maximum(1, rng.integers(1, s + 1, bh // 2))
        bias = torch.tensor(np.where(np.arange(s)[None, :] < lens[:, None],
                                     0.0, NEG_INF).astype(np.float32))
    return q, k, v, dout, bias


@pytest.mark.parametrize("causal,window,padded,group", [
    (False, None, True, 1), (True, None, False, 2), (True, 5, False, 1)])
def test_flash_bwd_ref_f32_is_the_unrounded_formula(causal, window, padded,
                                                    group):
    q, k, v, dout, bias = _flash_inputs(4, 4 // group, 21, 64,
                                        torch.float32, padded, 5)
    out, lse = flash_fwd_ref(q, k, v, bias, causal=causal, window=window)
    got = flash_bwd_ref(q, k, v, bias, out, lse, dout, causal=causal,
                        window=window)
    ref = _unrounded(q, k, v, bias, out, lse, dout, causal, window)
    for a, r in zip(got, ref):
        assert torch.equal(a, r)


def test_flash_bwd_ref_bf16_rounds_p_and_ds():
    """bf16: dv is pᵀ·dout with p rounded to bf16 (not the fp32 p)."""
    q, k, v, dout, _ = _flash_inputs(2, 2, 17, 64, torch.bfloat16, False, 6)
    out, lse = flash_fwd_ref(q, k, v, None, causal=False)
    _, _, dv = flash_bwd_ref(q, k, v, None, out, lse, dout, causal=False)
    *_, scores = _scores(q, k, v, None, False, None)
    p = torch.exp(scores - lse[..., None]).to(torch.bfloat16).float()
    want = torch.matmul(p.transpose(1, 2), dout.float()).to(torch.bfloat16)
    assert torch.equal(dv, want)
    unrounded = _unrounded(q, k, v, None, out, lse, dout, False, None)[2]
    assert not torch.equal(dv, unrounded)


@pytest.mark.parametrize("causal,window,padded", [
    (False, None, True), (True, None, False), (True, 6, False)])
def test_flash_bwd_ref_bf16_matches_reference_kernel(causal, window,
                                                     padded):
    bh, s, d = 4, 24, 64
    q, k, v, dout, bias = _flash_inputs(bh, bh, s, d, torch.bfloat16,
                                        padded, 8)
    jargs = [jnp.asarray(x.float().numpy(), jnp.bfloat16)
             for x in (q, k, v)]
    jbias = None if bias is None else jnp.asarray(
        np.repeat(bias.numpy(), 2, axis=0))
    tbias = None if bias is None else bias.repeat_interleave(2, dim=0)
    out, lse = flash_fwd_bh(*jargs, jbias, causal=causal, window=window,
                            block_q=8, block_k=8, interpret=True)
    ref = flash_bwd_bh(*jargs, jbias, out, lse,
                       jnp.asarray(dout.float().numpy(), jnp.bfloat16),
                       causal=causal, window=window, block_q=8, block_k=8,
                       interpret=True)
    got = flash_bwd_ref(q, k, v, tbias,
                        torch.tensor(np.asarray(out.astype(jnp.float32)))
                        .to(torch.bfloat16),
                        torch.tensor(np.asarray(lse)), dout, causal=causal,
                        window=window)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(r.astype(jnp.float32)),
                                   rtol=1e-1, atol=1e-1, err_msg=name)
