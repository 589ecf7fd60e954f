"""The training path's CUDA kernels against their plain PyTorch versions, on
the card: the flash-attention backward, the fused contrastive forward and
backward, one GradAccum step and one phase-1 pretraining step (f32 and
bf16) on the kernel path against the plain path, and the frozen image
tower of phase 2 against its closed form.
Every test here needs a CUDA card and the CUDA toolkit; on a host without a
card they skip (the card is looked for inside a fixture, never at import).
Run them on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_train.py

Tolerances, each with its reason:
- flash backward f32: 2e-4 abs, the reference's own gradient tolerance
  (tests/test_attention_backends.py); both sides accumulate fp32 in another
  order, and the kernel's products are split 3×TF32 (about 2^-21 of each
  product; tests/test_torch_tf32_split.py).
- flash backward bf16, per element: 2 bf16 ulps of |ref| (2^-7 relative
  each) plus 1e-3 of the tensor's max |ref|. Both sides accumulate in fp32
  and round the same value to bf16, so an element moves by at most the ulp
  of a rounding-boundary crossing; the 1e-3·max term covers elements near
  zero, where fp32 sums in another order cancel. The gradients are ~0.1
  rms at N(0, 1) inputs, so the reference's 1e-1 abs (kept in the CPU
  tests against JAX) would let a bf16-only fault through. Plus 1e-5 abs
  for gradients that are zero by cancellation (one token: ds = dout·v −
  delta = 0), where both sides keep fp32 rounding residue (~1e-7) in
  another order.
- contrastive LSE: 5e-5 abs (fp32 sums of 2048 exponentials of values up
  to ~15 in another order); dX / dY 1e-6 abs and dlog_tau 1e-4 rel, the
  reference's (tests/test_kernels.py). Under bf16 inputs dX / dY within
  2^-6 of the tensor's max |ref| (|dX| ~ 3e-4 at unit rows, so an absolute
  2e-2 would pass any fault; dA rounds to bf16 on both sides) and
  dlog_tau 2e-2 rel.
"""
import pytest
import torch

from repro_torch.kernels.contrastive_loss import ops as cl_ops
from repro_torch.kernels.contrastive_loss.ref import (bwd_fused_ref,
                                                      contrastive_grads_ref,
                                                      fwd_fused_ref, loss_ref)
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import (NEG_INF, flash_bwd_ref,
                                                     flash_fwd_ref)

pytestmark = pytest.mark.cuda

BF16_ULP = 2.0 ** -7


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.device import resolve_device
    resolve_device("cuda")
    return torch.Generator(device="cuda").manual_seed(0)


def _close(got, ref, dtype):
    err = (got.float() - ref.float()).abs()
    if dtype == torch.float32:
        return bool((err <= 2e-4).all()), float(err.max())
    r = ref.float().abs()
    lim = 2 * BF16_ULP * r + 1e-3 * r.max() + 1e-5
    return bool((err <= lim).all()), float(err.max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kv,s,d,causal,window,padded", [
    (4, 12, 12, 196, 64, False, None, False),    # image tower, ragged s
    (16, 16, 16, 16, 64, False, None, True),     # text tower, padding bias
    (2, 8, 2, 200, 128, False, None, True),      # GQA group 4, head dim 128
    (2, 4, 4, 131, 64, True, None, False),
    (2, 4, 4, 131, 64, True, 40, False),
    (3, 2, 2, 1, 64, False, None, False),        # one token
    # the bf16 kernel's edges (ops.bwd_plan): 4 warps up to t 64, one
    # 256-key block at d 64 up to t 256, split keys with dq partials past it
    (2, 4, 4, 64, 64, False, None, True),
    (2, 4, 4, 65, 64, False, None, True),
    (1, 4, 4, 256, 64, True, None, False),
    (1, 4, 4, 257, 64, True, None, False),
    (1, 4, 1, 300, 64, False, 70, False),        # GQA 4, split, window
    (2, 8, 2, 64, 128, True, None, False),       # d 128, GQA 4, 4 warps
    (1, 8, 2, 131, 128, True, 40, False),        # d 128, GQA 4, split
])
def test_flash_bwd_kernel_matches_plain(gen, b, h, kv, s, d, causal, window,
                                        padded, dtype):
    bh, bkv = b * h, b * kv
    q = torch.randn((bh, s, d), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((bkv, s, d), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    dout = torch.randn((bh, s, d), generator=gen, device="cuda").to(dtype)
    bias = None
    if padded:
        lens = torch.randint(1, s + 1, (b,), generator=gen, device="cuda")
        bias = torch.where(torch.arange(s, device="cuda")[None, :]
                           < lens[:, None], 0.0, NEG_INF).float()
    out, lse = flash_fwd_ref(q, k, v, bias, causal=causal, window=window)
    before = fa_ops.BWD_COUNTER.count
    got = fa_ops.flash_bwd(q, k, v, bias, out, lse, dout, causal=causal,
                           window=window)
    assert fa_ops.BWD_COUNTER.count == before + 1
    ref = flash_bwd_ref(q, k, v, bias, out, lse, dout, causal=causal,
                        window=window)
    torch.cuda.synchronize()
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == dtype and g.shape == r.shape, name
        ok, err = _close(g, r, dtype)
        assert ok, f"{name}: max abs err {err:.3g}"


@pytest.mark.parametrize("b,h,kv,s,t,d,causal,window,padded", [
    (2, 4, 4, 1, 1, 64, False, None, False),          # one token
    (2, 4, 1, 7, 7, 128, False, None, True),          # GQA 4, d 128
    (2, 4, 4, 8, 8, 64, True, None, False),
    (2, 8, 2, 9, 9, 64, False, None, True),
    (2, 4, 4, 15, 15, 128, True, 4, False),
    (2, 4, 1, 16, 16, 64, False, None, True),         # text tower, GQA 4
    (2, 4, 4, 17, 17, 64, True, None, True),
    (2, 12, 12, 196, 196, 64, False, None, False),    # image: 13 warps
    (1, 8, 2, 208, 208, 64, True, None, False),       # one 208-key block
    (1, 8, 2, 209, 209, 64, True, None, False),       # split, dq partials
    (1, 4, 4, 96, 96, 128, False, None, True),        # one 96-key block
    (1, 8, 2, 257, 257, 128, True, None, False),      # d 128, split
    (1, 8, 2, 520, 520, 64, True, 100, False),        # split, window
    (2, 4, 4, 9, 17, 64, False, None, True),          # s != t
    (2, 4, 4, 17, 9, 128, False, None, False),
    (1, 4, 1, 196, 520, 64, False, None, True),
])
def test_flash_bwd_f32_kernel_matches_plain_at_its_edges(
        gen, b, h, kv, s, t, d, causal, window, padded):
    """The split 3×TF32 backward at the edges of its tiling (16-key warps,
    32-row q tiles, key blocks of up to 208 / 96 keys, dq partials past
    them), GQA groups 1 and 4, head dims 64 and 128, causal, windowed and
    bias masks: dq, dk, dv within 2e-4 of the plain fp32 version."""
    q, dout = (torch.randn((b * h, s, d), generator=gen, device="cuda")
               for _ in range(2))
    k, v = (torch.randn((b * kv, t, d), generator=gen, device="cuda")
            for _ in range(2))
    bias = None
    if padded:
        lens = torch.randint(1, t + 1, (b,), generator=gen, device="cuda")
        bias = torch.where(torch.arange(t, device="cuda")[None, :]
                           < lens[:, None], 0.0, NEG_INF).float()
    out, lse = flash_fwd_ref(q, k, v, bias, causal=causal, window=window)
    before = fa_ops.BWD_COUNTER.count
    got = fa_ops.flash_bwd(q, k, v, bias, out, lse, dout, causal=causal,
                           window=window)
    assert fa_ops.BWD_COUNTER.count == before + 1
    ref = flash_bwd_ref(q, k, v, bias, out, lse, dout, causal=causal,
                        window=window)
    torch.cuda.synchronize()
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.dtype == torch.float32 and g.shape == r.shape, name
        ok, err = _close(g, r, torch.float32)
        assert ok, f"{name}: max abs err {err:.3g}"


@pytest.mark.parametrize("causal", [False, True])
def test_flash_bwd_f32_kernel_one_key_rows(gen, causal):
    """Rows with one valid key (key padding to length 1, or the first row
    under a causal mask): p = 1 and ds = p·(dout·v − delta) cancels to
    fp32 rounding residue on both sides; the split 3×TF32 products keep
    dq, dk, dv within 2e-4 of the plain version."""
    b, h, s, d = 3, 4, 196, 64
    q, dout = (torch.randn((b * h, s, d), generator=gen, device="cuda")
               for _ in range(2))
    k, v = (torch.randn((b * h, s, d), generator=gen, device="cuda")
            for _ in range(2))
    bias = None
    if not causal:   # every row of example 0 keeps key 0 alone
        lens = torch.tensor([1, 5, s], device="cuda")
        bias = torch.where(torch.arange(s, device="cuda")[None, :]
                           < lens[:, None], 0.0, NEG_INF).float()
    out, lse = fa_ops.flash_fwd(q, k, v, bias, causal=causal)
    got = fa_ops.flash_bwd(q, k, v, bias, out, lse, dout, causal=causal)
    ref = flash_bwd_ref(q, k, v, bias, out, lse, dout, causal=causal)
    torch.cuda.synchronize()
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        ok, err = _close(g, r, torch.float32)
        assert ok, f"{name}: max abs err {err:.3g}"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,d,kv", [(196, 64, 12), (300, 64, 3),
                                    (131, 128, 3)])
def test_flash_bwd_kernel_repeats_bit_for_bit(gen, s, d, kv, dtype):
    """No atomics: two calls on the same inputs give the same bits, on the
    one-block and the split (dq partials) paths alike."""
    q, dout = (torch.randn((12, s, d), generator=gen, device="cuda")
               .to(dtype) for _ in range(2))
    k, v = (torch.randn((kv, s, d), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    out, lse = flash_fwd_ref(q, k, v, None, causal=False)
    first = fa_ops.flash_bwd(q, k, v, None, out, lse, dout, causal=False)
    second = fa_ops.flash_bwd(q, k, v, None, out, lse, dout, causal=False)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_flash_attention_trains_through_the_kernels(gen):
    """autograd through ``flash_attention`` launches forward and backward
    kernels and matches autograd of the plain forward."""
    q, k, v = (torch.randn((2, 4, 37, 64), generator=gen, device="cuda",
                           requires_grad=True) for _ in range(3))
    mask = torch.arange(37, device="cuda")[None, :] < torch.tensor(
        [[37], [9]], device="cuda")
    f0, b0 = fa_ops.COUNTER.count, fa_ops.BWD_COUNTER.count
    out = fa_ops.flash_attention(q, k, v, causal=False, key_mask=mask)
    got = torch.autograd.grad(out.square().sum(), (q, k, v))
    assert fa_ops.COUNTER.count == f0 + 1
    assert fa_ops.BWD_COUNTER.count == b0 + 1
    bias = fa_ops.key_bias(mask)
    ref_out, _ = flash_fwd_ref(q.reshape(8, 37, 64), k.reshape(8, 37, 64),
                               v.reshape(8, 37, 64), bias, causal=False)
    ref = torch.autograd.grad(ref_out.square().sum(), (q, k, v))
    for g, r in zip(got, ref):
        assert float((g - r).abs().max()) <= 2e-4


def _unit(n, d, gen, dtype):
    x = torch.randn((n, d), generator=gen, device="cuda")
    return (x / x.norm(dim=1, keepdim=True)).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,d", [(2048, 512), (1000, 512), (64, 24),
                                 (1, 32), (130, 200), (1, 24), (130, 1024),
                                 (1000, 24), (300, 1024)])
def test_contrastive_kernels_match_plain(gen, b, d, dtype):
    x, y = _unit(b, d, gen, dtype), _unit(b, d, gen, dtype)
    inv_tau = torch.tensor(1 / 0.07, device="cuda")
    f0, b0 = cl_ops.FWD_COUNTER.count, cl_ops.BWD_COUNTER.count
    row, col = cl_ops.fwd_fused(x, y, inv_tau)
    ref_row, ref_col = fwd_fused_ref(x, y, inv_tau)
    dx, dy, dt = cl_ops.bwd_fused(x, y, inv_tau, ref_row, ref_col)
    ref_dx, ref_dy, ref_dt = bwd_fused_ref(x, y, inv_tau, ref_row, ref_col)
    torch.cuda.synchronize()
    assert cl_ops.FWD_COUNTER.count == f0 + 1
    assert cl_ops.BWD_COUNTER.count == b0 + 1
    assert float((row - ref_row).abs().max()) <= 5e-5
    assert float((col - ref_col).abs().max()) <= 5e-5
    for got, ref in ((dx, ref_dx), (dy, ref_dy)):
        gtol = (1e-6 if dtype == torch.float32
                else 2.0 ** -6 * float(ref.abs().max()))
        assert float((got - ref).abs().max()) <= gtol
    assert abs(float(dt - ref_dt)) <= (1e-4 if dtype == torch.float32
                                       else 2e-2) * abs(float(ref_dt)) + 1e-6


@pytest.mark.parametrize("b_norm,with_diag", [(4096, False), (3000, True)])
def test_contrastive_bwd_kernel_chunk_arguments(gen, b_norm, with_diag):
    x, y = _unit(256, 64, gen, torch.float32), _unit(256, 64, gen,
                                                     torch.float32)
    inv_tau = torch.tensor(1 / 0.07, device="cuda")
    row, col = fwd_fused_ref(x, y, inv_tau)
    got = cl_ops.bwd_fused(x, y, inv_tau, row, col, b_norm=b_norm,
                           with_diag=with_diag)
    ref = bwd_fused_ref(x, y, inv_tau, row, col, b_norm=b_norm,
                        with_diag=with_diag)
    assert float((got[0] - ref[0]).abs().max()) <= 1e-6
    assert float((got[1] - ref[1]).abs().max()) <= 1e-6
    assert abs(float(got[2] - ref[2])) <= 1e-4 * abs(float(ref[2])) + 1e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,d", [(2048, 512), (1000, 200), (130, 1024)])
def test_contrastive_bwd_kernel_repeats_bit_for_bit(gen, b, d, dtype):
    """No atomics: the sliced partials and the dlog_tau partials are summed
    in a fixed order, so two calls give the same bits."""
    x, y = _unit(b, d, gen, dtype), _unit(b, d, gen, dtype)
    inv_tau = torch.tensor(1 / 0.07, device="cuda")
    row, col = fwd_fused_ref(x, y, inv_tau)
    first = cl_ops.bwd_fused(x, y, inv_tau, row, col)
    second = cl_ops.bwd_fused(x, y, inv_tau, row, col)
    torch.cuda.synchronize()
    for a, b_ in zip(first, second):
        assert torch.equal(a, b_)


def test_fused_contrastive_loss_value_and_grads(gen):
    x, y = _unit(300, 128, gen, torch.float32), _unit(300, 128, gen,
                                                      torch.float32)
    lt = torch.tensor(-0.9, device="cuda")
    xr, yr, ltr = (t.clone().requires_grad_() for t in (x, y, lt))
    loss = cl_ops.fused_contrastive_loss(xr, yr, ltr)
    gx, gy, gt = torch.autograd.grad(loss, (xr, yr, ltr))
    assert abs(float(loss.detach() - loss_ref(x, y, lt))) <= 1e-5
    rx, ry, rt = contrastive_grads_ref(x, y, lt)
    assert float((gx - rx).abs().max()) <= 1e-6
    assert float((gy - ry).abs().max()) <= 1e-6
    assert abs(float(gt - rt)) <= 1e-4 * abs(float(rt)) + 1e-6


def test_kernels_refuse_what_they_do_not_take(gen):
    x = _unit(8, 1100, gen, torch.float32)
    row, col = fwd_fused_ref(x, x, 1.0)
    with pytest.raises(ValueError, match="D <="):
        cl_ops.bwd_fused(x, x, 1.0, row, col)
    with pytest.raises(TypeError):
        cl_ops.fwd_fused(x.half(), x.half(), 1.0)
    q = torch.randn((4, 8, 64), device="cuda")
    out, lse = flash_fwd_ref(q, q, q)
    with pytest.raises(ValueError, match="contiguous"):
        fa_ops.flash_bwd(q, q, q, None, out, lse,
                         q.transpose(0, 1).contiguous().transpose(0, 1))
    qb = torch.randn((4 * 8 * 64 + 1,), device="cuda").to(torch.bfloat16)
    qb = qb[1:].view(4, 8, 64)                     # starts 2 bytes in
    out, lse = flash_fwd_ref(qb, qb, qb)
    with pytest.raises(ValueError, match="aligned"):
        fa_ops.flash_bwd(qb, qb, qb, None, out, lse, out)


def test_gradaccum_step_kernel_path_matches_plain_path(gen):
    """One GradAccum step at smoke size on the card: flash attention and
    the fused loss against materialised attention and loss, from the same
    weights and batch (f32; gradients within 1e-3 of each leaf's scale:
    fp32 sums in another order through every layer's backward)."""
    import dataclasses

    import numpy as np

    from repro_torch import interop
    from repro_torch.configs import get_arch, smoke_dual_variant
    from repro_torch.core.contrastive import (contrastive_loss,
                                              fused_kernel_loss)
    from repro_torch.core.gradaccum import contrastive_step
    from repro_torch.core.remat import get_policy
    from repro_torch.data import (contrastive_batch, load_tokenizer,
                                  world_for_tower)
    from repro_torch.launch.train import batch_to
    from repro_torch.models import dual_encoder as de

    cfg = smoke_dual_variant(get_arch("basic-s"))
    rng = np.random.default_rng(0)
    world = world_for_tower(rng, cfg.image_tower, n_classes=16)
    batch = batch_to(contrastive_batch(world, load_tokenizer(), 16, rng)[0],
                     "cuda")
    params = interop.init_params(cfg, torch.Generator().manual_seed(0),
                                 "cuda")
    out = {}
    counts = {}
    for path, attn, loss_fn in (("kernel", "pallas", fused_kernel_loss),
                                ("plain", "naive", contrastive_loss)):
        pcfg = dataclasses.replace(
            cfg, image_tower=dataclasses.replace(cfg.image_tower,
                                                 attn_impl=attn),
            text_tower=dataclasses.replace(cfg.text_tower, attn_impl=attn))
        before = [c.count for c in (fa_ops.COUNTER, fa_ops.BWD_COUNTER,
                                    cl_ops.FWD_COUNTER, cl_ops.BWD_COUNTER)]
        loss, _, grads = contrastive_step(
            lambda p, im: de.encode_image(pcfg, p, im, precision="f32",
                                          remat_policy=get_policy("basic")),
            lambda p, tx: de.encode_text(pcfg, p, tx, precision="f32",
                                         remat_policy=get_policy("basic")),
            params, batch, 2, loss_fn=loss_fn)
        counts[path] = [c.count - b for c, b in zip(
            (fa_ops.COUNTER, fa_ops.BWD_COUNTER, cl_ops.FWD_COUNTER,
             cl_ops.BWD_COUNTER), before)]
        out[path] = (float(loss), dict(interop.leaves(grads)))
    assert all(n > 0 for n in counts["kernel"]), counts
    assert counts["plain"] == [0, 0, 0, 0]
    assert abs(out["kernel"][0] - out["plain"][0]) <= 1e-4
    for path, g in out["plain"][1].items():
        err = (out["kernel"][1][path] - g).abs().max()
        assert float(err) <= 1e-3 * float(g.abs().max()) + 1e-12, path


def _pretrain_loss_and_grads(icfg, params, batch, precision, attn):
    """Phase 1's loss (``launch.steps.make_pretrain_step``) and its
    gradients by autograd, with both towers' attention on ``attn``."""
    import dataclasses

    from repro_torch.core.remat import get_policy
    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_leaves, tree_map
    cfg = dataclasses.replace(icfg, attn_impl=attn)
    live = tree_map(lambda x: x.detach().requires_grad_(), params)
    h = tf.encode(cfg, live["tower"], {"image": batch["image"]},
                  precision=precision, remat_policy=get_policy("basic"))
    logp = torch.log_softmax((h @ live["head"].to(h.dtype)).float(), dim=-1)
    loss = -torch.mean(torch.gather(logp, 1, batch["labels"].long()[:, None]))
    leaves = tree_leaves(live)
    return float(loss.detach()), torch.autograd.grad(loss, leaves)


# pretrain step, kernel path vs plain path on the card: f32 at the training
# parity limits of chip_smoke.py (loss 1e-4 abs; each gradient leaf within
# 1e-3 of its largest entry: fp32 sums in another order through every
# layer's backward). bf16: the plain path rounds the scores q·kᵀ to bf16
# and the kernel path p, each ~2^-8 relative, in every layer forward and
# backward. Read on the H100 (scripts/pretrain_tol_probe.py): bf16 sound
# 7.7e-5 relative loss, 8.2e-3 of the leaf max; a causal mask planted in
# both kernels 1.0e-2 and 0.74; the backward's softmax weights 5% small
# 7.7e-5 (the forward is sound) and 8.1e-2. The limits sit between: loss
# 1e-3 relative, gradients 2.5e-2 of each leaf's largest entry
PRETRAIN_TOL = {"f32": (1e-4, 0.0, 1e-3), "bf16": (0.0, 1e-3, 2.5e-2)}


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_pretrain_step_kernel_path_matches_plain_path(gen, precision):
    """Phase 1's step at smoke size on the card: the flash kernels against
    materialised attention, from the same weights and labelled batch."""
    import numpy as np

    from repro_torch.configs import get_arch, smoke_dual_variant
    from repro_torch.data import jft_batch, world_for_tower
    from repro_torch.launch.steps import make_pretrain_step
    from repro_torch.launch.train import batch_to, init_pretrain_params

    icfg = smoke_dual_variant(get_arch("basic-s")).image_tower
    rng = np.random.default_rng(0)
    world = world_for_tower(rng, icfg, n_classes=16)
    batch = batch_to(jft_batch(world, 16, rng)[0], "cuda")
    params = init_pretrain_params(icfg, 16, torch.Generator().manual_seed(0),
                                  "cuda")
    out, counts = {}, {}
    for path, attn in (("kernel", "pallas"), ("plain", "naive")):
        before = [c.count for c in (fa_ops.COUNTER, fa_ops.BWD_COUNTER)]
        step, opt = make_pretrain_step(icfg, lr=1e-3, precision=precision,
                                       attn=attn)
        new, state, loss, _ = step(params, opt.init(params), batch)
        counts[path] = [c.count - b for c, b in zip(
            (fa_ops.COUNTER, fa_ops.BWD_COUNTER), before)]
        ref_loss, grads = _pretrain_loss_and_grads(icfg, params, batch,
                                                   precision, attn)
        assert float(loss) == ref_loss
        assert int(state.step) == 1
        assert not torch.equal(new["head"], params["head"])
        out[path] = (ref_loss, grads)
    assert all(n > 0 for n in counts["kernel"]), counts
    assert counts["plain"] == [0, 0]
    loss_abs, loss_rel, grad_rel = PRETRAIN_TOL[precision]
    (lk, gk), (lp, gp) = out["kernel"], out["plain"]
    assert abs(lk - lp) <= loss_abs + loss_rel * abs(lp), (lk, lp)
    for i, (a, b) in enumerate(zip(gk, gp)):
        err = float((a.float() - b.float()).abs().max())
        assert err <= grad_rel * float(b.abs().max()) + 1e-12, (i, err)


def test_frozen_image_tower_decays_by_the_closed_form(gen):
    """Two phase-2 steps at smoke size on the kernel path (flash, fused
    loss, bf16): the image tower equals p·Π(1 − lr_t·wd) within fp32
    rounding (1e-6), while the projection, the text tower and log_tau
    train."""
    import math

    import numpy as np

    from repro_torch import interop
    from repro_torch.configs import get_arch, smoke_dual_variant
    from repro_torch.data import (contrastive_batch, load_tokenizer,
                                  world_for_tower)
    from repro_torch.launch.steps import make_contrastive_step
    from repro_torch.launch.train import batch_to
    from repro_torch.optim import warmup_cosine

    cfg = smoke_dual_variant(get_arch("basic-s"))
    rng = np.random.default_rng(0)
    world = world_for_tower(rng, cfg.image_tower, n_classes=16)
    tok = load_tokenizer()
    params = interop.init_params(cfg, torch.Generator().manual_seed(0),
                                 "cuda")
    lr = warmup_cosine(1e-3, 1e-5, 1, 2)
    step, opt = make_contrastive_step(cfg, num_micro=2, lr=lr, attn="pallas",
                                      loss="fused", freeze_image=True)
    p, state = params, opt.init(params)
    before = cl_ops.BWD_COUNTER.count
    for _ in range(2):
        batch = batch_to(contrastive_batch(world, tok, 16, rng)[0], "cuda")
        p, state, loss, _ = step(p, state, batch)
        assert math.isfinite(float(loss))
    assert cl_ops.BWD_COUNTER.count - before == 2
    factor = math.prod(1.0 - float(lr(t)) * 0.0025 for t in range(2))
    for (path, got), (_, p0) in zip(interop.leaves(p["image"]["tower"]),
                                    interop.leaves(params["image"]["tower"])):
        want = p0.double() * factor
        err = float((got.double() - want).abs().max())
        assert err <= 1e-6 * float(want.abs().max()), (path, err)
    for part in (p["image"]["proj"], p["text"]["proj"], p["log_tau"]):
        assert part.isfinite().all()
    assert not torch.equal(p["image"]["proj"], params["image"]["proj"])
    assert not torch.equal(p["text"]["tower"]["embed"],
                           params["text"]["tower"]["embed"])
    assert not torch.equal(p["log_tau"], params["log_tau"])
