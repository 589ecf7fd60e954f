"""The MoE serving path's kernels on the card at Mixtral-8x22B's shapes, and
its MoE FFN at full width. Every test here needs a CUDA card and the CUDA
toolkit; on a host without a card they skip (the card is looked for inside
a fixture, never at import). Run them on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_moe.py

- ``flash_fwd`` at head dim 128, 48 query heads over 8 kv heads (a group
  of 6), causal with a window of 4096, over 512 tokens and over 4608
  (where the window masks), against its plain version.
- ``decode_attention`` at 8 slots, the same heads, over a linear cache of
  8192 and a ring of 4096, ragged lengths including 0: a group of 6 runs
  in the kernel's 8-head CTA group with two head slots idle.
- One Mixtral layer's ``moe_ffn`` at full width (d 6144, d_ff 16384, 8
  experts, top-2) on the card in f32 against the same call on the CPU in
  float64, dense and capacity dispatch.
- One f32 ``make_train_step`` (remat 'basic', capacity dispatch) of smoke
  Arctic with Arctic's GQA group of 7 (14 query heads over 2 kv heads)
  under the expert share (1, 2) of its 4 experts, on the kernel path
  (the flash kernels) against the plain path (chunked attention): the
  loss, every gradient leaf and every updated leaf; both flash kernels
  launched, the backward at group 7.

Tolerances, each with its reason:
- flash f32 5e-5 abs on out and lse (the kernel's products split 3×TF32:
  ~2^-21 of each; fp32 sums in another order); bf16 out 1.6e-2 (one bf16
  ulp at |out| < 2 where both sides round the same fp32 value).
- decode f32 2e-5 abs (the reference's); bf16 per element 2 bf16 ulps of
  |ref| plus 1e-3 of max |ref| (tests/test_torch_cuda_decode.py).
- The Arctic step (``chip_smoke.py``'s f32 training limits): the loss
  within 1e-4, each gradient leaf within 1e-3 of its largest entry, each
  updated leaf within 1e-3 of the change the step made.
- MoE f32 vs float64: 1e-5 of max |ref|. fp32 sums of 6144 and 16384
  products carry ~sqrt(K)·2^-24 ≈ 1e-5 relative error of the row's
  magnitude at worst in practice; a bf16 computation (2^-8) or TF32
  products (2^-11) would fail it. Tokens whose float64 router gap between
  the 2nd and 3rd probability is under 1e-6 are left out (fp32 may pick
  the other expert there); the capacity case holds every pair (cf = E/k),
  so tokens are independent.
"""
import dataclasses

import pytest
import torch

pytestmark = pytest.mark.cuda

BF16_ULP = 2.0 ** -7
H, KV, D, WINDOW = 48, 8, 128, 4096


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.device import resolve_device
    resolve_device("cuda")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [512, 4608])
def test_flash_fwd_at_mixtral_shape(gen, s, dtype):
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_fwd_ref
    q = torch.randn((H, s, D), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((KV, s, D), generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    out, lse = fa_ops.flash_fwd(q, k, v, causal=True, window=WINDOW)
    ref_out, ref_lse = flash_fwd_ref(q, k, v, causal=True, window=WINDOW)
    tol = 5e-5 if dtype == torch.float32 else 1.6e-2
    assert float((out.float() - ref_out.float()).abs().max()) <= tol
    assert float((lse - ref_lse).abs().max()) <= 5e-5
    if s > WINDOW:     # the window masks: the last query's lse differs
        full, _ = flash_fwd_ref(q, k, v, causal=True)
        assert float((full.float() - ref_out.float()).abs().max()) > 1e-2


def _decode_close(got, ref):
    if ref.dtype == torch.bfloat16:
        r = ref.float().abs()
        limit = 2 * BF16_ULP * r + 1e-3 * r.max()
    else:
        limit = torch.full_like(ref, 2e-5)
    err = (got.float() - ref.float()).abs()
    assert bool((err <= limit).all()), float(err.max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [8192, 4096])
def test_decode_attention_at_mixtral_shape(gen, t, dtype):
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    b = 8
    q = torch.randn((b, H, D), generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn((b, KV, t, D), generator=gen, device="cuda")
            .to(dtype) for _ in range(2))
    assert dec_ops.launch_plan(q, k).group == 8      # g 6 in an 8-head CTA
    for lens in ([0, 1, 255, 256, 257, t, 3001, t - 5],
                 [508 + 9 * i for i in range(b)], [t] * b):
        lens = torch.tensor(lens, device="cuda")
        valid = torch.arange(t, device="cuda")[None, :] < lens[:, None]
        got = dec_ops.decode_attention(q, k, v, valid)
        _decode_close(got, decode_attention_ref(q, k, v, valid))
        if int(lens[0]) == 0:
            assert bool((got[0] == 0).all())


@pytest.fixture(scope="module")
def mixtral_layer():
    """One full-width Mixtral MoE layer: (cfg, params on the card in f32,
    the same params on the CPU in float64)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.configs import get_arch
    from repro_torch.models import moe as moe_lib
    cfg = dataclasses.replace(get_arch("mixtral-8x22b"), n_layers=1)
    p = moe_lib.init_moe_params(
        cfg, torch.Generator(device="cuda").manual_seed(1), device="cuda")
    return cfg, p, {k: v.cpu().double() for k, v in p.items()}


@pytest.mark.parametrize("opts", [dict(dispatch="dense"),
                                  dict(dispatch="capacity",
                                       capacity_factor=4.0)],
                         ids=["dense", "capacity"])
def test_moe_ffn_full_width_matches_float64(mixtral_layer, opts):
    from repro_torch.models import moe as moe_lib
    cfg, p, p64 = mixtral_layer
    g = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((2, 8, cfg.d_model), generator=g, device="cuda")
    got, aux = moe_lib.moe_ffn(p, cfg, x, **opts)
    ref, ref_aux = moe_lib.moe_ffn(p64, cfg, x.cpu().double(), **opts)
    probs = torch.softmax(x.cpu().double() @ p64["router"], dim=-1)
    top = probs.sort(dim=-1, descending=True).values
    clear = (top[..., 1] - top[..., 2]) >= 1e-6           # (2, 8)
    assert float(clear.float().mean()) > 0.9
    err = (got.double().cpu() - ref).abs().amax(-1)[clear]
    assert float(err.max()) <= 1e-5 * float(ref.abs().max()), float(
        err.max())
    assert abs(float(aux) - float(ref_aux)) <= 1e-5 * float(ref_aux)


def test_arctic_share_f32_step_kernel_path_matches_plain(gen):
    from repro_torch import interop
    from repro_torch.configs import get_arch, smoke_variant
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import steps
    from repro_torch.models import transformer
    from repro_torch.tree import leaves
    share = (1, 2)
    cfg = dataclasses.replace(smoke_variant(get_arch("arctic-480b")),
                              n_heads=14, n_kv_heads=2)
    params = interop.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(3), "cuda",
        experts=share)
    assert params["blocks"][0]["moe"]["wi"].shape[1] == 2
    batch = {"tokens": torch.randint(4, cfg.vocab, (2, 128), generator=gen,
                                     device="cuda")}
    margs = dict(steps.DEFAULT_MOE_ARGS, group=64, experts=share)
    out = {}
    for path, attn in (("kernel", "pallas"), ("plain", "chunked")):
        pcfg = dataclasses.replace(cfg, attn_impl=attn)
        for c in (fa_ops.COUNTER, fa_ops.BWD_COUNTER):
            c.reset()
        loss, _, grads = steps.value_and_grad(
            lambda p: transformer.lm_loss(pcfg, p, batch, precision="f32",
                                          moe_args=margs), params)
        step, opt = steps.make_train_step(pcfg, precision="f32",
                                          moe_args=margs)
        new, _, _, _ = step(params, opt.init(params), batch)
        out[path] = (float(loss), dict(leaves(grads)), dict(leaves(new)),
                     fa_ops.COUNTER.count, fa_ops.BWD_COUNTER.shapes)
    (lk, gk, nk, fk, bk), (lp, gp, np_, fp, bp) = out["kernel"], out["plain"]
    # value_and_grad: 2 + 2; the train step (remat 'basic'): 4 + 2
    assert (fk, sum(bk.values()), fp, bp) == (6, 4, 0, {})
    assert set(bk) == {(28, 4, 128, 128, 64)}           # 28 / 4: group 7
    assert abs(lk - lp) <= 1e-4
    init = dict(leaves(params))
    for path, g in gp.items():
        assert float((gk[path] - g).abs().max()) <= 1e-3 * float(
            g.abs().max()), path
        step_p = float((np_[path] - init[path]).norm())
        assert float((nk[path] - np_[path]).norm()) <= 1e-3 * step_p, path
