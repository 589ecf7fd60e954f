"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (``nvcc``) and the rest of the
repository beside this file; it exits non-zero without them. In order it:

1. prints the card's name and power limit (``nvidia-smi``) and the torch
   and CUDA versions;
2. builds the hand-written kernels from ``src/repro_torch/kernels/*/csrc``
   for ``sm_90a`` (one ``nvcc`` per source, all at once);
3. holds the flash-attention forward kernel against its plain PyTorch
   version at the towers' shapes, in f32 and bf16, and times kernel, plain
   version and ``scaled_dot_product_attention`` (a yardstick the port never
   calls);
4. holds the similarity→top-k kernels against their plain version over a
   grid of batch, class-count and k, with planted exact ties, and times
   kernel, plain version and ``torch.topk(x @ c.T)``, and the kernels at
   each row block size they are built for;
5. holds the flash-attention backward kernel against its plain version at
   the training shapes of one microbatch (image bh 3072, s 196; text
   bh 4096, s 16 with the padding bias; causal and windowed cases), in f32
   and bf16, and times kernel, plain version and SDPA's backward;
6. holds the fused contrastive forward and backward kernels against their
   plain versions at B = 2048 and a ragged B = 1000 (D = 512, f32 and
   bf16, and the backward with ``with_diag=False`` and ``b_norm != B``),
   and times kernel, plain version and the materialising PyTorch calls;
7. serves zero-shot classification with BASIC-S at full width on the card
   (``repro_torch.launch.serve_zeroshot``: 512 classes × 4 prompt
   templates, 8 requests of 16 raw 224×224×3 images), checks the answers
   against the plain PyTorch path on the same weights and images, and
   checks that both serving kernels were launched on that path; then
   profiles 4 warm requests: device time by kernel, and the device kernels
   that each wrapper call launched;
8. training parity: one GradAccum step of BASIC-S at full width and depth
   in f32 (B = 256, 2 microbatches) on the kernel path (flash attention,
   fused loss) and on the plain path (materialised attention and loss)
   from the same weights and batch: loss, every gradient leaf and the
   parameters after AdaFactorW;
9. timed training: ``repro_torch.launch.train`` (``main``) at full width
   and depth, bf16, fused loss, flash attention, remat ``basic``, B = 2048
   pairs in 8 microbatches, 6 steps: step time, pairs per second, peak
   memory, losses, and the launches per step of the four training kernels;
   then profiles one warm step;
10. prints a ``{"kernels": [...]}`` line and, last, the
    ``{"ok": true, "device": {...}}`` line.

Any failure raises; no phase is caught.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

FLASH_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_fwd.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention/kernel.py:97"
TOPK_SOURCE = "src/repro_torch/kernels/similarity_topk/csrc/topk.cu"
TOPK_REPLACES = "src/repro/kernels/similarity_topk/kernel.py:85"
FLASH_BWD_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_bwd.cu"
FLASH_BWD_REPLACES = "src/repro/kernels/flash_attention/kernel.py:230"
CL_SOURCE = "src/repro_torch/kernels/contrastive_loss/csrc/contrastive.cu"
CL_FWD_REPLACES = "src/repro/kernels/contrastive_loss/kernel.py:107"
CL_BWD_REPLACES = "src/repro/kernels/contrastive_loss/kernel.py:185"

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s and the
# operation rates by input type (fp32 outside the tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

# tolerances, each with its reason:
# flash f32 — both sides accumulate fp32 over <= 196 keys in another order
FLASH_TOL = {"float32": 5e-5,
             # bf16 — the same fp32 result rounds to bf16 on both sides: a
             # crossing of a rounding boundary moves |out| < 2 by one ulp
             # (2^-7); lse stays fp32 (FLASH_TOL["float32"])
             "bfloat16": 1.6e-2}
# top-k logits: fp32 dot products of unit vectors (d = 512, summed in
# another order) times inv_tau = 1/0.07
TOPK_TOL = 1e-4
# main path against the plain path: embeddings through 8 (6) layers with
# the flash kernel vs materialised softmax, then logits times 1/0.07
E2E_LOGIT_TOL = 1e-3
E2E_CLASS_TOL = 1e-4
# flash backward f32: 2e-4 abs, the reference's own gradient tolerance
# (tests/test_attention_backends.py); fp32 sums in another order
FLASH_BWD_TOL = 2e-4
# flash backward bf16, per element: 2 bf16 ulps of |ref| (2^-7 relative
# each) plus 1e-3 of the tensor's max |ref|. Both sides accumulate in fp32
# and round the same value to bf16, so an element differs by at most the
# ulp of a rounding-boundary crossing; the 1e-3·max term covers elements
# near zero, where fp32 sums in another order cancel. At N(0, 1) inputs
# |dq|, |dk|, |dv| are ~0.1 rms, so the reference's 1e-1 abs (kept in the
# CPU tests against JAX) would pass a dropped delta or a lost d^-1/2.
# Plus 1e-5 abs for gradients that are zero by cancellation (one key:
# ds = dout·v − delta = 0), where both sides keep fp32 rounding residue
# (~1e-7) in another order
FLASH_BWD_BF16_ULPS = 2
FLASH_BWD_BF16_REL_MAX = 1e-3
FLASH_BWD_BF16_ABS = 1e-5
BF16_ULP = 2.0 ** -7
# contrastive kernels: LSE 5e-5 (fp32 sums of B exponentials of values up
# to ~15 in another order); dX/dY 1e-6 and dlog_tau 1e-4 relative, the
# reference's f32 tolerances (tests/test_kernels.py). bf16 gradients:
# 2^-6 of the tensor's max |ref| (|dX| ~ 3e-4 at unit rows, so an absolute
# 2e-2 would pass any fault); dA rounds to bf16 on both sides, and a
# rounding-boundary crossing moves one term of a row's sum by one ulp
CL_LSE_TOL = 5e-5
CL_GRAD_TOL_F32 = 1e-6
CL_GRAD_REL_MAX_BF16 = 2.0 ** -6
CL_DTAU_RTOL = {"float32": 1e-4, "bfloat16": 2e-2}
# training parity, kernel path vs plain path in f32:
# loss — embeddings through 8 (6) layers of flash vs materialised softmax
# differ by ~1e-6, the loss is ~log B
TRAIN_LOSS_TOL = 1e-4
# gradients — largest over leaves of max|g_kernel - g_plain| / max|g_plain|:
# fp32 sums in another order through the backward of every layer
TRAIN_GRAD_RTOL = 1e-3
# parameters after AdaFactorW — factored leaves within 2% of the lr: a
# gradient error of TRAIN_GRAD_RTOL moves an update by about that share of
# lr. An unfactored leaf's update is ~±lr per element whatever the
# gradient's size, so an element may differ by up to 2·lr only where its
# gradient is zero to within TRAIN_GRAD_RTOL of its leaf's largest
TRAIN_UPDATE_TOL_LR = 0.02


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` launches after
    ``warmup``, between CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, dtype: str):
    """(least milliseconds the card could take, what bounds it)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def dtype_name(dt) -> str:
    """'float32' / 'bfloat16'."""
    return str(dt).removeprefix("torch.")


# ---------------------------------------------------------------------------
# phase 3: flash-attention forward
# ---------------------------------------------------------------------------


def flash_case(label, b, h, s, d, dtype, padded, seed):
    """Kernel vs plain version at one shape; returns the case's record."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import (NEG_INF,
                                                         flash_fwd_ref)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    bh = b * h
    q, k, v = (torch.randn((bh, s, d), generator=g, device=dev).to(dtype)
               for _ in range(3))
    bias = None
    if padded:   # text-style key padding: 1..s valid keys per example
        lens = torch.randint(1, s + 1, (b,), generator=g, device=dev)
        keep = torch.arange(s, device=dev)[None, :] < lens[:, None]
        bias = torch.where(keep, 0.0, NEG_INF).float()
    out, lse = fa_ops.flash_fwd(q, k, v, bias, causal=False)
    ref_out, ref_lse = flash_fwd_ref(q, k, v, bias, causal=False)
    torch.cuda.synchronize()
    err_out = (out.float() - ref_out.float()).abs().max().item()
    err_lse = (lse - ref_lse).abs().max().item()
    dt = dtype_name(dtype)
    tol = FLASH_TOL[dt]
    if not (err_out <= tol and err_lse <= FLASH_TOL["float32"]):
        raise AssertionError(f"flash_fwd {label} {dt}: max |out err| "
                             f"{err_out:.3g} (tol {tol}), max |lse err| "
                             f"{err_lse:.3g}")
    ms = time_ms(lambda: fa_ops.flash_fwd(q, k, v, bias, causal=False))
    plain_ms = time_ms(lambda: flash_fwd_ref(q, k, v, bias, causal=False))
    q4, k4, v4 = (x.view(b, h, s, d) for x in (q, k, v))
    mask4 = None if bias is None else bias.to(dtype)[:, None, None, :]
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=mask4))
    item = torch.finfo(dtype).bits // 8
    nbytes = 4 * bh * s * d * item + bh * s * 4 + (b * s * 4 if padded
                                                   else 0)
    bound_ms, bound_by = bound(nbytes, 4.0 * bh * s * s * d, dt)
    rec = {"shape": f"{label} bh={bh} s={s} d={d} {dt}"
                    + (" padded" if padded else ""),
           "max_abs_err": max(err_out, err_lse), "ms": ms,
           "plain_ms": plain_ms, "library_ms": lib_ms,
           "bound_ms": bound_ms, "bound_by": bound_by}
    print(f"flash_fwd {rec['shape']}: err out {err_out:.3g} lse "
          f"{err_lse:.3g} (tol {tol}); kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {bound_ms:.4f} "
          f"ms ({bound_by})", flush=True)
    return rec


def phase_flash():
    """Flash kernel at the towers' main-path shapes, f32 and bf16."""
    import torch
    recs = {}
    for dtype in (torch.float32, torch.bfloat16):
        # image tower: 16 images x 12 heads, 196 patches, no bias
        recs[("image", dtype)] = flash_case("image", 16, 12, 196, 64, dtype,
                                            False, 1)
        # text tower: 64 prompts x 16 heads, 16 tokens, padding bias
        recs[("text", dtype)] = flash_case("text", 64, 16, 16, 64, dtype,
                                           True, 2)
    # head dim 128 and a causal / windowed mask, checked once each
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import flash_fwd_ref
    g = torch.Generator(device="cuda").manual_seed(3)
    for d, causal, window in ((128, False, None), (64, True, None),
                              (64, True, 48)):
        q, k, v = (torch.randn((24, 200, d), generator=g, device="cuda")
                   for _ in range(3))
        out, lse = fa_ops.flash_fwd(q, k, v, causal=causal, window=window)
        ref_out, ref_lse = flash_fwd_ref(q, k, v, causal=causal,
                                         window=window)
        err = max((out - ref_out).abs().max().item(),
                  (lse - ref_lse).abs().max().item())
        if not err <= FLASH_TOL["float32"]:
            raise AssertionError(f"flash_fwd d={d} causal={causal} "
                                 f"window={window}: max err {err:.3g}")
        print(f"flash_fwd d={d} causal={causal} window={window}: err "
              f"{err:.3g}", flush=True)
    return recs


# ---------------------------------------------------------------------------
# phase 4: similarity -> top-k
# ---------------------------------------------------------------------------


def check_topk(label, vals, idx, ref_v, ref_i, k, tol):
    """Values within ``tol`` of the plain version's, descending, and the
    indices equal wherever the plain version's neighbouring values differ
    by more than ``tol``. Returns the max abs value error."""
    import torch
    err = (vals - ref_v[:, :k]).abs().max().item()
    if not err <= tol:
        raise AssertionError(f"{label}: max |value err| {err:.3g} > {tol}")
    if bool((vals[:, 1:] > vals[:, :-1]).any()):
        raise AssertionError(f"{label}: values not descending")
    m = ref_v.shape[1]
    gap = torch.full_like(ref_v, float("inf"))
    gap[:, 1:] = ref_v[:, :-1] - ref_v[:, 1:]
    sep = gap[:, :k] > tol                       # apart from the one above
    below = torch.full_like(gap[:, :k], float("inf"))
    below[:, :min(k, m - 1)] = gap[:, 1:min(k, m - 1) + 1]
    sep &= below > tol                           # and from the one below
    bad = sep & (idx != ref_i[:, :k])
    if bool(bad.any()):
        r, c = (int(x) for x in bad.nonzero()[0])
        raise AssertionError(f"{label}: index mismatch at row {r} slot {c}:"
                             f" kernel {int(idx[r, c])} vs plain "
                             f"{int(ref_i[r, c])}")
    return err


def unit_rows(n, d, g, dtype):
    """(n, d) random unit rows in ``dtype``."""
    import torch
    x = torch.randn((n, d), generator=g, device="cuda")
    return (x / x.norm(dim=1, keepdim=True)).to(dtype)


def phase_topk():
    """Top-k kernels over b x n x k x dtype, planted ties, and the timing
    at the main path's shape."""
    import torch
    from repro_torch.kernels.similarity_topk import ops as topk_ops
    from repro_torch.kernels.similarity_topk.ref import similarity_topk_ref
    inv_tau = 1.0 / 0.07
    d = 512
    g = torch.Generator(device="cuda").manual_seed(4)
    errs = {"float32": 0.0, "bfloat16": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for b in (16, 64):
            for n in (512, 21841):
                x, c = unit_rows(b, d, g, dtype), unit_rows(n, d, g, dtype)
                ref_v, ref_i = similarity_topk_ref(x, c, 65, inv_tau)
                for k in (1, 5, 64):
                    vals, idx = topk_ops.similarity_topk(x, c, k,
                                                         inv_tau=inv_tau)
                    e = check_topk(f"topk b={b} n={n} k={k} "
                                   f"{dtype_name(dtype)}", vals, idx,
                                   ref_v, ref_i, k, TOPK_TOL)
                    errs[dtype_name(dtype)] = max(errs[dtype_name(dtype)], e)
        print(f"similarity_topk {dtype_name(dtype)}: b in (16, 64) x n in "
              f"(512, 21841) x k in (1, 5, 64) match; max |value err| "
              f"{errs[dtype_name(dtype)]:.3g} (tol {TOPK_TOL})", flush=True)

    # planted exact ties: duplicated class rows across chunks; the lower
    # class id must come first
    dup = [7, 4000, 13000, 21840]
    for b in (16, 64):
        x = unit_rows(b, d, g, torch.float32)
        c = unit_rows(21841, d, g, torch.float32)
        c[dup] = c[dup[0]].clone()
        x[0] = c[dup[0]]
        for k in (5, 64):
            vals, idx = topk_ops.similarity_topk(x, c, k, inv_tau=inv_tau)
            ref_v, ref_i = similarity_topk_ref(x, c, k + 1, inv_tau)
            check_topk(f"topk ties b={b} k={k}", vals, idx, ref_v, ref_i, k,
                       TOPK_TOL)
            if idx[0, :4].tolist() != dup or len(set(
                    vals[0, :4].tolist())) != 1:
                raise AssertionError(f"tie rule broken: ids "
                                     f"{idx[0, :4].tolist()} vals "
                                     f"{vals[0, :4].tolist()}")
    print(f"similarity_topk planted ties {dup}: lower id first", flush=True)

    recs = {}
    block_ms = {}
    for b, n in ((16, 512), (16, 21841)):
        x = unit_rows(b, d, g, torch.float32)
        c = unit_rows(n, d, g, torch.float32)
        ref_v, ref_i = similarity_topk_ref(x, c, 6, inv_tau)
        for rows in topk_ops.BLOCK_ROWS:
            vals, idx = topk_ops.similarity_topk(x, c, 5, inv_tau=inv_tau,
                                                 block_rows=rows)
            check_topk(f"topk b={b} n={n} block_rows={rows}", vals, idx,
                       ref_v, ref_i, 5, TOPK_TOL)
        ms = {rows: [] for rows in topk_ops.BLOCK_ROWS}
        for _ in range(3):              # in turns: 16, 64, 16, 64, ...
            for rows in topk_ops.BLOCK_ROWS:
                ms[rows].append(time_ms(lambda: topk_ops.similarity_topk(
                    x, c, 5, inv_tau=inv_tau, block_rows=rows)))
        block_ms[f"b={b} n={n}"] = {str(r): min(t) for r, t in ms.items()}
        print(f"similarity_topk b={b} n={n} k=5 f32 by image rows per CTA "
              f"(default {topk_ops.row_block(b)}): " + ", ".join(
                  f"{r}: {t:.4f} ms"
                  for r, t in block_ms[f"b={b} n={n}"].items()), flush=True)
    recs["block_rows_ms"] = block_ms

    for b, n, k in ((16, 512, 5), (64, 21841, 5)):
        x = unit_rows(b, d, g, torch.float32)
        c = unit_rows(n, d, g, torch.float32)
        ms = time_ms(lambda: topk_ops.similarity_topk(x, c, k,
                                                      inv_tau=inv_tau))
        plain_ms = time_ms(lambda: similarity_topk_ref(x, c, k, inv_tau))
        lib_ms = time_ms(lambda: torch.topk(x @ c.T * inv_tau, k, dim=1))
        nbytes = (b + n) * d * 4 + b * k * 8
        bound_ms, bound_by = bound(nbytes, 2.0 * b * n * d, "float32")
        recs[(b, n, k)] = {
            "shape": f"b={b} n={n} d={d} k={k} float32",
            "max_abs_err": errs["float32"], "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}
        print(f"similarity_topk b={b} n={n} k={k}: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, matmul+topk {lib_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by})", flush=True)
    return recs, errs


# ---------------------------------------------------------------------------
# phase 5: the main path
# ---------------------------------------------------------------------------


def phase_main_path():
    """BASIC-S zero-shot classify on the card; returns (launches, cfg,
    params, tok)."""
    import numpy as np
    import torch
    from repro_torch import interop
    from repro_torch.data import load_tokenizer
    from repro_torch.eval.zero_shot import class_embeddings
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.similarity_topk import ops as topk_ops
    from repro_torch.kernels.similarity_topk.ref import similarity_topk_ref
    from repro_torch.launch import serve_zeroshot
    from repro_torch.models import dual_encoder as de

    t0 = time.perf_counter()
    cfg, params = serve_zeroshot.build("basic-s", seed=0, device="cuda")
    tok = load_tokenizer()
    n_params = sum(p.numel() for _, p in interop.leaves(params))
    print(f"main path: basic-s, {n_params / 1e6:.1f}M params, init "
          f"{time.perf_counter() - t0:.2f}s", flush=True)

    counters = (fa_ops.COUNTER, topk_ops.COUNTER)
    for ctr in counters:
        ctr.reset()
    rep = serve_zeroshot.run(cfg, params, tok, classes=512, batch=16,
                             requests=8, k=5, seed=0, device="cuda")
    launches = {ctr.name: ctr.count for ctr in counters}

    print(f"main path: class matrix (512 classes x 4 templates = 2048 "
          f"prompts) {rep['class_matrix_s']:.3f}s, first classify "
          f"{rep['first_classify_s']:.3f}s", flush=True)
    print(f"main path: warm p50 {rep['p50_s'] * 1e3:.3f} ms, max "
          f"{rep['max_s'] * 1e3:.3f} ms, {rep['img_per_s']:.1f} img/s, top1 "
          f"{rep['top1']:.4f} vs chance {rep['chance']:.4f} (random "
          f"weights), max_memory_allocated "
          f"{rep['max_memory_allocated'] / 2**30:.3f} GiB", flush=True)
    print(f"main path launches: {launches}", flush=True)
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"main path")

    # the answers: finite, well-formed, and equal to the plain path's
    res = rep["last_result"]
    if res.values.shape != (16, 5) or not np.isfinite(res.values).all():
        raise AssertionError(f"bad classify values {res.values}")
    if (res.indices < 0).any() or (res.indices >= 512).any():
        raise AssertionError(f"bad class ids {res.indices}")
    plain = dataclasses.replace(
        cfg, image_tower=dataclasses.replace(cfg.image_tower,
                                             attn_impl="naive"),
        text_tower=dataclasses.replace(cfg.text_tower, attn_impl="naive"))
    dev = torch.device("cuda")
    with torch.inference_mode():
        cm_plain = class_embeddings(
            lambda p: de.encode_text(plain, params, {
                k: torch.from_numpy(v).to(dev) for k, v in p.items()}),
            tok, res.class_names)
        cm_err = (cm_plain.cpu() - torch.from_numpy(rep["class_matrix"])
                  ).abs().max().item()
        iemb = de.encode_image(plain, params, {"image": torch.from_numpy(
            rep["last_images"]).to(dev)})
        inv_tau = float(torch.exp(-params["log_tau"]))
        ref_v, ref_i = similarity_topk_ref(
            iemb, torch.from_numpy(rep["class_matrix"]).to(dev), 6, inv_tau)
    if not cm_err <= E2E_CLASS_TOL:
        raise AssertionError(f"class matrix vs plain path: max err "
                             f"{cm_err:.3g}")
    logit_err = check_topk("main path vs plain path",
                           torch.from_numpy(res.values).to(dev),
                           torch.from_numpy(res.indices).to(dev),
                           ref_v, ref_i, 5, E2E_LOGIT_TOL)
    print(f"main path vs plain PyTorch path on the card: class matrix max "
          f"err {cm_err:.3g} (tol {E2E_CLASS_TOL}), logits max err "
          f"{logit_err:.3g} (tol {E2E_LOGIT_TOL}), ids agree", flush=True)
    return launches, cfg, params, tok


# the device kernels each wrapper launches, by name
WRAPPER_KERNELS = {"flash_fwd": ("flash_fwd_kernel",),
                   "similarity_topk": ("topk_partial_kernel",
                                       "topk_merge_kernel"),
                   "flash_bwd": ("flash_bwd_delta_kernel",
                                 "flash_bwd_dq_kernel",
                                 "flash_bwd_dkv_kernel"),
                   "contrastive_fwd": ("contrastive_fwd_tile_kernel",
                                       "contrastive_fwd_combine_kernel"),
                   "contrastive_bwd": ("contrastive_grad_kernel",
                                       "contrastive_dtau_sum_kernel")}


# device kernels by group, first match wins: the port's kernels, the
# library GEMMs, copies; everything else is elementwise or reductions
KERNEL_GROUPS = (("flash kernels", ("flash_fwd_kernel", "flash_bwd_")),
                 ("contrastive kernels", ("contrastive_",)),
                 ("top-k kernels", ("topk_",)),
                 ("GEMMs", ("gemm", "nvjet", "xmma", "cutlass")),
                 ("copies and casts", ("copy", "Memcpy", "Memset")))


def device_breakdown(prof, label, wall_us, units, calls):
    """Print the profiled window's device time by kernel and its busy
    share; return, for each wrapper in ``calls`` (wrapper -> calls in the
    window), the device kernels the profiler saw per wrapper call."""
    by_kernel = {}
    seen = dict.fromkeys(calls, 0)
    for e in prof.events():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = e.time_range.elapsed_us()
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) + us
            for wrapper in calls:
                seen[wrapper] += any(n in e.name
                                     for n in WRAPPER_KERNELS[wrapper])
    busy = sum(by_kernel.values())
    unit = label.split()[-1]
    print(f"profile {label}: wall {wall_us / 1e3:.3f} ms, device time "
          f"{busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}% of wall; the "
          f"rest is the device idle)", flush=True)
    for name, us in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:14]:
        print(f"  {us / 1e3 / units:9.4f} ms/{unit}  "
              f"{100 * us / max(busy, 1e-9):5.1f}%  {name[:90]}", flush=True)
    by_group = {}
    for name, us in by_kernel.items():
        group = next((g for g, keys in KERNEL_GROUPS if any(
            k in name for k in keys)), "other (elementwise, reductions)")
        by_group[group] = by_group.get(group, 0.0) + us
    print(f"profile {label} by group: " + "; ".join(
        f"{g} {us / 1e3 / units:.3f} ms/{unit} "
        f"({100 * us / max(busy, 1e-9):.1f}%)"
        for g, us in sorted(by_group.items(), key=lambda kv: -kv[1])),
        flush=True)
    per_call = {}
    for wrapper, n in calls.items():
        if n < 1 or seen[wrapper] < n:
            raise AssertionError(f"profile {label}: {wrapper} called {n} "
                                 f"times, the profiler saw {seen[wrapper]} "
                                 f"of its device kernels")
        per_call[wrapper] = seen[wrapper] / n
    print(f"profile {label}: device kernels per wrapper call {per_call} "
          f"(wrapper calls {calls})", flush=True)
    return per_call, busy / wall_us


def phase_profile(cfg, params, tok, requests: int = 4):
    """Where a warm classify request's device time goes: a torch.profiler
    window over ``requests`` requests (class matrix already built), device
    time summed by kernel, and the sum over the window's wall time. Returns,
    for each serving wrapper, the device kernels the profiler saw per
    wrapper call in the window."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data import render_images, world_for_tower
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.similarity_topk import ops as topk_ops
    from repro_torch.serving import ZeroShotService

    rng = np.random.default_rng(1)
    world = world_for_tower(rng, cfg.image_tower, n_classes=512)
    batches = [render_images(world, rng.integers(0, 512, 16), rng)
               for _ in range(requests + 1)]
    with ZeroShotService(cfg, params, tok, device="cuda") as svc:
        svc.classify(batches[0], world.class_names, k=5)      # warm
        counters = (fa_ops.COUNTER, topk_ops.COUNTER)
        calls = {ctr.name: -ctr.count for ctr in counters}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for images in batches[1:]:
                svc.classify(images, world.class_names, k=5)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        for ctr in counters:
            calls[ctr.name] += ctr.count
    per_call, _ = device_breakdown(prof, f"{requests} warm requests",
                                   wall_us, requests, calls)
    return per_call


# ---------------------------------------------------------------------------
# phase 5: flash-attention backward
# ---------------------------------------------------------------------------


def flash_bwd_limit(ref):
    """Per-element limit on |kernel − plain| for one flash_bwd output."""
    import torch
    if ref.dtype != torch.bfloat16:
        return FLASH_BWD_TOL
    r = ref.float().abs()
    return (FLASH_BWD_BF16_ULPS * BF16_ULP * r
            + FLASH_BWD_BF16_REL_MAX * r.max() + FLASH_BWD_BF16_ABS)


def flash_bwd_tol_text(dt):
    """The flash_bwd limit for dtype name ``dt``, as printed."""
    if dt == "float32":
        return f"{FLASH_BWD_TOL}"
    return (f"{FLASH_BWD_BF16_ULPS} ulps + {FLASH_BWD_BF16_REL_MAX}"
            f"·max|ref| + {FLASH_BWD_BF16_ABS}")


def flash_bwd_case(label, b, h, s, d, dtype, padded, seed, causal=False,
                   window=None, timed=True):
    """Backward kernel vs plain version at one shape; returns the case's
    record (errors of dq, dk, dv; times when ``timed``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import (NEG_INF,
                                                         flash_bwd_ref,
                                                         flash_fwd_ref)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    bh = b * h
    q, k, v, dout = (torch.randn((bh, s, d), generator=g, device=dev)
                     .to(dtype) for _ in range(4))
    bias = None
    if padded:   # text-style key padding: 1..s valid keys per example
        lens = torch.randint(1, s + 1, (b,), generator=g, device=dev)
        keep = torch.arange(s, device=dev)[None, :] < lens[:, None]
        bias = torch.where(keep, 0.0, NEG_INF).float()
    out, lse = flash_fwd_ref(q, k, v, bias, causal=causal, window=window)
    args = (q, k, v, bias, out, lse, dout)
    got = fa_ops.flash_bwd(*args, causal=causal, window=window)
    ref = flash_bwd_ref(*args, causal=causal, window=window)
    torch.cuda.synchronize()
    dt = dtype_name(dtype)
    errs = {}
    for name, x, r in zip(("dq", "dk", "dv"), got, ref):
        err = (x.float() - r.float()).abs()
        errs[name] = err.max().item()
        if not bool((err <= flash_bwd_limit(r)).all()):
            raise AssertionError(f"flash_bwd {label} {dt}: {name} max abs "
                                 f"err {errs[name]:.3g} (tol "
                                 f"{flash_bwd_tol_text(dt)})")
    rec = {"shape": f"{label} bh={bh} s={s} d={d} {dt}"
                    + (" padded" if padded else "")
                    + (" causal" if causal else "")
                    + (f" window={window}" if window else ""),
           "max_abs_err": max(errs.values()), "errs": errs}
    if not timed:
        print(f"flash_bwd {rec['shape']}: err {errs}", flush=True)
        return rec
    rec["ms"] = time_ms(lambda: fa_ops.flash_bwd(*args, causal=causal,
                                                 window=window))
    rec["plain_ms"] = time_ms(lambda: flash_bwd_ref(*args, causal=causal,
                                                    window=window), iters=5)
    # SDPA's backward: forward + backward through autograd, minus the
    # forward timed apart on the same inputs
    q4, k4, v4 = (x.view(b, h, s, d).detach().requires_grad_()
                  for x in (q, k, v))
    do4 = dout.view(b, h, s, d)
    mask4 = None if bias is None else bias.to(dtype)[:, None, None, :]

    def sdpa_fwd():
        return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask4)

    def sdpa_fwd_bwd():
        torch.autograd.grad(sdpa_fwd(), (q4, k4, v4), do4)

    with torch.no_grad():
        fwd_ms = time_ms(sdpa_fwd)
    rec["library_ms"] = time_ms(sdpa_fwd_bwd) - fwd_ms
    item = torch.finfo(dtype).bits // 8
    nbytes = 8 * bh * s * d * item + bh * s * 4 + (b * s * 4 if padded
                                                   else 0)
    # five products of 2·s²·d per head: the q·kᵀ recompute, dout·vᵀ, ds·k,
    # dsᵀ·q and pᵀ·dout (this design's second q·kᵀ and dout·vᵀ, one each in
    # the dq and the dk/dv kernel, are its own choice, not the function's)
    rec["bound_ms"], rec["bound_by"] = bound(nbytes, 5 * 2.0 * bh * s * s * d,
                                             dt)
    print(f"flash_bwd {rec['shape']}: err {errs} (tol "
          f"{flash_bwd_tol_text(dt)}); "
          f"kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, sdpa "
          f"backward {rec['library_ms']:.4f} ms (its forward {fwd_ms:.4f} ms "
          f"subtracted), bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})",
          flush=True)
    return rec


def phase_flash_bwd():
    """Backward kernel at one microbatch of the timed run (M = 256): image
    bh 3072, s 196; text bh 4096, s 16, padded; f32 and bf16; plus causal,
    windowed and head-dim-128 cases, checked once each."""
    import torch
    recs = {}
    for dtype in (torch.float32, torch.bfloat16):
        recs[("image", dtype)] = flash_bwd_case("image", 256, 12, 196, 64,
                                                dtype, False, 11)
        recs[("text", dtype)] = flash_bwd_case("text", 256, 16, 16, 64,
                                               dtype, True, 12)
    for d, causal, window in ((64, True, None), (64, True, 48),
                              (128, False, None)):
        flash_bwd_case("mask", 2, 12, 200, d, torch.float32, False, 13,
                       causal=causal, window=window, timed=False)
    return recs


# ---------------------------------------------------------------------------
# phase 6: fused contrastive loss
# ---------------------------------------------------------------------------


def cl_grad_tol(ref, dt):
    """Max-abs limit on a contrastive_bwd gradient (dX or dY, fp32) whose
    inputs were of dtype name ``dt``."""
    if dt == "float32":
        return CL_GRAD_TOL_F32
    return CL_GRAD_REL_MAX_BF16 * ref.abs().max().item()


def contrastive_case(b, d, dtype, seed, timed=True):
    """Forward and backward kernels vs their plain versions at (B, D);
    returns the case's records."""
    import torch
    from repro_torch.kernels.contrastive_loss import ops as cl_ops
    from repro_torch.kernels.contrastive_loss.ref import (bwd_fused_ref,
                                                          fwd_fused_ref,
                                                          loss_ref)
    g = torch.Generator(device="cuda").manual_seed(seed)
    x, y = unit_rows(b, d, g, dtype), unit_rows(b, d, g, dtype)
    log_tau = torch.tensor(-2.659, device="cuda")          # ~ log 0.07
    inv_tau = torch.exp(-log_tau)
    dt = dtype_name(dtype)
    row, col = cl_ops.fwd_fused(x, y, inv_tau)
    ref_row, ref_col = fwd_fused_ref(x, y, inv_tau)
    fwd_err = max((row - ref_row).abs().max().item(),
                  (col - ref_col).abs().max().item())
    if not fwd_err <= CL_LSE_TOL:
        raise AssertionError(f"contrastive_fwd B={b} {dt}: max lse err "
                             f"{fwd_err:.3g} (tol {CL_LSE_TOL})")
    bwd_err, bwd_tol = 0.0, float("inf")
    for b_norm, with_diag in ((None, True), (3 * b, False)):
        got = cl_ops.bwd_fused(x, y, inv_tau, ref_row, ref_col,
                               b_norm=b_norm, with_diag=with_diag)
        ref = bwd_fused_ref(x, y, inv_tau, ref_row, ref_col, b_norm=b_norm,
                            with_diag=with_diag)
        gerr = max((got[0] - ref[0]).abs().max().item(),
                   (got[1] - ref[1]).abs().max().item())
        terr = abs((got[2] - ref[2]).item())
        gtol = min(cl_grad_tol(ref[0], dt), cl_grad_tol(ref[1], dt))
        if not (gerr <= gtol and terr <= CL_DTAU_RTOL[dt]
                * abs(ref[2].item()) + 1e-6):
            raise AssertionError(f"contrastive_bwd B={b} {dt} b_norm="
                                 f"{b_norm} with_diag={with_diag}: max grad "
                                 f"err {gerr:.3g}, dlog_tau err {terr:.3g}")
        bwd_err = max(bwd_err, gerr)
        bwd_tol = min(bwd_tol, gtol)
    print(f"contrastive B={b} D={d} {dt}: lse err {fwd_err:.3g} (tol "
          f"{CL_LSE_TOL}), dX/dY err {bwd_err:.3g} (tol {bwd_tol:.3g}; "
          f"with_diag and b_norm=B, and without diag at b_norm=3B)",
          flush=True)
    fwd = {"shape": f"B={b} D={d} {dt}", "max_abs_err": fwd_err}
    bwd = {"shape": f"B={b} D={d} {dt}", "max_abs_err": bwd_err}
    if not timed:
        return fwd, bwd
    item = torch.finfo(dtype).bits // 8
    fwd["ms"] = time_ms(lambda: cl_ops.fwd_fused(x, y, inv_tau))
    fwd["plain_ms"] = time_ms(lambda: fwd_fused_ref(x, y, inv_tau))

    def lib_fwd():
        a = (x @ y.T).float() * inv_tau
        return torch.logsumexp(a, 1), torch.logsumexp(a, 0)

    fwd["library_ms"] = time_ms(lib_fwd)
    fwd["bound_ms"], fwd["bound_by"] = bound(2 * b * d * item + 2 * b * 4,
                                             2.0 * b * b * d, dt)
    bargs = (x, y, inv_tau, ref_row, ref_col)
    bwd["ms"] = time_ms(lambda: cl_ops.bwd_fused(*bargs))
    bwd["plain_ms"] = time_ms(lambda: bwd_fused_ref(*bargs))
    # autograd of the materialised loss, minus its forward timed apart
    xr, yr, lr_ = (t.detach().clone().requires_grad_()
                   for t in (x, y, log_tau))
    with torch.no_grad():
        lfwd_ms = time_ms(lambda: loss_ref(xr, yr, lr_))
    bwd["library_ms"] = time_ms(lambda: torch.autograd.grad(
        loss_ref(xr, yr, lr_), (xr, yr, lr_))) - lfwd_ms
    bwd["bound_ms"], bwd["bound_by"] = bound(
        2 * b * d * item + 2 * b * 4 + 2 * b * d * 4 + 4,
        3 * 2.0 * b * b * d, dt)
    for name, r in (("contrastive_fwd", fwd), ("contrastive_bwd", bwd)):
        print(f"{name} {r['shape']}: kernel {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms, "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)
    return fwd, bwd


def phase_contrastive():
    """Fused contrastive kernels at the timed run's B = 2048 and a ragged
    B = 1000 (D = 512): f32 timed, bf16 for correctness."""
    import torch
    recs = {}
    for b in (2048, 1000):
        recs[(b, torch.float32)] = contrastive_case(b, 512, torch.float32,
                                                    20 + b)
        recs[(b, torch.bfloat16)] = contrastive_case(b, 512, torch.bfloat16,
                                                     21 + b, timed=False)
    return recs


# ---------------------------------------------------------------------------
# phase 8: training parity, kernel path vs plain path
# ---------------------------------------------------------------------------


def phase_train_parity(batch_size: int = 256, num_micro: int = 2):
    """One GradAccum step + AdaFactorW of BASIC-S (full width and depth,
    f32) on both paths from the same weights and batch."""
    import numpy as np
    import torch
    from repro_torch import interop
    from repro_torch.configs import get_arch
    from repro_torch.core import remat as remat_lib
    from repro_torch.core.contrastive import (contrastive_loss,
                                              fused_kernel_loss)
    from repro_torch.core.gradaccum import contrastive_step
    from repro_torch.data import (contrastive_batch, load_tokenizer,
                                  world_for_tower)
    from repro_torch.launch.steps import make_optimizer
    from repro_torch.launch.train import batch_to
    from repro_torch.models import dual_encoder as de
    from repro_torch.optim import apply_updates

    cfg = get_arch("basic-s")
    rng = np.random.default_rng(0)
    world = world_for_tower(rng, cfg.image_tower, n_classes=64)
    batch, _ = contrastive_batch(world, load_tokenizer(), batch_size, rng)
    batch = batch_to(batch, "cuda")
    params = interop.init_params(cfg, torch.Generator().manual_seed(1),
                                 "cuda")
    opt = make_optimizer()
    lr = 2.5e-4
    policy = remat_lib.get_policy("basic")
    results = {}
    for path, attn, loss_fn in (("kernel", "pallas", fused_kernel_loss),
                                ("plain", "naive", contrastive_loss)):
        pcfg = dataclasses.replace(
            cfg, image_tower=dataclasses.replace(cfg.image_tower,
                                                 attn_impl=attn),
            text_tower=dataclasses.replace(cfg.text_tower, attn_impl=attn))
        t0 = time.perf_counter()
        loss, _, grads = contrastive_step(
            lambda p, im: de.encode_image(pcfg, p, im, precision="f32",
                                          remat_policy=policy),
            lambda p, tx: de.encode_text(pcfg, p, tx, precision="f32",
                                         remat_policy=policy),
            params, batch, num_micro, loss_fn=loss_fn)
        updates, _ = opt.update(grads, opt.init(params), params, lr)
        new = apply_updates(params, updates)
        torch.cuda.synchronize()
        results[path] = (loss.item(), dict(interop.leaves(grads)),
                         dict(interop.leaves(new)),
                         time.perf_counter() - t0)
    (lk, gk, pk, tk), (lp, gp, pp, tp) = results["kernel"], results["plain"]
    loss_err = abs(lk - lp)
    grad_rel = {path: ((gk[path] - gp[path]).abs().max()
                       / gp[path].abs().max().clamp(min=1e-30)).item()
                for path in gp}
    worst = max(grad_rel, key=grad_rel.get)
    upd_err, flips = 0.0, 0
    for path, new_p in pp.items():
        diff = (pk[path] - new_p).abs()
        g = gp[path]
        factored = g.dim() >= 2 and min(g.shape[-2:]) >= 128
        if factored:
            upd_err = max(upd_err, diff.max().item())
            continue
        off = diff > TRAIN_UPDATE_TOL_LR * lr
        near_zero = g.abs() <= TRAIN_GRAD_RTOL * g.abs().max()
        if bool((off & ~near_zero).any()):
            raise AssertionError(f"train parity: {path} update differs by "
                                 f"{diff.max().item():.3g} where its "
                                 f"gradient is not near zero")
        flips += int(off.sum())
        upd_err = max(upd_err, diff[~off].max().item() if bool(
            (~off).any()) else 0.0)
    print(f"train parity (BASIC-S f32, B={batch_size}, {num_micro} "
          f"microbatches): loss kernel {lk:.6f} plain {lp:.6f} (|diff| "
          f"{loss_err:.3g}, tol {TRAIN_LOSS_TOL}); largest relative gradient "
          f"error {grad_rel[worst]:.3g} at {worst} (tol {TRAIN_GRAD_RTOL}); "
          f"updated params max diff {upd_err:.3g} (tol "
          f"{TRAIN_UPDATE_TOL_LR * lr:.3g} = {TRAIN_UPDATE_TOL_LR}·lr; "
          f"{flips} unfactored elements with near-zero gradients differ "
          f"more); step {tk:.2f}s kernel path, {tp:.2f}s plain path",
          flush=True)
    if not (loss_err <= TRAIN_LOSS_TOL and grad_rel[worst] <= TRAIN_GRAD_RTOL
            and upd_err <= TRAIN_UPDATE_TOL_LR * lr):
        raise AssertionError("train parity: kernel path and plain path "
                             "disagree beyond the stated tolerances")
    return {"loss_err": loss_err, "grad_rel_err": grad_rel[worst],
            "update_err": upd_err}


# ---------------------------------------------------------------------------
# phase 9: timed training through the trainer's entry point
# ---------------------------------------------------------------------------

TRAIN_ARGV = ["--mode", "contrastive", "--arch", "basic-s", "--batch",
              "2048", "--num-micro", "8", "--steps", "6", "--seed", "0",
              "--precision", "bf16", "--loss", "fused", "--attn", "pallas",
              "--remat", "basic"]


def train_step_flops(cfg, batch: int, text_len: int = 16):
    """(dense, attention) FLOP of one training step of the timed run's
    configuration, from the shapes: every weight matmul twice forward
    (pass 1, pass 2) and twice backward (remat ``basic`` keeps the matmul
    outputs); attention three times forward (pass 1, pass 2, the remat
    recompute) and once backward at 5·2·s²·d per head (the q·kᵀ recompute,
    dout·vᵀ, ds·k, dsᵀ·q, pᵀ·dout) against the forward's 4·s²·d."""
    def tower(t, tokens):
        hd = t.resolved_head_dim
        per_layer = (t.d_model * (t.n_heads + 2 * t.n_kv_heads) * hd
                     + t.n_heads * hd * t.d_model + 3 * t.d_model * t.d_ff)
        dense = 2.0 * tokens * t.n_layers * per_layer
        attn = t.n_layers * t.n_heads * 4.0 * tokens ** 2 * hd
        return dense, attn
    it, tt = cfg.image_tower, cfg.text_tower
    di, ai = tower(it, it.frontend_len)
    dt, at = tower(tt, text_len)
    patch = 2.0 * it.frontend_len * it.patch_size ** 2 * it.channels \
        * it.d_model
    proj = 2.0 * (it.d_model + tt.d_model) * cfg.embed_dim
    dense_fwd = di + dt + patch + proj
    return batch * 4 * dense_fwd, batch * (3 + 2.5) * (ai + at)


def phase_train_timed():
    """``repro_torch.launch.train.main`` at full width and depth; returns
    (launches per step, report)."""
    import math
    from repro_torch.kernels.contrastive_loss import ops as cl_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import train

    counters = (fa_ops.COUNTER, fa_ops.BWD_COUNTER, cl_ops.FWD_COUNTER,
                cl_ops.BWD_COUNTER)
    for ctr in counters:
        ctr.reset()
    rep = train.main(TRAIN_ARGV)
    steps = len(rep["losses"])
    launches = {ctr.name: ctr.count for ctr in counters}
    per_step = {k: v / steps for k, v in launches.items()}
    print(f"train timed: BASIC-S bf16, B=2048 in 8 microbatches, {steps} "
          f"steps: warm step median {rep['warm_step_median_s']:.4f} s over "
          f"{len(rep['step_s']) - 1} warm steps, {rep['pairs_per_s']:.1f} "
          f"pairs/s, max_memory_allocated "
          f"{rep['max_memory_allocated'] / 2**30:.3f} GiB; step s "
          f"{[round(t, 4) for t in rep['step_s']]}; data s "
          f"{[round(t, 3) for t in rep['data_s']]}; losses "
          f"{[round(v, 5) for v in rep['losses']]}", flush=True)
    print(f"train timed launches: {launches}, per step {per_step}",
          flush=True)
    from repro_torch.configs import get_arch
    dense, attn = train_step_flops(get_arch("basic-s"), 2048)
    step_bound = (dense + attn) / PEAK_FLOPS["bfloat16"]
    print(f"train FLOP model: dense {dense / 1e12:.1f} TFLOP/step, "
          f"attention {attn / 1e12:.2f} TFLOP/step; bound {step_bound:.4f} "
          f"s/step at the bf16 peak; the warm median is "
          f"{rep['warm_step_median_s'] / step_bound:.1f}x that; attention "
          f"alone bounds at {attn / PEAK_FLOPS['float32']:.4f} s on the fp32 "
          f"FMA units", flush=True)
    if not all(math.isfinite(v) for v in rep["losses"]):
        raise AssertionError(f"non-finite training loss {rep['losses']}")
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"training path")
    return launches, per_step, rep


def phase_train_profile():
    """A torch.profiler window over one warm training step (after one
    unprofiled step) of the timed run's configuration: device time by
    kernel, busy share, device kernels per wrapper call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data import contrastive_batch
    from repro_torch.kernels.contrastive_loss import ops as cl_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import train

    args = train.parse_args(TRAIN_ARGV)
    dev = torch.device("cuda")
    run = train.build_contrastive(args, dev)
    params, opt_state = run["params"], run["opt_state"]
    batches = [train.batch_to(contrastive_batch(run["world"], run["tok"],
                                                args.batch, run["rng"])[0],
                              dev) for _ in range(2)]
    params, opt_state, loss, _ = run["step_fn"](params, opt_state,
                                                batches[0])   # warm
    float(loss)
    counters = (fa_ops.COUNTER, fa_ops.BWD_COUNTER, cl_ops.FWD_COUNTER,
                cl_ops.BWD_COUNTER)
    calls = {ctr.name: -ctr.count for ctr in counters}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, opt_state, loss, _ = run["step_fn"](params, opt_state,
                                                    batches[1])
        float(loss)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    for ctr in counters:
        calls[ctr.name] += ctr.count
    return device_breakdown(prof, "1 warm training step", wall_us, 1, calls)


def main() -> int:
    """Run every phase; returns the exit code."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.contrastive_loss import ops as cl_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.similarity_topk import ops as topk_ops

    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}",
          flush=True)
    resolve_device("cuda")

    libs = (fa_ops.LIB, fa_ops.BWD_LIB, topk_ops.LIB, cl_ops.LIB)
    t0 = time.perf_counter()
    kbuild.build_all(libs)
    print(f"built kernels in {time.perf_counter() - t0:.1f}s (sm_90a)",
          flush=True)
    for lib in libs:
        print(f"  {lib.name}: nvcc {lib.build_seconds or 0.0:.1f}s", flush=True)
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {line.strip()}", flush=True)

    flash = phase_flash()
    topk, topk_errs = phase_topk()
    flash_bwd = phase_flash_bwd()
    contrastive = phase_contrastive()
    launches, cfg, params, tok = phase_main_path()
    per_call = phase_profile(cfg, params, tok)
    del params
    phase_train_parity()
    train_launches, train_per_step, _ = phase_train_timed()
    train_per_call, busy = phase_train_profile()

    f_main = flash[("image", torch.float32)]
    f_bf16 = max(flash[(s, torch.bfloat16)]["max_abs_err"]
                 for s in ("image", "text"))
    t_main = topk[(16, 512, 5)]
    b_main = flash_bwd[("image", torch.float32)]
    b_bf16 = max(flash_bwd[(s, torch.bfloat16)]["max_abs_err"]
                 for s in ("image", "text"))
    c_fwd, c_bwd = contrastive[(2048, torch.float32)]
    timing = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
              "library_ms")

    def train_entry(name, source, replaces, rec, **extra):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": train_launches[name],
                **{k: rec[k] for k in timing}, "shape": rec["shape"],
                "launches_per_step": train_per_step[name],
                "device_kernels_per_call": train_per_call[name], **extra}

    kernels = [
        {"name": fa_ops.COUNTER.name, "route": "cuda",
         "source": FLASH_SOURCE, "replaces": FLASH_REPLACES,
         "launches": launches[fa_ops.COUNTER.name],
         **{k: f_main[k] for k in timing},
         "shape": f_main["shape"], "max_abs_err_bf16": f_bf16,
         "text_f32": {k: flash[("text", torch.float32)][k]
                      for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                "bound_by")},
         "device_kernels_per_call": per_call[fa_ops.COUNTER.name],
         "train_launches": train_launches[fa_ops.COUNTER.name],
         "train_launches_per_step": train_per_step[fa_ops.COUNTER.name]},
        {"name": topk_ops.COUNTER.name, "route": "cuda",
         "source": TOPK_SOURCE, "replaces": TOPK_REPLACES,
         "launches": launches[topk_ops.COUNTER.name],
         **{k: t_main[k] for k in timing},
         "shape": t_main["shape"], "max_abs_err_bf16": topk_errs["bfloat16"],
         "block_rows_ms": topk["block_rows_ms"],
         "device_kernels_per_call": per_call[topk_ops.COUNTER.name]},
        train_entry(fa_ops.BWD_COUNTER.name, FLASH_BWD_SOURCE,
                    FLASH_BWD_REPLACES, b_main, max_abs_err_bf16=b_bf16,
                    text_f32={k: flash_bwd[("text", torch.float32)][k]
                              for k in timing}),
        train_entry(cl_ops.FWD_COUNTER.name, CL_SOURCE, CL_FWD_REPLACES,
                    c_fwd, max_abs_err_bf16=contrastive[
                        (2048, torch.bfloat16)][0]["max_abs_err"]),
        train_entry(cl_ops.BWD_COUNTER.name, CL_SOURCE, CL_BWD_REPLACES,
                    c_bwd, max_abs_err_bf16=contrastive[
                        (2048, torch.bfloat16)][1]["max_abs_err"]),
    ]
    print(f"train profile busy share {busy:.4f}", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
