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
5. serves zero-shot classification with BASIC-S at full width on the card
   (``repro_torch.launch.serve_zeroshot``: 512 classes × 4 prompt
   templates, 8 requests of 16 raw 224×224×3 images), checks the answers
   against the plain PyTorch path on the same weights and images, and
   checks that both kernels were launched on that path; then profiles 4
   warm requests: device time by kernel, and the device kernels that each
   wrapper call launched;
6. prints a ``{"kernels": [...]}`` line and, last, the
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
                                       "topk_merge_kernel")}


def phase_profile(cfg, params, tok, requests: int = 4):
    """Where a warm classify request's device time goes: a torch.profiler
    window over ``requests`` requests (class matrix already built), device
    time summed by kernel, and the sum over the window's wall time. Returns,
    for each wrapper, the device kernels the profiler saw per wrapper call
    in the window."""
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
    by_kernel = {}
    seen = dict.fromkeys(WRAPPER_KERNELS, 0)
    for e in prof.events():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            us = e.time_range.elapsed_us()
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) + us
            for wrapper, names in WRAPPER_KERNELS.items():
                seen[wrapper] += any(n in e.name for n in names)
    busy = sum(by_kernel.values())
    print(f"profile: {requests} warm requests, wall {wall_us / 1e3:.3f} ms, "
          f"device time {busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}% of "
          f"wall; the rest is the device idle)", flush=True)
    for name, us in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {us / 1e3 / requests:9.4f} ms/request  "
              f"{100 * us / max(busy, 1e-9):5.1f}%  {name[:90]}", flush=True)
    per_call = {}
    for wrapper in WRAPPER_KERNELS:
        if calls[wrapper] < 1 or seen[wrapper] < calls[wrapper]:
            raise AssertionError(f"profile: {wrapper} called "
                                 f"{calls[wrapper]} times, the profiler saw "
                                 f"{seen[wrapper]} of its device kernels")
        per_call[wrapper] = seen[wrapper] / calls[wrapper]
    print(f"profile: device kernels per wrapper call {per_call} (wrapper "
          f"calls {calls})", flush=True)
    return per_call


def main() -> int:
    """Run every phase; returns the exit code."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build as kbuild
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.similarity_topk import ops as topk_ops

    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}",
          flush=True)
    resolve_device("cuda")

    t0 = time.perf_counter()
    kbuild.build_all([fa_ops.LIB, topk_ops.LIB])
    print(f"built kernels in {time.perf_counter() - t0:.1f}s (sm_90a)",
          flush=True)
    for lib in (fa_ops.LIB, topk_ops.LIB):
        print(f"  {lib.name}: nvcc {lib.build_seconds or 0.0:.1f}s", flush=True)
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {line.strip()}", flush=True)

    flash = phase_flash()
    topk, topk_errs = phase_topk()
    launches, cfg, params, tok = phase_main_path()
    per_call = phase_profile(cfg, params, tok)

    f_main = flash[("image", torch.float32)]
    f_bf16 = max(flash[(s, torch.bfloat16)]["max_abs_err"]
                 for s in ("image", "text"))
    t_main = topk[(16, 512, 5)]
    kernels = [
        {"name": fa_ops.COUNTER.name, "route": "cuda",
         "source": FLASH_SOURCE, "replaces": FLASH_REPLACES,
         "launches": launches[fa_ops.COUNTER.name],
         **{k: f_main[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")},
         "shape": f_main["shape"], "max_abs_err_bf16": f_bf16,
         "text_f32": {k: flash[("text", torch.float32)][k]
                      for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                "bound_by")},
         "device_kernels_per_call": per_call[fa_ops.COUNTER.name]},
        {"name": topk_ops.COUNTER.name, "route": "cuda",
         "source": TOPK_SOURCE, "replaces": TOPK_REPLACES,
         "launches": launches[topk_ops.COUNTER.name],
         **{k: t_main[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")},
         "shape": t_main["shape"], "max_abs_err_bf16": topk_errs["bfloat16"],
         "block_rows_ms": topk["block_rows_ms"],
         "device_kernels_per_call": per_call[topk_ops.COUNTER.name]},
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
