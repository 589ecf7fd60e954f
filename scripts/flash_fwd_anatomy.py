"""Where the time of the flash-attention forward kernels goes.

    python3 scripts/flash_fwd_anatomy.py [--f32]

Needs one CUDA card and the CUDA toolkit; exits non-zero without a card.
Builds the committed ``flash_fwd.cu`` and variants of it, each with one
part of a kernel's work taken out, into ``build/anatomy/``, then times them
all in turns (each variant, then in reverse order) at the main paths'
shapes with the launch plan of ``ops.fwd_plan``. The bf16 tensor-core
kernel (the default) at the training microbatches and the prefill:

- ``full``: the kernel as committed;
- ``staging``: no arithmetic at all, only the q and k/v staging, the
  barriers and the output stores (the tile loop's body never runs);
- ``no_exp``: the softmax's ``ex2`` replaced by a multiply;
- ``no_pv``: the p·v products replaced by one add per fragment;
- ``no_qk``: the q·kᵀ products replaced by one add per fragment.

With ``--f32``, the split 3×TF32 kernel at the zero-shot serving shapes
(image bh 192, text bh 1024) and the f32 prefill, with ``full``,
``staging``, ``no_exp``, ``no_pv`` and ``no_qk`` as above and

- ``no_tile_split``: the CTA's split of each landed k/v tile into tf32
  pairs skipped;
- ``no_split``: every tf32 split replaced by the raw bits (hi = x, lo = 0;
  the three products per mma kept), what the splits' ALU work costs;
- ``plain_tf32``: one mma per product on the rounded operands, no lo
  halves (wrong beyond the f32 limits; what the two small products and
  their splits cost);

and a ``peak`` line: the card's mma.sync rate, tf32 m16n8k8 and bf16
m16n8k16, from a loop of independent products in every warp of 4 CTAs of
8 warps per SM (TFLOP/s of the instruction, two per multiply-add).

The variants compute wrong outputs; only their times mean anything, and
a time saved by taking a part out bounds what that part costs. Prints one
line per shape, ``{variant: [ms, ms]}`` (mean device ms between CUDA
events, ``chip_smoke.time_ms``), and the card's name and power limit.
"""
from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

# (variant, [(text in flash_fwd.cu, replacement)]); each text must occur
VARIANTS = (
    ("full", []),
    ("staging", [("    if (attend) {\n      const bf16* Ks",
                  "    if (attend && S < 0) {\n      const bf16* Ks")]),
    ("no_exp", [('  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));',
                 "  y = x * 0.5f;")]),
    ("no_pv", [("            mma16816(o[2 * dp], pa[kk], b[0], b[1]);\n"
                "            mma16816(o[2 * dp + 1], pa[kk], b[2], b[3]);",
                "            o[2 * dp][0] += __uint_as_float(b[0] ^ "
                "pa[kk][0]);\n"
                "            o[2 * dp + 1][0] += __uint_as_float(b[2] ^ "
                "pa[kk][1]);")]),
    ("no_qk", [("            mma16816(sc[2 * np], qa[kk], b[0], b[1]);\n"
                "            mma16816(sc[2 * np + 1], qa[kk], b[2], b[3]);",
                "            sc[2 * np][0] += __uint_as_float(b[0] ^ "
                "qa[kk][0]);\n"
                "            sc[2 * np + 1][0] += __uint_as_float(b[2] ^ "
                "qa[kk][1]);")]),
)

F32_QK = "      mma_3xtf32(sc[j], qh[kk], ql[kk], b0.x, b1.x, b0.y, b1.y);"
F32_PV = "      mma_3xtf32(o[dn], ph, pl, b0.x, b1.x, b0.y, b1.y);"
F32_VARIANTS = (
    ("full", []),
    ("staging", [("    if (attend) {\n      // one instantiation",
                  "    if (attend && S < 0) {\n      // one instantiation")]),
    ("no_exp", VARIANTS[2][1]),
    ("no_pv", [(F32_PV, "      o[dn][0] += __uint_as_float(b0.x ^ ph[0] ^ "
                        "b1.y ^ pl[1]);")]),
    ("no_qk", [(F32_QK, "      sc[j][0] += __uint_as_float(b0.x ^ "
                        "qh[kk][0] ^ b1.y ^ ql[kk][1]);")]),
    ("no_tile_split", [("      for (int e = tid; e < 2 * n8 * C4; "
                        "e += blockDim.x) {",
                        "      for (int e = tid; e < 2 * n8 * C4 && S < 0; "
                        "e += blockDim.x) {")]),
    ("no_split", [('#include "tc.cuh"\n',
                   '#include "tc.cuh"\n#define split_tf32(x, h, l) '
                   '((h) = __float_as_uint(x), (l) = 0u)\n')]),
    ("plain_tf32", [(F32_QK, "      mma1688(sc[j], qh[kk], b0.x, b1.x);"),
                    (F32_PV, "      mma1688(o[dn], ph, b0.x, b1.x);")]),
)

# (label, batch, heads, kv heads, s, d, causal, window, key padding)
SHAPES = (("image bh 3072", 256, 12, 12, 196, 64, False, None, False),
          ("text bh 4096", 256, 16, 16, 16, 64, False, None, True),
          ("prefill bh 32 / kv 8", 1, 32, 8, 512, 64, True, 8192, False))
F32_SHAPES = (("image bh 192", 16, 12, 12, 196, 64, False, None, False),
              ("text bh 1024", 64, 16, 16, 16, 64, False, None, True),
              ("prefill bh 32 / kv 8", 1, 32, 8, 512, 64, True, 8192, False))

PEAK_SOURCE = r"""
#include "tc.cuh"
// a loop of 8 independent products per warp: the mma.sync issue rate
template <bool TF32>
__global__ void __launch_bounds__(256) mma_peak_kernel(float* out,
                                                       int iters) {
  const unsigned x = threadIdx.x * 2654435761u;
  const unsigned a[4] = {x & 0x3f800000u, x & 0x3f000000u, 0x3f800000u,
                         0x3e800000u};
  float c[8][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (TF32) mma1688(c[j], a, a[j & 3], a[(j + 1) & 3]);
      else mma16816(c[j], a, a[j & 3], a[(j + 1) & 3]);
    }
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int repro_mma_peak(float* out, int tf32, int blocks, int iters,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tf32) mma_peak_kernel<true><<<blocks, 256, 0, st>>>(out, iters);
  else mma_peak_kernel<false><<<blocks, 256, 0, st>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def peak_library():
    """The mma.sync rate kernel, built under build/anatomy/."""
    import ctypes
    from repro_torch.kernels.build import KernelLibrary
    path = os.path.join(ROOT, "build", "anatomy", "mma_peak.cu")
    with open(path, "w") as f:
        f.write(PEAK_SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    return KernelLibrary("anatomy_mma_peak", path,
                         {"repro_mma_peak": (i, [p, i, i, i, p])})


def variant_libraries(variants=VARIANTS):
    """One KernelLibrary per variant, its source written under
    build/anatomy/ beside a copy of the shared header."""
    import shutil
    from repro_torch.kernels.build import KernelLibrary
    from repro_torch.kernels.flash_attention import ops as fa
    csrc = os.path.dirname(fa.LIB.source)
    out = os.path.join(ROOT, "build", "anatomy")
    os.makedirs(out, exist_ok=True)
    shutil.copy(os.path.join(csrc, "tc.cuh"), out)
    with open(fa.LIB.source) as f:
        src = f.read()
    libs = {}
    for name, edits in variants:
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: the text to replace is "
                                   f"not in flash_fwd.cu once:\n{old}")
            text = text.replace(old, new)
        path = os.path.join(out, f"flash_fwd_{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        libs[name] = KernelLibrary(f"anatomy_{name}", path,
                                   fa.LIB.signatures)
    return libs


def launch(lib, q, k, v, bias, causal, window, plan):
    """One launch of a variant's C entry, as ops.flash_fwd makes it."""
    import torch
    from repro_torch.kernels.build import check
    bh, s, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((bh, s), dtype=torch.float32, device=q.device)
    rc = lib.lib().repro_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        bias.data_ptr() if bias is not None else None, out.data_ptr(),
        lse.data_ptr(), 0 if q.dtype == torch.float32 else 1, bh, s,
        k.shape[1], d, bh // k.shape[0],
        bh // bias.shape[0] if bias is not None else 1, int(causal),
        window if window is not None else -1, float(d ** -0.5),
        plan.warps, plan.key_tile, plan.smem,
        torch.cuda.current_stream().cuda_stream)
    check(rc, "flash_fwd variant launch")


def mma_peak(lib):
    """{"tf32 m16n8k8": TFLOP/s, "bf16 m16n8k16": TFLOP/s} of mma.sync
    over 4 CTAs of 8 warps per SM."""
    import torch
    from chip_smoke import time_ms
    from repro_torch.kernels.build import check
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks, iters = 4 * sms, 4096
    out = torch.empty(blocks * 256, device="cuda")
    rates = {}
    for name, tf32, flops in (("tf32 m16n8k8", 1, 2 * 16 * 8 * 8),
                              ("bf16 m16n8k16", 0, 2 * 16 * 8 * 16)):
        def run():
            check(lib.lib().repro_mma_peak(
                out.data_ptr(), tf32, blocks, iters,
                torch.cuda.current_stream().cuda_stream), "mma_peak")
        ms = time_ms(run, 5, 1)
        rates[name] = round(blocks * 8 * iters * 8 * flops / ms / 1e9, 1)
    return rates


def main(argv=None) -> int:
    """Build the variants and time them at each shape."""
    import argparse
    import torch
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--f32", action="store_true",
                   help="the split 3×TF32 kernel at the f32 shapes")
    args = p.parse_args(argv)
    dtype = torch.float32 if args.f32 else torch.bfloat16
    if not torch.cuda.is_available():
        print("flash_fwd_anatomy: no CUDA device is available",
              file=sys.stderr)
        return 1
    from chip_smoke import card_line, time_ms
    from repro_torch.device import resolve_device
    from repro_torch.kernels.build import build_all
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.flash_attention.ref import NEG_INF
    print(card_line(), flush=True)
    resolve_device("cuda")
    libs = variant_libraries(F32_VARIANTS if args.f32 else VARIANTS)
    peak = peak_library() if args.f32 else None
    build_all(list(libs.values()) + ([peak] if peak else []))
    if peak:
        print(f"peak mma.sync TFLOP/s: {json.dumps(mma_peak(peak))}",
              flush=True)
    dev = torch.device("cuda")
    for label, b, h, kv, s, d, causal, window, padded in (
            F32_SHAPES if args.f32 else SHAPES):
        g = torch.Generator(device=dev).manual_seed(1)
        q = torch.randn((b * h, s, d), generator=g, device=dev).to(dtype)
        k, v = (torch.randn((b * kv, s, d), generator=g, device=dev)
                .to(dtype) for _ in range(2))
        bias = None
        if padded:
            lens = torch.randint(1, s + 1, (b,), generator=g, device=dev)
            bias = torch.where(torch.arange(s, device=dev)[None, :]
                               < lens[:, None], 0.0, NEG_INF).float()
        plan = fa.fwd_plan(b * h, s, s, d, dtype)
        times = {}
        names = list(libs)
        for name in names + names[::-1]:
            times.setdefault(name, []).append(round(time_ms(
                lambda: launch(libs[name], q, k, v, bias, causal, window,
                               plan)), 4))
        print(f"anatomy {label} s {s} d {d} plan {tuple(plan)}: "
              f"{json.dumps(times)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
