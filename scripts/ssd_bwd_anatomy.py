"""Where the SSD scan backward's time goes, on the card.

Builds the committed ``csrc/ssd_bwd.cu`` and variants of it, each with one
part of the main kernel's work taken out (by text edits of the source,
whose anchors must each occur once; it raises naming a missing one) or
one part made cheaper, into ``build/anatomy/``, and times every variant's
four device kernels by name (torch.profiler, mean over the calls of a
window) at the training shape (b 2 × l 4096, h 24, p 64, n 128), f32 and
bf16, in turns: base, each variant, base. A variant without a part gives
wrong gradients; only its time is read. A ``peak`` line gives the card's
mma.sync rate (``flash_fwd_anatomy.py``'s loop of independent products),
and each dtype's block the main kernel's tensor-core FLOPs a call
(``main_kernel_flops``, counted from the plan) over its device time.
Run on the card from the repo's root:

    python3 scripts/ssd_bwd_anatomy.py [--calls 20]

about a minute of command (the variants build in parallel).
"""
from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys

ROOT = os.path.normpath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# name -> [(anchor, replacement)]: each takes out or changes one part
VARIANTS = {
    "no dy·uᵀ (V)": [("      mma_tiles<1, 2, false, false>(\n"
                      "          acc, 0, PB,",
                      "      if (false) mma_tiles<1, 2, false, false>(\n"
                      "          acc, 0, PB,")],
    "no B·Rᵀ": [("      mma_tiles<2, 1, BF, false>(",
                 "      if (false) mma_tiles<2, 1, BF, false>(")],
    "no Wᵀ·dy": [("        mma_tiles<1, 1, false, false>(\n"
                  "            acc + m, 16 * mt, kQ,",
                  "        if (false) mma_tiles<1, 1, false, false>(\n"
                  "            acc + m, 16 * mt, kQ,")],
    "no (u·dec)·R": [("    mma_tiles<2, NTW, false, false>(\n"
                      "        dbacc, 0, PB,",
                      "    if (false) mma_tiles<2, NTW, false, false>(\n"
                      "        dbacc, 0, PB,")],
    "no (dy·ecs)·S0": [("      mma_tiles<2, NTW, false, false>(\n"
                        "          z, 0, PB,",
                        "      if (false) mma_tiles<2, NTW, false, false>(\n"
                        "          z, 0, PB,")],
    "no (ΣV)ᵀ·C, (ΣV)·B": [("    mma_tiles<1, NTW, false, BF>(\n"
                           "        dbacc + m,",
                           "    if (false) mma_tiles<1, NTW, false, BF>(\n"
                           "        dbacc + m,"),
                          ("    mma_tiles<1, NTW, false, BF>(\n"
                           "        dcacc + m,",
                           "    if (false) mma_tiles<1, NTW, false, BF>(\n"
                           "        dcacc + m,")],
    "fast exp (ex2.approx)": [("expf(cs[kk] - ci)", "__expf(cs[kk] - ci)"),
                              ("expf(cs[kk + 1] - ci)",
                               "__expf(cs[kk + 1] - ci)"),
                              ("acc[0][j][e] * expf(cs[i] - cs[jj])",
                               "acc[0][j][e] * __expf(cs[i] - cs[jj])")],
}


def main_kernel_flops(b, l, h, p, n, dtype) -> float:
    """The tensor-core FLOPs one call's main kernel issues (two a
    multiply-add, every mma of a split 3×TF32 product counted), from the
    plan and the kernel's loops: C·Bᵀ on the 10 causal blocks, then per
    item (head and slab) dy·uᵀ on them, B·Rᵀ, the causal Wᵀ·dy, the dB and
    dC state products over nmax columns, and (Σ V)ᵀ·C and (Σ V)·B once."""
    import torch
    from repro_torch.kernels.ssd_scan import ops
    plan = ops.ssd_bwd_plan(b, l, h, p, n, dtype)
    pb, nmax = plan.p_block, 128 if n <= 128 else 256
    np16 = -(-n // 16) * 16
    x = 2 if dtype == torch.bfloat16 else 3   # mma per tile-step, one exact
    tile = 2 * 16 * 8 * 8                      # FLOPs of one m16n8k8
    cb = 10 * 2 * (np16 // 8) * (1 if x == 2 else 3)
    item = (10 * 2 * (pb // 8) * 3                 # dy·uᵀ
            + 4 * (pb // 8) * (np16 // 8) * x     # B·Rᵀ
            + (pb // 8) * 20 * 3                  # Wᵀ·dy, 8 + 6 + 4 + 2 steps
            + 2 * 4 * (nmax // 8) * (pb // 8) * 3)   # (u·dec)·R, (dy·ecs)·S0
    final = 2 * 20 * (nmax // 8) * x
    items = plan.group * (p // pb)
    return plan.grid[0] * plan.grid[1] * (cb + items * item + final) * tile


def variant_source(text: str, edits) -> str:
    for anchor, repl in edits:
        if text.count(anchor) != 1:
            raise ValueError(f"anchor occurs {text.count(anchor)} times in "
                             f"ssd_bwd.cu, not once: {anchor!r}")
        text = text.replace(anchor, repl)
    return text


def libraries():
    """(name, KernelLibrary) for the committed source and each variant."""
    from repro_torch.kernels.build import KernelLibrary
    from repro_torch.kernels.ssd_scan import ops
    src_dir = os.path.dirname(ops.BWD_LIB.source)
    tc = os.path.normpath(os.path.join(src_dir, "..", "..",
                                       "flash_attention", "csrc", "tc.cuh"))
    with open(ops.BWD_LIB.source) as f:
        text = f.read()
    text = text.replace('#include "../../flash_attention/csrc/tc.cuh"',
                        f'#include "{tc}"')
    out_dir = os.path.join(ROOT, "build", "anatomy")
    os.makedirs(out_dir, exist_ok=True)
    libs = [("base", ops.BWD_LIB)]
    for i, (name, edits) in enumerate(VARIANTS.items()):
        path = os.path.join(out_dir, f"ssd_bwd_v{i}.cu")
        with open(path, "w") as f:
            f.write(variant_source(text, edits))
        libs.append((name, KernelLibrary(f"ssd_bwd_v{i}", path,
                                         ops.BWD_LIB.signatures)))
    return libs


def timed(lib, args, calls):
    """Device milliseconds per call by kernel (short name) of ``lib``'s
    backward on ``args``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.ssd_scan import ops
    saved, ops.BWD_LIB = ops.BWD_LIB, lib
    try:
        ops.ssd_scan_bwd(*args)
        torch.cuda.synchronize()
        for attempt in range(8):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    ops.ssd_scan_bwd(*args)
                torch.cuda.synchronize()
            by = {}
            for e in prof.events():
                m = re.search(r"ssd_bwd_(\w+?)_kernel", e.name)
                if m and str(getattr(e, "device_type", "")).endswith("CUDA"):
                    by[m.group(1)] = (by.get(m.group(1), 0.0)
                                      + e.time_range.elapsed_us() / 1e3)
            if len(by) == 4:
                break
    finally:
        ops.BWD_LIB = saved
    return {k: v / calls for k, v in by.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=20)
    a = ap.parse_args(argv)
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.build import build_all
    from repro_torch.kernels.ssd_scan import ops
    if not torch.cuda.is_available():
        print("ssd_bwd_anatomy: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    libs = libraries()
    import shutil
    from flash_fwd_anatomy import mma_peak, peak_library
    shutil.copy(os.path.join(os.path.dirname(ops.BWD_LIB.source), "..", "..",
                             "flash_attention", "csrc", "tc.cuh"),
                os.path.join(ROOT, "build", "anatomy"))
    peak = peak_library()
    build_all([lib for _, lib in libs] + [ops.LIB, peak])
    print(f"peak: the card's mma.sync rate, TFLOP/s {mma_peak(peak)}",
          flush=True)
    b, l, h, p, n = 2, 4096, 24, 64, 128
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator(device="cuda").manual_seed(0)
        buf = torch.randn((b, l, h * p + 2 * n), generator=g,
                          device="cuda").to(dtype)
        x = buf[..., :h * p].reshape(b, l, h, p)
        Bm, Cm = buf[..., h * p:h * p + n], buf[..., h * p + n:]
        dt = F.softplus(torch.randn((b, l, h), generator=g, device="cuda"))
        A = -torch.exp(0.3 * torch.randn((h,), generator=g, device="cuda"))
        D = torch.rand((h,), generator=g, device="cuda")
        fwd = (x, dt, A, Bm, Cm, D, None)
        _, final, states = ops._launch(*fwd, save_states=True)
        dy = torch.randn((b, l, h, p), generator=g, device="cuda")
        args = (*fwd, states, final, dy, None)
        order = [libs[0]] + libs[1:] + [libs[0]]
        rows = [(name, timed(lib, args, a.calls)) for name, lib in order]
        print(f"ssd_scan_bwd b {b} x l {l}, h {h}, p {p}, n {n}, "
              f"{str(dtype)[6:]}: device ms per call by kernel", flush=True)
        for name, by in rows:
            print(f"  {name:24s} total {sum(by.values()):.4f}  " + "  ".join(
                f"{k} {v:.4f}" for k, v in sorted(by.items())), flush=True)
        flops = main_kernel_flops(b, l, h, p, n, dtype)
        main_ms = (rows[0][1]["main"] + rows[-1][1]["main"]) / 2
        print(f"  main kernel: {flops / 1e9:.2f} GFLOP of tensor-core "
              f"products a call, {flops / main_ms / 1e9:.1f} TFLOP/s at "
              f"base's device time", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
