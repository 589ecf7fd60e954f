"""Where the SSD scan kernel's time goes, on one card: clock stamps.

    python3 scripts/ssd_anatomy.py

Builds a copy of ``src/repro_torch/kernels/ssd_scan/csrc/ssd.cu`` under
``build/anatomy/`` with ``clock64`` and ``%globaltimer`` stamps written at
fixed points of every CTA (lane 0 of each warp), runs the scan once
through ``ops.ssd_scan`` at Mamba-2-130M's widths (h 24, p 64, n 128; the
shapes of ``scripts/ssd_probe.py``) with that copy in place of the
kernel library, and prints, per phase, the mean and largest cycles per
CTA over the grid (warps 0 and 3, which write the intra-chunk output,
warp 3 with the most C·Bᵀ tiles, and warp 4, which builds the chunk state)
and the spread of the CTAs' start and end times (ns; waves show as
starts that come late). The stamp points are text anchors in the source;
an edit there may need an anchor here edited too (the script raises
naming the missing anchor).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from unittest import mock

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.join(HERE, "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

SOURCE = os.path.join(ROOT, "src", "repro_torch", "kernels", "ssd_scan",
                      "csrc", "ssd.cu")
OUT = os.path.join(ROOT, "build", "anatomy")
POINTS = 10       # stamps per warp
STAMPS = (   # (anchor, stamp index, before the anchor, condition)
    ("  load_item(0);\n", 0, True, ""),
    ("    const int s = buf_of(k);\n", 1, True, "k == 0"),
    ("      if (k == mr - 1) {\n        cluster_wait();\n", 2, True, ""),
    ("        if (tid == 128) misc[0] = G;\n", 3, True, ""),
    ("        cluster_arrive();      // the local state and G are published\n"
     "        cluster_wait();\n", 4, False, ""),
    ("        cluster_arrive();      // done reading", 5, True, ""),
    ("  // output pass: y += exp(cum)", 6, True, ""),
    ("    if (more) {\n      __syncthreads();\n      state_update", 7, True,
     "k == 0"),
    ("  cp_async_wait<0>();\n  cluster_wait();   // no CTA leaves", 8, True,
     ""),
)
NAMES = ("start", "first stage landed", "intra output done (warps 0-3)",
         "chunk state done (4-7)", "cluster wait done (4-7)",
         "state passed (4-7)", "chunk pass done", "first output pass written",
         "items done", "end")


def instrument(text: str) -> str:
    """The kernel source with the stamps and a reader entry added."""
    head = ("__device__ long long g_stamps[1 << 19];\n"
            "#define STAMP(k) do { if (lane == 0) { long long gt; asm "
            "volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(gt)); "
            "long long* sp = g_stamps + (((size_t)blockIdx.y * gridDim.x + "
            f"blockIdx.x) * 8 + warp) * {2 * POINTS}; sp[k] = clock64(); "
            f"sp[{POINTS} + k] = gt; }} }} while (0)\n")
    anchor = "namespace {\n\nconstexpr int kThreads"
    if anchor not in text:
        raise KeyError("anchor 'namespace {' not found")
    text = text.replace(anchor, "namespace {\n" + head + "\nconstexpr int "
                        "kThreads", 1)
    for a, k, before, cond in STAMPS:
        if text.count(a) != 1:
            raise KeyError(f"anchor {a!r} found {text.count(a)} times")
        stamp = (f"if ({cond}) " if cond else "") + f"STAMP({k});\n"
        text = text.replace(a, stamp + a if before else a + stamp)
    end = ("  cluster_wait();   // no CTA leaves while another may read its "
           "state\n")
    if text.count(end) != 1:
        raise KeyError("anchor of the kernel's end not found")
    text = text.replace(end, end + "  STAMP(9);\n")
    text += ("\nextern \"C\" int repro_ssd_stamps(void* dst, long long bytes,"
             " int clear) {\n  if (clear) return (int)cudaMemset"
             "(g_stamps_ptr(), 0, (size_t)bytes);\n  return (int)"
             "cudaMemcpyFromSymbol(dst, g_stamps, (size_t)bytes);\n}\n")
    text = text.replace("extern \"C\" int repro_ssd_scan(",
                        "void* g_stamps_ptr() { void* p = nullptr; "
                        "cudaGetSymbolAddress(&p, g_stamps); return p; }\n\n"
                        "extern \"C\" int repro_ssd_scan(", 1)
    return text


def main() -> int:
    """Build the stamped copy, run each shape once, print the phases."""
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("ssd_anatomy: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.ssd_scan import ops as ssd
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.sm", "--format=csv,noheader"],
                         capture_output=True, text=True,
                         check=True).stdout.strip(), flush=True)
    os.makedirs(OUT, exist_ok=True)
    src = os.path.join(OUT, "ssd_stamped.cu")
    with open(SOURCE) as f:
        text = instrument(f.read())
    # the copy includes tc.cuh by a path relative to its own directory
    text = text.replace('#include "../../flash_attention/csrc/tc.cuh"',
                        '#include "' + os.path.abspath(os.path.join(
                            ROOT, "src", "repro_torch", "kernels",
                            "flash_attention", "csrc", "tc.cuh")) + '"')
    with open(src, "w") as f:
        f.write(text)
    sigs = dict(ssd.LIB.signatures)
    sigs["repro_ssd_stamps"] = (ctypes.c_int, [ctypes.c_void_p,
                                               ctypes.c_longlong,
                                               ctypes.c_int])
    lib = build.KernelLibrary("ssd_stamped", src, sigs)
    handle = lib.lib()
    for label, b, l, dt_name, init in (("b1 l256", 1, 256, "bfloat16", False),
                                       ("b1 l256", 1, 256, "float32", False),
                                       ("b1 l1024", 1, 1024, "float32",
                                        False),
                                       ("b8 l256", 8, 256, "float32", True)):
        dtype = getattr(torch, dt_name)
        args = cs.ssd_inputs(b, l, dtype, 60, init)
        plan = ssd.ssd_plan(b, l, 24, 64, 128, dtype)
        n = plan.ctas * 8 * 2 * POINTS
        host = np.zeros(n, dtype=np.int64)
        with mock.patch.object(ssd, "LIB", lib):
            for _ in range(3):
                ssd.ssd_scan(*args[:6], chunk=256, init_state=args[6])
            torch.cuda.synchronize()
            handle.repro_ssd_stamps(None, n * 8, 1)
            ssd.ssd_scan(*args[:6], chunk=256, init_state=args[6])
            torch.cuda.synchronize()
        rc = handle.repro_ssd_stamps(host.ctypes.data, n * 8, 0)
        if rc:
            raise RuntimeError(f"stamps read: CUDA error {rc}")
        st = host.reshape(plan.ctas, 8, 2, POINTS)
        print(f"{label} {dt_name}: plan {tuple(plan)}", flush=True)
        for w in (0, 3, 4):
            clk = st[:, w, 0, :].astype(np.float64)
            prev = clk[:, 0]
            for k in range(1, POINTS):
                ok = clk[:, k] > 0
                if not ok.any():
                    continue
                d = clk[ok, k] - prev[ok]
                print(f"  warp {w} {NAMES[k - 1]} -> {NAMES[k]}: mean "
                      f"{d.mean():.0f} cycles, max {d.max():.0f}", flush=True)
                prev = np.where(ok, clk[:, k], prev)
        gt = st[:, 0, 1, :]
        start, end = gt[:, 0], gt[:, POINTS - 1]
        t0 = start.min()
        print(f"  CTA start (ns after the first): quartiles "
              f"{np.percentile(start - t0, [0, 25, 50, 75, 100]).tolist()}; "
              f"end {np.percentile(end - t0, [0, 25, 50, 75, 100]).tolist()}"
              f"; CTA duration mean {(end - start).mean():.0f} ns",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
