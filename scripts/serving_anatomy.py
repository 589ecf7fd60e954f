"""Where the serving kernels' time goes, on one CUDA card.

    python3 scripts/serving_anatomy.py

Builds copies of ``decode_attention``'s and ``similarity_topk``'s CUDA
sources with ``clock64`` / ``%globaltimer`` stamps added around their
phases (into ``build/anatomy/``; the kernels under ``src`` are not
touched), runs each at the main paths' shapes and prints, per shape:

- ``decode_attention`` bf16 (Llama-3.2-1B: 8 slots, 32 heads over 8, d 64,
  a cache of 8192) at the serving state (lengths 508-571) and at a full
  cache: per warp that swept a unit, the median cycles of the mask scan,
  waiting for its loads, issuing its loads, computing (scores, softmax,
  p·v) and the chunk-end folds, and the units it swept;
- ``similarity_topk`` f32 (d 512, k 5) at b 16 × n 512 and b 64 ×
  n 21841: per CTA the median cycles of waiting for its loads (with the
  barrier), issuing them, the multiply-adds and the selection; and, for
  the CTA that finishes the merge tree, the nanoseconds of its group merge
  and of the final merge;

then the device time per call of the kernels as they are (torch.profiler)
and the card's name and power limit. The stamps cost a little themselves,
so the phases of an instrumented run add up to somewhat more than the
uninstrumented time. Needs a card; exits non-zero without one.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels")
TC = os.path.join(CSRC, "flash_attention", "csrc", "tc.cuh")
OUT = os.path.join(ROOT, "build", "anatomy")
DBG = """__device__ unsigned long long g_dbg[65536 * 8];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long v;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(v));
  return v;
}
extern "C" int dbg_read(void* host) {
  return (int)cudaMemcpyFromSymbol(host, g_dbg, sizeof(g_dbg));
}
namespace {
"""

# (anchor in the source, text that replaces it); each anchor must appear
DECODE_STAMPS = [
    ("namespace {\n", DBG),
    ("  const int ncta = (n_chunks - y + C - 1) / C;   // chunks of this CTA\n",
     "  const int ncta = (n_chunks - y + C - 1) / C;   // chunks of this CTA\n"
     "  unsigned long long c0 = clock64(), c_issue = 0, c_wait = 0, "
     "c_comp = 0, c_fold = 0, c_scan = 0, n_units = 0;\n"),
    ("  __syncthreads();\n  // 2. a chunk with no valid key",
     "  __syncthreads();\n  c_scan = clock64() - c0;\n"
     "  // 2. a chunk with no valid key"),
    ("      cp_async_wait<L::S - 2>();\n      __syncwarp();\n"
     "      issue(jp, (n + L::S - 1) % L::S);\n"
     "      if (jp < nj) jp = next_live(jp + 1);\n",
     "      unsigned long long b0 = clock64();\n"
     "      cp_async_wait<L::S - 2>();\n      __syncwarp();\n"
     "      unsigned long long b1 = clock64();\n"
     "      issue(jp, (n + L::S - 1) % L::S);\n"
     "      if (jp < nj) jp = next_live(jp + 1);\n"
     "      unsigned long long b2 = clock64();\n"
     "      c_wait += b1 - b0; c_issue += b2 - b1; ++n_units;\n"),
    ("      ++n;\n      jc = next_live(jc + 1);\n    }\n",
     "      ++n;\n      jc = next_live(jc + 1);\n"
     "      c_comp += clock64() - b2;\n    }\n"
     "    unsigned long long b3 = clock64();\n"),
    ("    __syncthreads();   // Racc is read before the next chunk writes p\n"
     "  }\n  cp_async_wait<0>();\n}",
     "    __syncthreads();   // Racc is read before the next chunk writes p\n"
     "    c_fold += clock64() - b3;\n  }\n  cp_async_wait<0>();\n"
     "  if (lane == 0) {\n"
     "    unsigned long long* o = g_dbg + (((size_t)(blockIdx.x * gridDim.y"
     " + blockIdx.y) * gridDim.z + blockIdx.z) * kWarps + warp) * 8;\n"
     "    o[0] = c_scan; o[1] = c_wait; o[2] = c_issue; o[3] = c_comp;\n"
     "    o[4] = c_fold; o[5] = n_units;\n  }\n}"),
]

TOPK_STAMPS = [
    ("namespace {\n", DBG),
    ("  const int part = blockIdx.x, rb = blockIdx.y, row0 = rb * BM;\n",
     "  const int part = blockIdx.x, rb = blockIdx.y, row0 = rb * BM;\n"
     "  const int cta = blockIdx.x + blockIdx.y * gridDim.x;\n"
     "  unsigned long long c_wait = 0, c_issue = 0, c_fma = 0, c_sel = 0;\n"),
    ("    cp_async_wait<L::S - 2>();\n"
     "    __syncthreads();          // chunk q is in; chunk q - 1's slot is "
     "free\n    issue(q + L::S - 1);\n",
     "    unsigned long long a0 = clock64();\n"
     "    cp_async_wait<L::S - 2>();\n"
     "    __syncthreads();          // chunk q is in; chunk q - 1's slot is "
     "free\n    unsigned long long a1 = clock64();\n"
     "    issue(q + L::S - 1);\n    unsigned long long a2 = clock64();\n"
     "    c_wait += a1 - a0; c_issue += a2 - a1;\n"),
    ("    if (kc != nK - 1) continue;\n",
     "    unsigned long long a3 = clock64(); c_fma += a3 - a2;\n"
     "    if (kc != nK - 1) continue;\n"),
    ("      merge_half(tv, ti, RV, RI, K, nr, lane);\n    }\n  }\n"
     "  cp_async_wait<0>();",
     "      merge_half(tv, ti, RV, RI, K, nr, lane);\n    }\n"
     "    c_sel += clock64() - a3;\n  }\n  cp_async_wait<0>();\n"
     "  if (tid == 0) {\n    unsigned long long* o = g_dbg + cta * 8;\n"
     "    o[0] = c_wait; o[1] = c_issue; o[2] = c_fma; o[3] = c_sel;\n  }"),
    ("  merge_rows(part_v, part_i, PKS, grp * kGroup, gsize, group_v, "
     "group_i, GKS,\n             grp * K);\n",
     "  unsigned long long m0 = gtime();\n"
     "  merge_rows(part_v, part_i, PKS, grp * kGroup, gsize, group_v, "
     "group_i, GKS,\n             grp * K);\n"
     "  unsigned long long m1 = gtime();\n"),
    ("  merge_rows(group_v, group_i, GKS, 0, NG, out_v, out_i, K, 0);\n}",
     "  unsigned long long m2 = gtime();\n"
     "  merge_rows(group_v, group_i, GKS, 0, NG, out_v, out_i, K, 0);\n"
     "  if (tid == 0) {\n    g_dbg[60000 * 8] = m1 - m0;\n"
     "    g_dbg[60000 * 8 + 1] = gtime() - m2;\n  }\n}"),
]


def instrumented(lib, stamps, name):
    """A KernelLibrary for a copy of ``lib``'s source with ``stamps``
    applied and the shared header included by its absolute path."""
    from repro_torch.kernels import build as kb
    with open(lib.source) as f:
        text = f.read()
    text = text.replace('#include "../../flash_attention/csrc/tc.cuh"',
                        f'#include "{TC}"')
    for anchor, new in stamps:
        if anchor not in text:
            raise RuntimeError(f"{name}: the source no longer has {anchor!r}")
        text = text.replace(anchor, new, 1)
    os.makedirs(OUT, exist_ok=True)
    path = os.path.join(OUT, f"{name}.cu")
    with open(path, "w") as f:
        f.write(text)
    sig = dict(lib.signatures)
    sig["dbg_read"] = (ctypes.c_int, [ctypes.c_void_p])
    return kb.KernelLibrary(f"anatomy_{name}", path, sig)


def read(lib):
    """The stamp buffer after the last launch, as uint64 (65536, 8)."""
    import numpy as np
    buf = np.zeros((65536, 8), dtype=np.uint64)
    if lib.lib().dbg_read(buf.ctypes.data) != 0:
        raise RuntimeError("reading the stamps failed")
    return buf.astype(np.float64)


def main() -> int:
    """Run both anatomies; returns the exit code."""
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("serving_anatomy: no CUDA device is available", file=sys.stderr)
        return 1
    from chip_smoke import device_ms, unit_rows
    from repro_torch.kernels import build as kb
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.similarity_topk import ops as tk

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    dec_i = instrumented(dec.LIB, DECODE_STAMPS, "decode")
    tk_i = instrumented(tk.LIB, TOPK_STAMPS, "topk")
    kb.build_all([dec.LIB, tk.LIB, dec_i, tk_i])

    ar = torch.arange(8192, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(40)
    q = torch.randn((8, 32, 64), generator=g, device="cuda").bfloat16()
    k, v = (torch.randn((8, 8, 8192, 64), generator=g, device="cuda")
            .bfloat16() for _ in range(2))
    for state, lens in (("serving", [508 + 9 * i for i in range(8)]),
                        ("full", [8192] * 8)):
        valid = ar[None, :] < torch.tensor(lens, device="cuda")[:, None]
        call = lambda: dec.decode_attention(q, k, v, valid)
        base_ms, _ = device_ms(call, ("decode_",))
        dec.LIB._lib, kept = dec_i.lib(), dec.LIB._lib
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        dec.LIB._lib = kept
        plan = dec.launch_plan(q, k)
        d = read(dec_i)[:plan.grid[0] * plan.grid[1] * plan.grid[2] * 4]
        swept = d[d[:, 5] > 0]
        med = np.median(swept, axis=0)
        print(f"decode_attention bf16 {state} ({sum(lens)} valid): device "
              f"{base_ms:.4f} ms per call; {len(swept)} of {len(d)} warps "
              f"swept units; per such warp, median cycles: scan "
              f"{med[0]:.0f}, wait {med[1]:.0f}, issue {med[2]:.0f}, "
              f"compute {med[3]:.0f}, fold {med[4]:.0f}; units "
              f"{med[5]:.0f}", flush=True)

    g = torch.Generator(device="cuda").manual_seed(4)
    for b, n in ((16, 512), (64, 21841)):
        x, c = unit_rows(b, 512, g, torch.float32), unit_rows(n, 512, g,
                                                              torch.float32)
        call = lambda: tk.similarity_topk(x, c, 5, inv_tau=1 / 0.07)
        base_ms, _ = device_ms(call, ("topk_",))
        tk.LIB._lib, kept = tk_i.lib(), tk.LIB._lib
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        tk.LIB._lib = kept
        plan = tk.topk_plan(b, n, 512, 5, 4, torch.cuda.get_device_properties(
            0).multi_processor_count)
        d = read(tk_i)
        med = np.median(d[:plan.parts * plan.row_blocks, :4], axis=0)
        print(f"similarity_topk f32 b={b} n={n} ({plan.parts} CTAs): device "
              f"{base_ms:.4f} ms per call; per CTA, median cycles: wait "
              f"{med[0]:.0f}, issue {med[1]:.0f}, multiply-add {med[2]:.0f}, "
              f"select {med[3]:.0f}; merging CTA: group merge "
              f"{d[60000, 0]:.0f} ns, final merge {d[60000, 1]:.0f} ns",
              flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
