"""Where the time of the bf16 flash-attention forward kernel goes.

    python3 scripts/flash_fwd_anatomy.py

Needs one CUDA card and the CUDA toolkit; exits non-zero without a card.
Builds the committed ``flash_fwd.cu`` and four variants of it, each with
one part of the tensor-core kernel's work taken out, into
``build/anatomy/``, then times all five in turns (each variant, then in
reverse order) at the main paths' bf16 shapes with the launch plan of
``ops.fwd_plan``:

- ``full``: the kernel as committed;
- ``staging``: no arithmetic at all, only the q and k/v staging, the
  barriers and the output stores (the tile loop's body never runs);
- ``no_exp``: the softmax's ``ex2`` replaced by a multiply;
- ``no_pv``: the p·v products replaced by one add per fragment;
- ``no_qk``: the q·kᵀ products replaced by one add per fragment.

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

# (label, batch, heads, kv heads, s, d, causal, window, key padding)
SHAPES = (("image bh 3072", 256, 12, 12, 196, 64, False, None, False),
          ("text bh 4096", 256, 16, 16, 16, 64, False, None, True),
          ("prefill bh 32 / kv 8", 1, 32, 8, 512, 64, True, 8192, False))


def variant_libraries():
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
    for name, edits in VARIANTS:
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
        lse.data_ptr(), 1, bh, s, k.shape[1], d, bh // k.shape[0],
        bh // bias.shape[0] if bias is not None else 1, int(causal),
        window if window is not None else -1, float(d ** -0.5),
        plan.warps, plan.key_tile, torch.cuda.current_stream().cuda_stream)
    check(rc, "flash_fwd variant launch")


def main() -> int:
    """Build the variants and time them at each shape."""
    import torch
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
    libs = variant_libraries()
    build_all(list(libs.values()))
    dev = torch.device("cuda")
    for label, b, h, kv, s, d, causal, window, padded in SHAPES:
        g = torch.Generator(device=dev).manual_seed(1)
        q = torch.randn((b * h, s, d), generator=g, device=dev).to(
            torch.bfloat16)
        k, v = (torch.randn((b * kv, s, d), generator=g, device=dev)
                .to(torch.bfloat16) for _ in range(2))
        bias = None
        if padded:
            lens = torch.randint(1, s + 1, (b,), generator=g, device=dev)
            bias = torch.where(torch.arange(s, device=dev)[None, :]
                               < lens[:, None], 0.0, NEG_INF).float()
        plan = fa.fwd_plan(b * h, s, s, d, torch.bfloat16)
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
