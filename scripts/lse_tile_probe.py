"""Time the contrastive forward under each tile edge ``lse_plan`` can pick.

    python3 scripts/lse_tile_probe.py

At the training shape's depth (D 512) and batches B 2048 and a ragged
1000, f32 and bf16, ``fwd_fused`` (the tile kernel and its combine, which
``row_col_lse`` shares) runs with its plan forced to each tile edge of
``ops.LSE_TILES`` that the kernel takes (bf16: 64 and 32); each result is
held against the plain version (5e-5, ``chip_smoke.CL_LSE_TOL``), and its
device time per call comes from
``torch.profiler`` (``chip_smoke.device_ms``), the tiles of one shape
timed in turns (forward order, then backward) and averaged. Prints one
line per shape and tile, marking ``lse_plan``'s own choice, then
``PROBE <json>``. Needs a card; exits non-zero without one.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from unittest import mock

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, ".."))
sys.path.insert(0, os.path.join(HERE, "..", "src"))


def main() -> int:
    """Time every tile edge at every shape; returns the exit code."""
    import torch
    if not torch.cuda.is_available():
        print("lse_tile_probe: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels.contrastive_loss import ops as cl
    from repro_torch.kernels.contrastive_loss.ref import fwd_fused_ref
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    out = {}
    for b in (2048, 1000):
        for dt in (torch.float32, torch.bfloat16):
            g = torch.Generator(device="cuda").manual_seed(b)
            x, y = cs.unit_rows(b, 512, g, dt), cs.unit_rows(b, 512, g, dt)
            it = torch.tensor(1 / 0.07, device="cuda")
            want = fwd_fused_ref(x, y, it)
            # bf16 at 128 spills; the kernel takes 64 and 32 only
            tiles = cl.LSE_TILES if dt == torch.float32 else cl.LSE_TILES[1:]
            times = {t: [] for t in tiles}
            for order in (tiles, tuple(reversed(tiles))):
                for tile in order:
                    n = -(-b // tile)
                    plan = cl.LsePlan(tile, n, (n, n), 4 * n * b)
                    with mock.patch.object(cl, "lse_plan",
                                           lambda *_: plan):
                        got = cl.fwd_fused(x, y, it)
                        err = max((a - r).abs().max().item()
                                  for a, r in zip(got, want))
                        if not err <= cs.CL_LSE_TOL:
                            raise AssertionError(f"B {b} {dt} tile {tile}: "
                                                 f"lse error {err:.3g}")
                        ms, _ = cs.device_ms(
                            lambda: cl.fwd_fused(x, y, it),
                            cs.WRAPPER_KERNELS["contrastive_fwd"])
                        times[tile].append(ms)
            chosen = cl.lse_plan(b, dt).tile
            name = str(dt).removeprefix("torch.")
            for tile, runs in times.items():
                ms = sum(runs) / len(runs)
                out[f"B{b} D512 {name} tile {tile}"] = {
                    "device_ms": ms, "runs": runs, "plan": tile == chosen}
                print(f"fwd_fused B {b} D 512 {name} tile {tile}"
                      f"{' (lse_plan)' if tile == chosen else ''}: device "
                      f"{ms:.4f} ms (runs {runs})", flush=True)
    print("PROBE", json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
