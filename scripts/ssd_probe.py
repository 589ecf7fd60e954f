"""Time the SSD scan kernel under each launch plan it takes, on one card.

    python3 scripts/ssd_probe.py [--iters N]

At Mamba-2-130M's widths (h 24, p 64, n 128; x, B and C as the mixer's
split views) and the five shapes ``chip_smoke.py`` and ``chip_ab.py`` time
(b 1 × l 256 bf16 and f32, b 1 × l 1024 f32, b 8 × l 256 f32, l 244 bf16
with an initial state), the scan runs under ``ops.ssd_plan`` and under
plans forced through its arguments: each head_dim block (64, 32, 16), at
most 2 or 4 CTAs along the sequence, one staging buffer. Each plan's
result is held against the plain version (``SSD_TOL_REL`` of max |ref|,
y and the final state); its device time per call comes from
``torch.profiler`` (``chip_smoke.device_ms``), the plans of one shape
timed in turns (forward order, then backward) and averaged. Prints one
line per shape and plan, then ``PROBE <json>``. Needs a card; exits
non-zero without one.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
from unittest import mock

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, ".."))
sys.path.insert(0, os.path.join(HERE, "..", "src"))

SHAPES = (("b1 l256", 1, 256, "bfloat16", False),
          ("b1 l256", 1, 256, "float32", False),
          ("b1 l1024", 1, 1024, "float32", False),
          ("b8 l256", 8, 256, "float32", True),
          ("b1 l244 init", 1, 244, "bfloat16", True))
FORCED = ({}, {"p_block": 64}, {"p_block": 32}, {"p_block": 16},
          {"max_cluster": 2}, {"max_cluster": 4}, {"stages": 1})


def main(argv=None) -> int:
    """Time every plan at every shape; returns the exit code."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=20)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("ssd_probe: no CUDA device is available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels.ssd_scan import ops as ssd
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    ssd.LIB.lib()
    plan_of = ssd.ssd_plan
    out = {}
    for label, b, l, dt_name, init in SHAPES:
        dtype = getattr(torch, dt_name)
        x, dt, A, Bm, Cm, D, s0 = cs.ssd_inputs(b, l, dtype, 60, init)
        want = cs.plain_scan(x, dt, A, Bm, Cm, D, chunk=256, init_state=s0)
        plans = {}
        for force in FORCED:
            try:
                plan = plan_of(b, l, 24, 64, 128, dtype, **force)
            except ValueError:
                continue
            if tuple(plan) not in {tuple(q) for q in plans.values()}:
                plans[json.dumps(force)] = plan
        times = {k: [] for k in plans}
        for order in (list(plans), list(reversed(plans))):
            for key in order:
                force = json.loads(key)
                with mock.patch.object(ssd, "ssd_plan", functools.partial(
                        plan_of, **force)):
                    def call():
                        return ssd.ssd_scan(x, dt, A, Bm, Cm, D, chunk=256,
                                            init_state=s0)
                    got = call()
                    err = max(((a - r).abs().max() / r.abs().max()).item()
                              for a, r in zip(got, want))
                    if not err <= cs.SSD_TOL_REL:
                        raise AssertionError(f"{label} {dt_name} {key}: "
                                             f"relative error {err:.3g}")
                    ms, _ = cs.device_ms(call, cs.WRAPPER_KERNELS["ssd_scan"],
                                         args.iters)
                    times[key].append(ms)
        for key, plan in plans.items():
            ms = sum(times[key]) / len(times[key])
            out[f"{label} {dt_name} {key}"] = {"plan": plan._asdict(),
                                               "device_ms": ms,
                                               "runs": times[key]}
            print(f"{label} {dt_name} force {key}: plan {tuple(plan)}: "
                  f"device {ms:.4f} ms (runs {times[key]})", flush=True)
    print("PROBE", json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
