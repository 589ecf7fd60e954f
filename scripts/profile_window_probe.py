"""How often a ``chip_smoke.profile_window`` loses its device records, with
and without a pause (``settle``) after each profiler step's synchronise.

    python3 scripts/profile_window_probe.py [--rounds 14]

Needs one CUDA card. Each round runs 4 s of fp32 matmuls (the card busy
between windows, as the smoke test's phases leave it), then windows over
20 calls of ``scaled_dot_product_attention`` at Mixtral-8x22B's attention
shapes (48 heads over 8, d 128, causal): six short ones (s 512, bf16, a
few ms) and two long ones (s 4608, fp32, about 0.5 s) with no pause and
device activity only, three short ones with no pause and host activity
too, and six short ones with the pause. A window is lost when the
profiler's raw results hold no device record; the script prints, for each
kind, windows and lost windows, and the raw record counts and time ranges
of each lost window (and of one kept window in 25).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
# the pause after each profiler step's synchronise (``settle``)
PAUSE_S = 0.1


def raw_records(prof):
    """Device and host records in the profiler's raw results, with the
    time range (ns) of each kind."""
    evs = prof.profiler.kineto_results.events()
    dev = [e for e in evs if str(e.device_type()).endswith("CUDA")]
    host = [e for e in evs if not str(e.device_type()).endswith("CUDA")]

    def span(es):
        if not es:
            return None
        return (min(e.start_ns() for e in es),
                max(e.start_ns() + e.duration_ns() for e in es))
    return {"device": len(dev), "host": len(host),
            "device_ns": span(dev), "host_ns": span(host)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=14)
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("profile_window_probe: no CUDA card", file=sys.stderr)
        return 1
    print(cs.card_line(), flush=True)
    t0 = time.time()

    def attention(s, dtype):
        g = torch.Generator(device="cuda").manual_seed(s)
        q, k, v = (torch.randn(1, h, s, 128, generator=g, device="cuda",
                               dtype=dtype) for h in (48, 8, 8))
        return lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)
    short = attention(512, torch.bfloat16)
    long = attention(4608, torch.float32)
    a = torch.randn(8192, 8192, device="cuda")

    def busy(seconds):
        end = time.time() + seconds
        while time.time() < end:
            for _ in range(10):
                a @ a
            torch.cuda.synchronize()

    stats = {}

    def windows(kind, fn, reps, cpu, settle):
        for _ in range(reps):
            with cs.profile_window(cpu, settle=settle) as prof:
                for _ in range(20):
                    fn()
                torch.cuda.synchronize()
            rec = raw_records(prof)
            n = stats.setdefault(kind, {"windows": 0, "lost": 0})
            n["windows"] += 1
            if rec["device"] == 0:
                n["lost"] += 1
                print(f"{time.time() - t0:7.1f}s lost {kind}: {rec}",
                      flush=True)
            elif n["windows"] % 25 == 1:
                print(f"{time.time() - t0:7.1f}s kept {kind}: {rec}",
                      flush=True)

    for r in range(args.rounds):
        busy(4.0)
        windows("short, no pause", short, 6, False, 0.0)
        windows("long, no pause", long, 2, False, 0.0)
        windows("short, no pause, host too", short, 3, True, 0.0)
        windows(f"short, pause {PAUSE_S} s", short, 6, False, PAUSE_S)
        print(f"{time.time() - t0:7.1f}s round {r}: {json.dumps(stats)}",
              flush=True)
    print(json.dumps(stats), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
