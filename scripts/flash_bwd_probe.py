"""The f32 flash backward's accuracy and time, per checkout, in turns.

    python3 scripts/flash_bwd_probe.py TREE [TREE ...]

Each TREE is a checkout of the repository (for example the parent commit
unpacked with ``git archive`` into an ignored directory, and ``.``); give
them in the order A B B A. For each TREE a fresh process in it (its own
``src`` first on the path, its own kernel build) prints one line
``PROBE <tree> <json>``: at four f32 shapes (d 64) the max abs error of dq,
dk and dv against an fp64 evaluation of the same formula, for the kernel
(``ops.flash_bwd``) and for its plain fp32 version (``flash_bwd_ref``),
and the kernel's mean milliseconds between CUDA events (10 launches after
3 warm-ups) at the image microbatch and the LM shape. The shapes: the LM
training shape (b 4, 32 query heads over 8 kv heads, s 1024, causal), the
same at b 2, the same with 32 kv heads, and the image microbatch (bh
3072, s 196, no mask). An error that grows with the number of queries
summed into a key, where the plain version's does not, is a sum that
drifts.

Needs a card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

PROBE = r'''
import json, sys
import torch
sys.path.insert(0, "src")
sys.path.insert(0, ".")
from chip_smoke import time_ms
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention.ref import (flash_bwd_ref,
                                                     flash_fwd_ref)

resolve_device("cuda")


def exact(q, k, v, dout, causal):
    """dq, dk, dv in fp64 from the formula the kernel computes."""
    bh, s, d = q.shape
    g = bh // k.shape[0]
    qd = q.double() * d ** -0.5
    kd, vd = (x.double().repeat_interleave(g, 0) for x in (k, v))
    sc = qd @ kd.transpose(1, 2)
    if causal:
        keep = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        sc = torch.where(keep, sc, torch.full_like(sc, -1e300))
    p = torch.softmax(sc, -1)
    do = dout.double()
    delta = (do * (p @ vd)).sum(-1)
    ds = p * (do @ vd.transpose(1, 2) - delta[..., None])
    dq = ds @ kd * d ** -0.5
    dk = (ds.transpose(1, 2) @ qd).reshape(k.shape[0], g, s, d).sum(1)
    dv = (p.transpose(1, 2) @ do).reshape(k.shape[0], g, s, d).sum(1)
    return dq, dk, dv


out = {}
for label, b, h, kv, s, causal in (("lm", 4, 32, 8, 1024, True),
                                   ("lm b2", 2, 32, 8, 1024, True),
                                   ("lm kv32", 4, 32, 32, 1024, True),
                                   ("image", 256, 12, 12, 196, False)):
    g = torch.Generator(device="cuda").manual_seed(5)
    q, dout = (torch.randn((b * h, s, 64), generator=g, device="cuda")
               for _ in range(2))
    k, v = (torch.randn((b * kv, s, 64), generator=g, device="cuda")
            for _ in range(2))
    o, lse = flash_fwd_ref(q, k, v, causal=causal)
    args = (q, k, v, None, o, lse, dout)
    got = fa.flash_bwd(*args, causal=causal)
    plain = flash_bwd_ref(*args, causal=causal)
    want = exact(q, k, v, dout, causal)
    rec = {}
    for name, x, r, e in zip(("dq", "dk", "dv"), got, plain, want):
        rec[name] = {"max_exact": e.abs().max().item(),
                     "kernel": (x.double() - e).abs().max().item(),
                     "plain": (r.double() - e).abs().max().item()}
    if label in ("lm", "image"):
        rec["ms"] = time_ms(lambda: fa.flash_bwd(*args, causal=causal),
                            iters=10)
    out[label] = rec
    del q, k, v, dout, o, lse, got, plain, want, args
    torch.cuda.empty_cache()
print("PROBE", json.dumps(out))
'''


def main(argv=None) -> int:
    """Run the probe in each tree in turn; returns the exit code."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="+")
    args = ap.parse_args(argv)
    for tree in args.trees:
        res = subprocess.run([sys.executable, "-c", PROBE],
                             cwd=os.path.abspath(tree), capture_output=True,
                             text=True, timeout=900)
        line = [x for x in res.stdout.splitlines() if x.startswith("PROBE ")]
        if res.returncode != 0 or not line:
            print(f"{tree}: failed\n{res.stderr[-3000:]}", flush=True)
            return 1
        print(f"PROBE {tree} {line[0][len('PROBE '):]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
