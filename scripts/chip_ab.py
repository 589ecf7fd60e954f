"""Compare checkouts of the repository on one CUDA card, in turns.

    python3 scripts/chip_ab.py [--train] [--kernels] [--serve] [--ssd]
                               [--ssm-train] TREE [TREE ...]

Each TREE is a checkout of the repository (for example the parent commit
unpacked with ``git archive`` into an ignored directory, and ``.``). Give
them in the order A B B A: the card's clocks drift over a call, so two
versions are compared only within one call and in turns. For each TREE the
script starts a fresh process in it (its own ``src`` first on the path, its
own kernel build directory) and prints one line ``AB <tree> <json>``:

- ``--kernels``: kernels at the main paths' shapes, mean device ms
  between CUDA events (``chip_smoke.time_ms``), each with its max abs
  error against its plain version (and, for the two serving kernels, the
  device time of their device kernels per call from ``torch.profiler``):
  ``decode_attention`` bf16 at Llama-3.2-1B's serving state (8 slots, 32
  heads over 8, d 64, a cache of 8192 with lengths 508-571) and at a full
  cache; ``similarity_topk`` f32 at b 16 × n 512 and b 64 × n 21841 (d 512,
  k 5); ``flash_fwd`` and ``flash_bwd`` bf16 and f32
  at one image microbatch (bh 3072, s 196) and one text microbatch
  (bh 4096, s 16, padded), ``flash_fwd`` bf16 and f32 also at the Llama
  prefill (bh 32 over 8 kv heads, s 512, causal, window 8192), and f32 at
  the zero-shot serving shapes (image bh 192, s 196; text bh 1024, s 16,
  padded), with the forward's device time per call from ``torch.profiler``
  as well; ``bwd_fused`` at B 2048 × D 512
  (f32 and bf16) and ragged B 1000, ``grads`` at B 2048 × D 1024 and
  B 8192 × D 256 / 1024 (f32); ``row_col_lse`` at B 2048 and 8192 × D 1024
  (f32); ``fwd_fused`` at B 2048 × D 512 (f32 and bf16) and ragged B 1000
  (f32), and ``ssd_scan`` at Mamba-2-130M's widths (h 24, p 64, n 128;
  inputs as the mixer's split views) at b 1 × l 256 (bf16 and f32),
  b 1 × l 1024 and b 8 × l 256 (f32) and l 244 with an initial state
  (bf16), these two also with their device time per call; and the SSD
  scan at its training shapes (as ``--ssd``);
- ``--ssd``: only the SSD scan at its training shapes: ``ssd_scan`` at
  Mamba-2-130M's (b 2 × l 4096, h 24, p 64, n 128) and ``ssd_scan_bwd``
  there and at Jamba's 256 heads (b 1 × l 4096), f32 and bf16, each with
  its error against the plain version (max over the outputs of max |err|
  / max |ref|) and its device time per call;
- ``--train``: ``repro_torch.launch.train.main`` with ``chip_smoke.py``'s
  timed-training arguments (BASIC-S bf16, B 2048 in 8 microbatches, 6
  steps): warm step median, pairs/s, peak memory, step times;
- ``--ssm-train``: the same with ``chip_smoke.py``'s SSM training
  arguments (Mamba-2-130M ``--mode lm`` f32, b 2 × s 4096, 4 steps):
  warm step median, tokens/s, peak memory, step times;
- ``--serve``: ``repro_torch.launch.serve_zeroshot.main`` with the
  arguments of ``chip_smoke.py``'s zero-shot serving phase (BASIC-S f32,
  512 classes, 8 requests of 16 images, k 5, seed 0): warm p50 and max
  latency (ms), img/s and each request's latency.

Needs a card; exits non-zero without one.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HEAD = r'''
import json
import torch
import torch.nn.functional as F
from chip_smoke import time_ms, unit_rows
from repro_torch.kernels.contrastive_loss import ops as cl, ref as clr
from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.flash_attention.ref import (NEG_INF, flash_bwd_ref,
                                                     flash_fwd_ref)
from repro_torch.kernels.decode_attention import ops as dec
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.similarity_topk import ops as tk
from repro_torch.kernels.similarity_topk.ref import similarity_topk_ref
from torch.profiler import ProfilerActivity, profile, schedule


def device_ms(fn, iters=20):
    # per kernel name: mean duration x launches per call (rounded); the
    # tracing starts one step early (a warm-up step on a small op), so that
    # its start-up cannot miss the first calls' records
    # (a window whose records the tracer lost is retaken, twice at most)
    fn()
    torch.cuda.synchronize()
    by_name = {}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA], acc_events=True,
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            torch.zeros(1, device=dev).add_(1)
            torch.cuda.synchronize()
            prof.step()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            prof.step()
        for e in prof.events():
            if (str(getattr(e, "device_type", "")).endswith("CUDA")
                    and not e.name.startswith("ProfilerStep")):
                us, n = by_name.get(e.name, (0.0, 0))
                by_name[e.name] = (us + e.time_range.elapsed_us(), n + 1)
        if by_name:
            break
    if not by_name:   # not measured (NaN): the tracer kept losing it
        return float("nan")
    return sum(us / n * max(1, round(n / iters))
               for us, n in by_name.values()) / 1e3


out = {}
dev = torch.device("cuda")
'''

KERNELS = r'''
g = torch.Generator(device=dev).manual_seed(40)
q = torch.randn((8, 32, 64), generator=g, device=dev).to(torch.bfloat16)
k, v = (torch.randn((8, 8, 8192, 64), generator=g, device=dev)
        .to(torch.bfloat16) for _ in range(2))
ar = torch.arange(8192, device=dev)
for state, lens in (("serving", [508 + 9 * i for i in range(8)]),
                    ("full", [8192] * 8)):
    valid = ar[None, :] < torch.tensor(lens, device=dev)[:, None]
    f = lambda: dec.decode_attention(q, k, v, valid)
    err = (f().float() - decode_attention_ref(q, k, v, valid).float()
           ).abs().max().item()
    out[f"decode_attention {state} bf16"] = [round(time_ms(f), 4), err,
                                             round(device_ms(f), 4)]
g = torch.Generator(device=dev).manual_seed(4)
for b, n in ((16, 512), (64, 21841)):
    x, c = unit_rows(b, 512, g, torch.float32), unit_rows(n, 512, g,
                                                          torch.float32)
    f = lambda: tk.similarity_topk(x, c, 5, inv_tau=1 / 0.07)
    err = (f()[0] - similarity_topk_ref(x, c, 5, 1 / 0.07)[0]
           ).abs().max().item()
    out[f"similarity_topk b{b} n{n} float32"] = [round(time_ms(f), 4), err,
                                                 round(device_ms(f), 4)]
for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
    # [event ms, max abs err vs plain, forward: device ms per call]
    for label, b, h, s, padded, bwd in (
            ("image", 256, 12, 196, False, True),
            ("text", 256, 16, 16, True, True),
            ("image serving", 16, 12, 196, False, False),
            ("text serving", 64, 16, 16, True, False)):
        if not bwd and dt == torch.bfloat16:
            continue
        g = torch.Generator(device=dev).manual_seed(11)
        q, k, v, do = (torch.randn((b * h, s, 64), generator=g, device=dev)
                       .to(dt) for _ in range(4))
        bias = None
        if padded:
            lens = torch.randint(1, s + 1, (b,), generator=g, device=dev)
            bias = torch.where(torch.arange(s, device=dev)[None, :]
                               < lens[:, None], 0.0, NEG_INF).float()
        o, lse = flash_fwd_ref(q, k, v, bias, causal=False)
        got = fa.flash_fwd(q, k, v, bias, causal=False)
        err = max((x.float() - r.float()).abs().max().item()
                  for x, r in zip(got, (o, lse)))
        f = lambda: fa.flash_fwd(q, k, v, bias, causal=False)
        out[f"flash_fwd {label} {tag}"] = [round(time_ms(f), 4), err,
                                           round(device_ms(f), 4)]
        if not bwd:
            continue
        args = (q, k, v, bias, o, lse, do)
        got = fa.flash_bwd(*args, causal=False)
        want = flash_bwd_ref(*args, causal=False)
        err = max((x.float() - r.float()).abs().max().item()
                  for x, r in zip(got, want))
        ms = time_ms(lambda: fa.flash_bwd(*args, causal=False))
        out[f"flash_bwd {label} {tag}"] = [round(ms, 4), err]
    g = torch.Generator(device=dev).manual_seed(50)
    q = torch.randn((32, 512, 64), generator=g, device=dev).to(dt)
    k, v = (torch.randn((8, 512, 64), generator=g, device=dev).to(dt)
            for _ in range(2))
    want = flash_fwd_ref(q, k, v, causal=True, window=8192)
    got = fa.flash_fwd(q, k, v, causal=True, window=8192)
    err = max((x.float() - r.float()).abs().max().item()
              for x, r in zip(got, want))
    f = lambda: fa.flash_fwd(q, k, v, causal=True, window=8192)
    out[f"flash_fwd prefill {tag}"] = [round(time_ms(f), 4), err,
                                       round(device_ms(f), 4)]
for b in (2048, 8192):
    g = torch.Generator(device=dev).manual_seed(b + 1024)
    x, y = (unit_rows(b, 1024, g, torch.float32) for _ in range(2))
    it = torch.tensor(1 / 0.07, device=dev)
    want = clr.row_col_lse_ref(x, y, it)
    got = cl.row_col_lse(x, y, it)
    err = max((a - r).abs().max().item() for a, r in zip(got, want))
    n, w = (3, 1) if b >= 8192 else (20, 3)
    ms = time_ms(lambda: cl.row_col_lse(x, y, it), n, w)
    out[f"row_col_lse {b}x1024 float32"] = [round(ms, 4), err]
for fn, b, d, dt in (("bwd_fused", 2048, 512, torch.float32),
                     ("bwd_fused", 2048, 512, torch.bfloat16),
                     ("bwd_fused", 1000, 512, torch.float32),
                     ("grads", 2048, 1024, torch.float32),
                     ("grads", 8192, 256, torch.float32),
                     ("grads", 8192, 1024, torch.float32)):
    g = torch.Generator(device=dev).manual_seed(b + d)
    x, y = unit_rows(b, d, g, dt), unit_rows(b, d, g, dt)
    it = torch.tensor(1 / 0.07, device=dev)
    r, c = clr.fwd_fused_ref(x, y, it)
    f = getattr(cl, fn)
    got = f(x, y, it, r, c)
    want = clr.bwd_fused_ref(x, y, it, r, c)
    err = max((got[i] - want[i]).abs().max().item() for i in (0, 1))
    n, w = (3, 1) if b >= 8192 else (20, 3)
    ms = time_ms(lambda: f(x, y, it, r, c), n, w)
    out[f"{fn} {b}x{d} {str(dt).removeprefix('torch.')}"] = [round(ms, 4),
                                                             err]
for b, dt in ((2048, torch.float32), (2048, torch.bfloat16),
              (1000, torch.float32)):
    g = torch.Generator(device=dev).manual_seed(b + 512)
    x, y = unit_rows(b, 512, g, dt), unit_rows(b, 512, g, dt)
    it = torch.tensor(1 / 0.07, device=dev)
    want = clr.fwd_fused_ref(x, y, it)
    got = cl.fwd_fused(x, y, it)
    err = max((a - r).abs().max().item() for a, r in zip(got, want))
    f = lambda: cl.fwd_fused(x, y, it)
    out[f"fwd_fused {b}x512 {str(dt).removeprefix('torch.')}"] = [
        round(time_ms(f), 4), err, round(device_ms(f), 4)]
from chip_smoke import plain_scan, ssd_inputs
from repro_torch.kernels.ssd_scan import ops as ssd
for label, b, l, dt, init in (("b1 l256", 1, 256, torch.bfloat16, False),
                              ("b1 l256", 1, 256, torch.float32, False),
                              ("b1 l1024", 1, 1024, torch.float32, False),
                              ("b8 l256", 8, 256, torch.float32, True),
                              ("b1 l244 init", 1, 244, torch.bfloat16,
                               True)):
    x, dtt, A, Bm, Cm, D, s0 = ssd_inputs(b, l, dt, 60, init)
    f = lambda: ssd.ssd_scan(x, dtt, A, Bm, Cm, D, chunk=256, init_state=s0)
    got = f()
    want = plain_scan(x, dtt, A, Bm, Cm, D, chunk=256, init_state=s0)
    # max abs error over y and the final state, each over its max |ref|
    err = max(((a - r).abs().max() / r.abs().max()).item()
              for a, r in zip(got, want))
    out[f"ssd_scan {label} {str(dt).removeprefix('torch.')}"] = [
        round(time_ms(f), 4), err, round(device_ms(f), 4)]
'''

SSD = r'''
from chip_smoke import plain_scan, ssd_inputs
from repro_torch.kernels.ssd_scan import ops as ssd
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_bwd
for label, b, l, h in (("train b2 l4096", 2, 4096, 24),
                       ("jamba b1 l4096 h256", 1, 4096, 256)):
    for dt in (torch.float32, torch.bfloat16):
        tag = f"{label} {str(dt).removeprefix('torch.')}"
        x, dtt, A, Bm, Cm, D, s0 = ssd_inputs(b, l, dt, 80, h=h)
        args = (x, dtt, A, Bm, Cm, D, None)
        if h == 24:
            f = lambda: ssd.ssd_scan(x, dtt, A, Bm, Cm, D, chunk=256)
            want = plain_scan(x, dtt, A, Bm, Cm, D, chunk=256)
            err = max(((a - r).abs().max() / r.abs().max()).item()
                      for a, r in zip(f(), want))
            del want
            out[f"ssd_scan {tag}"] = [round(time_ms(f), 4), err,
                                      round(device_ms(f), 4)]
        _, final, states = ssd._launch(*args, save_states=True)
        g = torch.Generator(device=dev).manual_seed(81)
        dy = torch.randn((b, l, h, 64), generator=g, device=dev)
        f = lambda: ssd.ssd_scan_bwd(*args, states, final, dy)
        want = ssd_chunked_bwd(*args, dy, None, 64)
        # max over the gradients of max |err| / max |ref|
        err = max(((a.float() - r).abs().max() / r.abs().max()).item()
                  for a, r in zip(f(), want) if r is not None)
        del want
        out[f"ssd_scan_bwd {tag}"] = [round(time_ms(f, 10), 4), err,
                                      round(device_ms(f, 5), 4)]
        del states, final, dy
        torch.cuda.empty_cache()
'''

TAIL = r'''
print("RESULT", json.dumps(out))
'''

TRAIN = r'''
import json
import chip_smoke
from repro_torch.launch import train
rep = train.main(chip_smoke.TRAIN_ARGV)
print("RESULT", json.dumps({k: rep[k] for k in (
    "warm_step_median_s", "pairs_per_s", "max_memory_allocated",
    "step_s")}))
'''

SSM_TRAIN = r'''
import json
import chip_smoke
from repro_torch.launch import train
rep = train.main(chip_smoke.SSM_TRAIN_ARGV)
print("RESULT", json.dumps({k: rep[k] for k in (
    "warm_step_median_s", "tokens_per_s", "max_memory_allocated",
    "step_s")}))
'''


SERVE = r'''
import json
from repro_torch.launch import serve_zeroshot
rep = serve_zeroshot.main(["--arch", "basic-s", "--classes", "512",
                           "--batch", "16", "--requests", "8", "--k", "5",
                           "--seed", "0"])
print("RESULT", json.dumps({
    "p50_ms": rep["p50_s"] * 1e3, "max_ms": rep["max_s"] * 1e3,
    "img_per_s": rep["img_per_s"],
    "latencies_ms": [x * 1e3 for x in rep["latencies_s"]]}))
'''


def run(tree: str, code: str) -> dict:
    """Run ``code`` in a fresh process inside ``tree``; its RESULT line."""
    env = dict(os.environ)
    src = os.path.join(os.path.abspath(tree), "src")
    env["PYTHONPATH"] = src + os.pathsep + os.path.abspath(tree)
    proc = subprocess.run([sys.executable, "-c", code], cwd=tree, env=env,
                          capture_output=True, text=True, check=False)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT")]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"{tree} failed (exit {proc.returncode}):\n"
                           f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    return json.loads(lines[-1].removeprefix("RESULT "))


def main(argv=None) -> int:
    """Run the chosen comparisons over the trees in the order given."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("trees", nargs="+")
    p.add_argument("--train", action="store_true")
    p.add_argument("--kernels", action="store_true")
    p.add_argument("--serve", action="store_true")
    p.add_argument("--ssd", action="store_true")
    p.add_argument("--ssm-train", action="store_true")
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device is available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    for what, code in (("kernels", HEAD + KERNELS + SSD + TAIL),
                       ("ssd", HEAD + SSD + TAIL), ("train", TRAIN),
                       ("ssm_train", SSM_TRAIN), ("serve", SERVE)):
        if not getattr(args, what):
            continue
        for tree in args.trees:
            print(f"AB {what} {tree} {json.dumps(run(tree, code))}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
