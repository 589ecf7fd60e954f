"""Times the distributed trainer's data draw on the host.

    python scripts/loader_probe.py                 # BASIC-S, B 2048, card
    python scripts/loader_probe.py --batch 16 --device cpu   # a quick try

The contrastive trainer (``repro_torch.launch.train_distributed``) draws
each rank's block with ``ShardedLoader.local_batch_at`` on one prefetch
thread while the loop's thread runs the step. Its runlog's data-wait is
the part of a draw the step does not hide. This script builds the loader
as the trainer does (``train_distributed.make_loader``, one rank) and
times ``--draws`` draws of a block at captions of 16 and of 128 tokens,
the two lengths taking turns (so neither gains from running later):

1. ``alone``: on the main thread, nothing else running;
2. ``beside_launches``: on a second thread while the main thread issues
   small kernels on ``--device`` back to back, as the trainer's
   launch-bound step does (the Python between launches holds the GIL);
   the launches a second the main thread kept up are printed beside.

It prints the card's name and power limit, the host's usable cores and
torch's thread count, and one ``LOADER {json}`` line with each draw's
seconds.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))


def card_line() -> str:
    """The card's name and power limit (nvidia-smi), or 'cpu'."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return "cpu"
    return out.stdout.strip().splitlines()[0]


def draw_times(loaders, steps):
    """{caption length: seconds of each ``local_batch_at(step)``}, the
    loaders taking turns at each step."""
    out = {seq: [] for seq in loaders}
    for step in steps:
        for seq, loader in loaders.items():
            t0 = time.perf_counter()
            loader.local_batch_at(step)
            out[seq].append(time.perf_counter() - t0)
    return out


def beside_launches(loaders, steps, device):
    """The draws on a second thread while this thread launches small
    kernels on ``device`` until they end; returns (draw seconds, launches
    a second)."""
    import torch
    times, done = {}, threading.Event()

    def draw():
        times.update(draw_times(loaders, steps))
        done.set()

    x = torch.zeros(1024, device=device)
    worker = threading.Thread(target=draw)
    t0, launches = time.perf_counter(), 0
    worker.start()
    while not done.is_set():
        for _ in range(100):
            x.add_(1.0)
        launches += 100
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    worker.join()
    return times, launches / (time.perf_counter() - t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="basic-s")
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--draws", type=int, default=3)
    ap.add_argument("--device", default=None,
                    help="where the launches go (default: the card)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data.sharded import HostLayout
    from repro_torch.device import resolve_device
    from repro_torch.launch import train_distributed as td
    device = resolve_device(args.device)
    print(card_line(), flush=True)
    cores = len(os.sched_getaffinity(0))
    print(f"host: {cores} usable cores, torch threads "
          f"{torch.get_num_threads()}", flush=True)
    cfg = get_arch(args.arch)
    loaders = {}
    for seq in (16, 128):
        targs = td.parse_args(["--arch", args.arch, "--batch",
                               str(args.batch), "--seq", str(seq)])
        loaders[seq] = td.make_loader(targs, cfg, HostLayout(1, 0))
    draw_times(loaders, [0])                         # first-touch warm-up
    alone = draw_times(loaders, range(1, 1 + args.draws))
    busy, rate = beside_launches(loaders, range(1 + args.draws,
                                                1 + 2 * args.draws), device)
    rep = {"arch": args.arch, "batch": args.batch, "cores": cores,
           "torch_threads": torch.get_num_threads(), "launches_per_s": rate,
           "captions": {seq: {"alone_s": alone[seq],
                              "beside_launches_s": busy[seq]}
                        for seq in loaders}}
    for seq in loaders:
        print(f"captions {seq}: B {args.batch} draw alone "
              f"{[round(t, 4) for t in alone[seq]]} s; beside launches "
              f"{[round(t, 4) for t in busy[seq]]} s", flush=True)
    print(f"the main thread kept up {rate:.0f} launches/s beside the draws",
          flush=True)
    print("LOADER " + json.dumps(rep), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
