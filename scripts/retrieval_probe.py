"""Times device-sharded and two-stage retrieval against the fused sweep on
one card.

    python3 scripts/retrieval_probe.py                 # four cards
    python3 scripts/retrieval_probe.py --cards 1       # fused and two-stage
    python scripts/retrieval_probe.py --device cpu --smoke   # a quick try

The gallery is BASIC-L's embedding width (1024) by 10,000,000 fp32 rows
(41 GB; 10.2 GB a card over four), unit rows around ``--clusters``
random unit centres, each shard drawn on its own card from ``--seed``.
The queries are 64 rows near random centres. The script times, over
``--calls`` calls after two warm ones (host clock, every card idle at the
end of each call):

1. ``fused``: ``similarity_topk`` over the whole gallery on the first
   card (the shards copied there);
2. ``sharded``: ``serving.retrieval.sharded_similarity_topk`` over one
   shard a card (each card sweeps its rows, the (b, k) pools merge on the
   first card), which must give the fused answer bit for bit;
3. ``twostage``: ``two_stage_topk`` at ``--nprobe`` over the centroid
   index (``build_centroid_index`` on the first card, ≈ √n blocks), with
   its recall@k against fused, prune ratio and stage seconds;
4. ``twostage_x4`` and ``twostage_wide``: the same at 4 × ``--nprobe``
   and at every block but one, where the rerank sweeps most of the
   gallery in bounded chunks (or, once the queries' probes cover every
   block, the gallery itself); with each two-stage mode's peak temporary
   memory on the first card beyond the gallery and the index.

It prints each card's name and power limit (nvidia-smi), each mode's p50
and p90, the index build seconds, the least time of the fused sweep
(bytes at 3.35 TB/s, operations at 67 TFLOP/s fp32) and a ``RETRIEVAL
{json}`` line with every number. ``--device cpu`` runs the plain
versions over a mesh of four CPU devices (with ``--smoke`` at 20,000 ×
64).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

from chip_smoke import (HBM_BYTES_PER_S, PEAK_FLOPS,  # noqa: E402
                        fill_clustered, unit_centres)


def card_lines() -> list:
    """Each card's name and power limit (nvidia-smi), or ['cpu']."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
        return out.stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return ["cpu"]


def timed(fn, devices, calls: int):
    """(last result, p50 s, p90 s) of ``calls`` calls of ``fn`` after two
    warm ones, each call ending with every device idle."""
    import numpy as np
    import torch

    def sync():
        for d in set(devices):
            if d.type == "cuda":
                torch.cuda.synchronize(d)
    for _ in range(2):
        out = fn()
    sync()
    lat = []
    for _ in range(calls):
        t0 = time.perf_counter()
        out = fn()
        sync()
        lat.append(time.perf_counter() - t0)
    return out, float(np.percentile(lat, 50)), float(np.percentile(lat, 90))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=10_000_000)
    ap.add_argument("--d", type=int, default=1024)
    ap.add_argument("--b", type=int, default=64)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--clusters", type=int, default=4096)
    ap.add_argument("--nprobe", type=int, default=32)
    ap.add_argument("--calls", type=int, default=20)
    ap.add_argument("--cards", type=int, default=None,
                    help="cards of the mesh (default: all)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="20,000 x 64, 64 clusters")
    args = ap.parse_args(argv)
    if args.smoke:
        args.n, args.d, args.clusters = 20_000, 64, 64
    import numpy as np
    import torch
    from repro_torch.device import resolve_device
    from repro_torch.kernels.similarity_topk import ops as topk_ops
    from repro_torch.serving import retrieval as rtv

    cards = card_lines()
    for line in cards:
        print(line, flush=True)
    dev = resolve_device(args.device)
    mesh = (rtv.default_data_mesh(args.cards) if dev.type == "cuda"
            else (dev,) * 4)
    s = len(mesh)
    n_local = max(-(-args.n // s), topk_ops.MAX_K)
    centres = unit_centres(args.clusters, args.d, args.seed)
    g = torch.Generator().manual_seed(args.seed + 1)
    t0 = time.perf_counter()
    blocks = []
    for r, card in enumerate(mesh):
        block = torch.zeros((n_local, args.d), device=card)
        valid = min(max(args.n - r * n_local, 0), n_local)
        if valid:
            fill_clustered(block[:valid], centres.to(card),
                           args.seed * 1000 + r + 1)
        blocks.append(block)
    sm = rtv.ShardedMatrix(tuple(blocks), args.n, n_local)
    first = mesh[0]
    if s == 1:                                 # the one shard is the gallery
        full = blocks[0][:args.n]
    else:
        full = torch.empty((args.n, args.d), device=first)
        for r, block in enumerate(blocks):     # shard by shard, no temporaries
            lo = r * n_local
            full[lo:lo + sm.n_valid(r)].copy_(block[:sm.n_valid(r)])
    pick = torch.randint(0, args.clusters, (args.b,), generator=g)
    q = centres[pick] + 0.03 * torch.randn((args.b, args.d), generator=g)
    q = (q / q.norm(dim=1, keepdim=True)).to(first)
    for card in set(mesh):
        if card.type == "cuda":
            torch.cuda.synchronize(card)
    made_s = time.perf_counter() - t0
    print(f"gallery {args.n} x {args.d} fp32 over {s} shards of {n_local} "
          f"rows ({sm.n * args.d * 4 / 1e9:.2f} GB) made in {made_s:.1f} s",
          flush=True)

    rep = {"cards": cards, "n": args.n, "d": args.d, "b": args.b,
           "k": args.k, "shards": s, "mesh": [str(d) for d in mesh]}
    (fv, fi), rep["fused_p50_s"], rep["fused_p90_s"] = timed(
        lambda: topk_ops.similarity_topk(q, full, args.k), [first],
        args.calls)
    (sv, si), rep["sharded_p50_s"], rep["sharded_p90_s"] = timed(
        lambda: rtv.sharded_similarity_topk(q, sm, args.k), mesh,
        args.calls)
    rep["sharded_equal"] = bool(torch.equal(fv, sv) and torch.equal(fi, si))
    nbytes = args.n * args.d * 4 + args.b * args.d * 4 + args.b * args.k * 8
    flops = 2.0 * args.b * args.n * args.d
    rep["fused_bound_ms"] = max(nbytes / HBM_BYTES_PER_S,
                                flops / PEAK_FLOPS["float32"]) * 1e3
    print(f"fused on {first}: p50 {rep['fused_p50_s'] * 1e3:.3f} ms, p90 "
          f"{rep['fused_p90_s'] * 1e3:.3f} ms (bound "
          f"{rep['fused_bound_ms']:.3f} ms); sharded over {s}: p50 "
          f"{rep['sharded_p50_s'] * 1e3:.3f} ms, p90 "
          f"{rep['sharded_p90_s'] * 1e3:.3f} ms; bit for bit equal: "
          f"{rep['sharded_equal']}", flush=True)
    del sm, blocks
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    index = rtv.build_centroid_index(full)
    if dev.type == "cuda":
        torch.cuda.synchronize(first)
    rep["index_build_s"] = time.perf_counter() - t0
    rep["index_blocks"] = index.n_blocks
    modes = {"twostage": args.nprobe, "twostage_x4": 4 * args.nprobe,
             "twostage_wide": index.n_blocks - 1}
    for mode, nprobe in modes.items():
        infos = []

        def two_stage():
            v, i, info = rtv.two_stage_topk(q, full, index, args.k,
                                            nprobe=nprobe)
            infos.append(info)
            return v, i
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(first)
            resident = torch.cuda.memory_allocated(first)
        (tv, ti), rep[f"{mode}_p50_s"], rep[f"{mode}_p90_s"] = timed(
            two_stage, [first], args.calls)
        rep[f"{mode}_temp_bytes"] = (
            torch.cuda.max_memory_allocated(first) - resident
            if dev.type == "cuda" else None)
        ids, want = ti.cpu().numpy(), fi.cpu().numpy()
        rep[f"{mode}_recall"] = float(np.mean(
            [len(set(a) & set(w)) / args.k for a, w in zip(ids, want)]))
        for key in ("prune_ratio", "coarse_s", "gather_s", "rerank_s"):
            rep[f"{mode}_{key}"] = float(np.median([i[key] for i in infos]))
        rep[f"{mode}_nprobe"] = nprobe
        temp = rep[f"{mode}_temp_bytes"]
        print(f"{mode} nprobe {nprobe} over {index.n_blocks} blocks "
              f"(built in {rep['index_build_s']:.2f} s): p50 "
              f"{rep[f'{mode}_p50_s'] * 1e3:.3f} ms, p90 "
              f"{rep[f'{mode}_p90_s'] * 1e3:.3f} ms, recall@{args.k} "
              f"{rep[f'{mode}_recall']:.4f}, prune ratio "
              f"{rep[f'{mode}_prune_ratio']:.4f}, coarse "
              f"{rep[f'{mode}_coarse_s'] * 1e3:.3f} ms, gather "
              f"{rep[f'{mode}_gather_s'] * 1e3:.3f} ms, rerank "
              f"{rep[f'{mode}_rerank_s'] * 1e3:.3f} ms, peak temporary "
              + ("not measured" if temp is None else f"{temp / 1e9:.3f} GB"),
              flush=True)
    print("RETRIEVAL " + json.dumps(rep), flush=True)
    for line in cards:
        print(line, flush=True)
    return 0 if rep["sharded_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
