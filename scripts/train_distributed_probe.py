"""The distributed trainer on NCCL, one rank per card.

    torchrun --nproc-per-node 4 scripts/train_distributed_probe.py
    torchrun --nproc-per-node 4 scripts/train_distributed_probe.py \\
        --device cpu --smoke              # the same checks on gloo ranks

``chip_smoke.py`` runs several ranks on one card over gloo; this script
runs the path that exists only across cards: one rank a card, the NCCL
branch of ``launch/mesh.py`` (``all_gather_into_tensor``,
``reduce_scatter_tensor``, ``all_reduce`` on the device). Every rank:

1. draws the same global embeddings (B = R × ``--b-local``, D 512, f32
   and bf16) and holds the ``allgather`` and ``chunked`` losses on its
   rows against the single-device fused loss on all of them (computed on
   its own card): loss rtol 2e-6, dX / dY rtol 1e-5 / atol 1e-6, the
   ranks' dlog_tau partials summed rtol 1e-5 (f32); bf16 loss 1e-3, dX /
   dY 2e-2; then times each (forward and backward between CUDA events,
   ``--iters`` calls) against the single-device fused loss at the global
   batch, one card alone;
2. runs ``repro_torch.launch.train_distributed.main`` (BASIC-S, global
   ``--batch`` in 8 microbatches a rank, the chunked loss, flash
   attention, bf16, ``--steps``): every rank's losses equal, and rank 0
   prints the runlog's warm step median, pairs/s and the data-wait /
   device-step / ckpt-stall split, and each rank's peak memory.

Rank 0 prints the card's name and power limit first and one ``PROBE
{json}`` line last; it exits non-zero when a check fails.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

LOG_TAU = -2.659
D = 512
TOL = {"float32": {"loss": 2e-6, "rtol": 1e-5, "atol": 1e-6, "dtau": 1e-5},
       "bfloat16": {"loss": 1e-3, "rtol": 0.0, "atol": 2e-2, "dtau": 2e-2}}


def card_line() -> str:
    """The card's name and power limit (nvidia-smi), or 'cpu'."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return "cpu"
    return out.stdout.strip().splitlines()[0]


def timed_ms(fn, device, iters):
    """Mean milliseconds of ``fn`` over ``iters`` calls after one warm-up:
    CUDA events on a card, the host clock on the CPU."""
    import torch
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize(device)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters


def loss_checks(mesh, device, b_local, iters):
    """Step 1 of the module docstring; returns this rank's records."""
    import torch
    from repro_torch.core import distributed_loss as dl
    from repro_torch.kernels.contrastive_loss import ops as cl_ops
    n, r = mesh.data_size, mesh.data_index
    g = torch.Generator(device=device).manual_seed(7)

    def unit(rows):
        x = torch.randn((rows, D), generator=g, device=device)
        return x / x.norm(dim=1, keepdim=True)
    xg, yg = unit(n * b_local), unit(n * b_local)
    rows = slice(r * b_local, (r + 1) * b_local)
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).removeprefix("torch.")
        tol = TOL[name]
        xf, yf = (t.to(dt, copy=True).requires_grad_() for t in (xg, yg))
        lt = torch.tensor(LOG_TAU, device=device, requires_grad=True)

        def single():
            loss = cl_ops.fused_contrastive_loss(xf, yf, lt)
            return loss, torch.autograd.grad(loss, (xf, yf, lt))
        ref, (rdx, rdy, rdt) = single()
        out[(name, "single")] = {"ms": timed_ms(single, device, iters)}
        for method in dl.METHODS:
            xl = xg[rows].to(dt, copy=True).requires_grad_()
            yl = yg[rows].to(dt, copy=True).requires_grad_()
            ll = torch.tensor(LOG_TAU, device=device, requires_grad=True)
            fn = dl.make_global_loss_fn(mesh, method)

            def call():
                loss, _ = fn(xl, yl, torch.exp(ll))
                return loss, torch.autograd.grad(loss, (xl, yl, ll))
            loss, (dx, dy, dtau) = call()
            dtau_sum = mesh.all_reduce(dtau.detach().reshape(1))[0]
            rec = {"loss_rel_err": abs(loss.item() - ref.item())
                   / abs(ref.item()),
                   "dtau_rel_err": abs(dtau_sum.item() - rdt.item())
                   / abs(rdt.item())}
            for key, got, want in (("dx", dx, rdx[rows]),
                                   ("dy", dy, rdy[rows])):
                diff = (got.float() - want.float()).abs()
                rec[f"{key}_max_abs_err"] = diff.max().item()
                rec[f"{key}_excess"] = (diff - tol["atol"] - tol["rtol"]
                                        * want.float().abs()).max().item()
            rec["ok"] = (rec["loss_rel_err"] <= tol["loss"]
                         and rec["dtau_rel_err"] <= tol["dtau"]
                         and rec["dx_excess"] <= 0 and rec["dy_excess"] <= 0)
            rec["ms"] = timed_ms(call, device, iters)
            out[(name, method)] = rec
    return out


def main(argv=None) -> int:
    """Parse, run the two steps, print; the exit code (0: all checks
    held)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="'cuda' or 'cpu'")
    ap.add_argument("--smoke", action="store_true",
                    help="CPU-sized model and batches (rehearsal)")
    ap.add_argument("--b-local", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=8192,
                    help="the trainer's global batch")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist
    from repro_torch.launch import train_distributed as td
    from repro_torch.obs import runlog
    on_card = args.device in (None, "cuda")
    dist.init_process_group("nccl" if on_card else "gloo")
    try:
        rank = dist.get_rank()
        targs = td.parse_args(["--arch", "basic-s"] + (
            ["--device", args.device] if args.device else []))
        device, mesh = td.setup(targs)
        if rank == 0:
            print(card_line(), f"torch {torch.__version__}",
                  f"{mesh.data_size} ranks, {mesh.backend}", flush=True)
        if on_card:
            from repro_torch.kernels import build as kbuild
            from repro_torch.kernels.contrastive_loss import ops as cl_ops
            from repro_torch.kernels.flash_attention import ops as fa_ops
            libs = (fa_ops.LIB, fa_ops.BWD_LIB, cl_ops.LIB)
            if rank == 0:
                kbuild.build_all(libs)
            mesh.barrier()
            for lib in libs:
                lib.lib()
        b_local = 16 if args.smoke else args.b_local
        losses = loss_checks(mesh, device, b_local, args.iters)
        run_dir = None
        if rank == 0:
            run_dir = os.path.join(ROOT, "build", "train_distributed_probe")
            shutil.rmtree(run_dir, ignore_errors=True)
        batch = 64 if args.smoke else args.batch
        argv_t = ["--arch", "basic-s", "--batch", str(batch), "--num-micro",
                  "8",
                  "--loss", "chunked", "--attn", "pallas", "--steps",
                  str(args.steps), "--quiet", "--seq", "16"]
        argv_t += ["--smoke", "--device", "cpu"] if args.smoke else []
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        steps = td.main(argv_t + (["--run-dir", run_dir] if run_dir else []))
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(device) if on_card else None
        everyone = [None] * mesh.data_size
        dist.all_gather_object(everyone, {"losses": steps, "peak": peak,
                                          "checks": losses})
        if rank != 0:
            return 0
        recs = runlog.read_runlog(os.path.join(run_dir, "runlog.jsonl"))
        step_recs = [x for x in recs if x["kind"] == "step"]
        warm = statistics.median(x["step_s"] for x in step_recs[1:])
        total = sum(x["step_s"] for x in step_recs)
        split = {k: sum(x[k] for x in step_recs) / total
                 for k in ("data_wait_s", "device_step_s", "ckpt_stall_s")}
        ok = all(rec["ok"] for e in everyone for k, rec in e["checks"].items()
                 if k[1] != "single") and \
            all(e["losses"] == everyone[0]["losses"] for e in everyone)
        report = {
            "ranks": mesh.data_size, "backend": mesh.backend,
            "card": card_line(), "ok": ok,
            "loss": {f"{k[0]} {k[1]}": {
                "ms_rank0": everyone[0]["checks"][k]["ms"],
                **({} if k[1] == "single" else {
                    "worst_loss_rel_err": max(e["checks"][k]["loss_rel_err"]
                                              for e in everyone),
                    "dtau_rel_err": everyone[0]["checks"][k]["dtau_rel_err"],
                    "worst_dx_max_abs_err": max(
                        e["checks"][k]["dx_max_abs_err"] for e in everyone),
                    "worst_dy_max_abs_err": max(
                        e["checks"][k]["dy_max_abs_err"] for e in everyone)})}
                for k in everyone[0]["checks"]},
            "train": {"losses": everyone[0]["losses"],
                      "warm_step_median_s": warm,
                      "pairs_per_s": batch / warm, "split": split,
                      "wall_s": wall,
                      "peak_gib": [e["peak"] / 2**30 if e["peak"] else None
                                   for e in everyone]}}
        print("PROBE " + json.dumps(report), flush=True)
        return 0 if ok else 1
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
