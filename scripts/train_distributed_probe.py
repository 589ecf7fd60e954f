"""The distributed trainer on NCCL, one rank per card.

    torchrun --nproc-per-node 4 scripts/train_distributed_probe.py
    torchrun --nproc-per-node 4 scripts/train_distributed_probe.py \\
        --device cpu --smoke              # the same checks on gloo ranks
    torchrun --nproc-per-node 4 scripts/train_distributed_probe.py \\
        --arch basic-l --model-parallel 2,4 --batch 4096 --steps 3 \\
        --remat full --f32-batch 256      # paper §5.1 weight sharding
    torchrun --nproc-per-node 4 scripts/train_distributed_probe.py \\
        --arch basic-l --model-parallel 2,4 --sharding basic_ws,tp \\
        --batch 4096 --steps 3 --remat full --f32-batch 256
    torchrun --nproc-per-node 4 scripts/train_distributed_probe.py \\
        --objective lm --arch mixtral-8x22b --layers 1 --model-parallel 4 \\
        --sharding tp --batch 1 --seq 4096 --steps 4   # expert parallelism
    torchrun --nproc-per-node 4 scripts/train_distributed_probe.py \\
        --objective lm --arch mamba2-130m --model-parallel 4 --sharding tp \\
        --batch 2 --seq 4096 --steps 4      # the Mamba-2 mixer by heads
    torchrun --nproc-per-node 4 scripts/train_distributed_probe.py \\
        --objective lm --arch jamba-1.5-large-398b --layers 8 --experts 4 \\
        --model-parallel 4 --sharding tp --batch 1 --seq 4096 \\
        --precision bf16 --steps 4          # one full-width Jamba period

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
2. runs ``repro_torch.launch.train_distributed.main`` (``--arch``, global
   ``--batch`` in 8 microbatches a rank, the chunked loss,
   flash attention, bf16, ``--remat``, ``--steps``) once for each model
   extent M of ``--model-parallel`` and each rule of ``--sharding`` (comma
   lists; the ranks form a (R / M, M) grid; under ``tp`` the M ranks of a
   data shard share its block): every rank's losses equal, and rank 0
   prints, per grid, the runlog's warm step median, pairs/s and the
   data-wait / device-step / ckpt-stall split, and each rank's peak memory
   (counted from after the whole init tree is freed), its launches of the
   flash and contrastive kernels in the run, and the bytes of its
   resident params and optimizer state (``build_state`` on the same mesh,
   measured, then freed);
3. with ``--f32-batch N``: the same grids in f32 at global batch N for 3
   steps, a ``basic_ws`` run held against the next grid's step (another
   model extent), a ``tp`` run against the ``basic_ws`` step of its own
   grid, each on the same global batch (the loader's layout of R / M
   blocks), losses within rtol 1e-4. (BASIC-L's whole f32 training state
   does not fit one 80 GB card, so one card alone is no reference there.)

With ``--objective lm`` step 1 is skipped and step 2 runs ``train_lm``
(``--precision``, f32 by default, flash attention, capacity dispatch for
a MoE model) on ``--arch`` cut to its first ``--layers`` layers and its
first ``--experts`` experts at full width, global ``--batch`` ×
``--seq`` tokens, printing the warm step median, tokens/s and the peak
memory and bytes of each rank, its launches of the SSD scan and its
backward too, and the bytes each rank passed to the collectives of
``launch/mesh.py`` a step, by operation. A run that runs out of device
memory is recorded with the error's text (its allocation) and the probe
goes on.

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

from repro_torch.launch.roofline import CollectiveBytes  # noqa: E402

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
    n, r = mesh.ranks, mesh.rank
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


def state_bytes(targs, device, mesh):
    """Bytes of this rank's resident params and optimizer state when the
    trainer's ``build_state`` places them on ``mesh`` (measured on the
    tensors, then freed)."""
    import torch
    from repro_torch.launch import steps as st
    from repro_torch.launch import train_distributed as td
    from repro_torch.tree import tree_leaves
    cfg = td.arch_config(targs)
    trees = td.build_state(cfg, st.make_optimizer(), targs.seed, device,
                           mesh, targs.sharding)
    out = [sum(x.numel() * x.element_size() for x in tree_leaves(t))
           for t in trees]
    del trees
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def cut_arch(base, layers, experts=0):
    """The name of ``base`` cut to its first ``layers`` layers and, for a
    MoE model, its first ``experts`` experts, at full width, registered;
    ``base`` itself when both are 0."""
    if not layers and not experts:
        return base
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import register
    cfg = get_arch(base)
    name = base + (f"-{layers}layers" if layers else "") + (
        f"-{experts}experts" if experts else "")
    changes = {"name": name}
    if layers:
        changes["n_layers"] = layers
    if experts:
        changes["moe"] = dataclasses.replace(cfg.moe, num_experts=experts)
    register(dataclasses.replace(cfg, **changes))
    return name


def grid_losses(argv, n_hosts, device):
    """The trainer's state and step on the grid of ``argv``'s
    ``--model-parallel`` over the global batches of the loader's layout
    of ``n_hosts`` blocks (rank r takes rows block r of the ranks',
    ``device_put_global``), which need not be the grid's own; returns the
    per-step losses. Every rank of the world calls it."""
    from repro_torch.data.sharded import HostLayout, device_put_global
    from repro_torch.launch import steps as st
    from repro_torch.launch import train_distributed as td
    args = td.parse_args(argv)
    _, mesh = td.setup(args)
    cfg = td.arch_config(args)
    step_fn, opt = st.make_contrastive_step(
        cfg, num_micro=args.num_micro, remat=args.remat,
        precision=args.precision, attn=args.attn, lr=args.lr, mesh=mesh,
        loss=args.loss, layout=td.param_layout(cfg, mesh, args.sharding))
    params, opt_state = td.build_state(cfg, opt, args.seed, device, mesh,
                                       args.sharding)
    loader = td.make_loader(args, cfg, HostLayout(n_hosts, 0))
    losses = []
    for step in range(args.steps):
        batch = device_put_global(loader.global_batch_at(step), device,
                                  (mesh.rank, mesh.ranks))
        params, opt_state, loss, _ = step_fn(params, opt_state, batch)
        losses.append(loss.item())
    return losses


def run_split(run_dir):
    """(warm step median, the data-wait / device-step / ckpt-stall shares
    of the summed step time) of a runlog."""
    from repro_torch.obs import runlog
    recs = runlog.read_runlog(os.path.join(run_dir, "runlog.jsonl"))
    step_recs = [x for x in recs if x["kind"] == "step"]
    warm = statistics.median(x["step_s"] for x in step_recs[1:])
    total = sum(x["step_s"] for x in step_recs)
    return warm, {k: sum(x[k] for x in step_recs) / total
                  for k in ("data_wait_s", "device_step_s", "ckpt_stall_s")}


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
    ap.add_argument("--arch", default="basic-s")
    ap.add_argument("--objective", default="contrastive",
                    choices=["contrastive", "lm"])
    ap.add_argument("--layers", type=int, default=0,
                    help="cut --arch to its first N layers (0: all)")
    ap.add_argument("--experts", type=int, default=0,
                    help="cut a MoE --arch to its first N experts (0: all)")
    ap.add_argument("--precision", default=None,
                    help="the trainer's --precision (default f32 for lm, "
                         "the trainer's own for contrastive)")
    ap.add_argument("--seq", type=int, default=16,
                    help="caption length (contrastive) / sequence (lm)")
    ap.add_argument("--model-parallel", default="1",
                    help="comma list of model extents, one trainer run each")
    ap.add_argument("--sharding", default="basic_ws",
                    help="comma list of rules (basic_ws, tp), one trainer "
                         "run each per model extent")
    ap.add_argument("--remat", default="basic")
    ap.add_argument("--f32-batch", type=int, default=0,
                    help="global batch of step 3's f32 check (0: skip)")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist
    from repro_torch.launch import train_distributed as td
    on_card = args.device in (None, "cuda")
    dist.init_process_group("nccl" if on_card else "gloo")
    try:
        rank = dist.get_rank()
        targs = td.parse_args(["--arch", "basic-s"] + (
            ["--device", args.device] if args.device else []))
        device, mesh = td.setup(targs)
        if rank == 0:
            print(card_line(), f"torch {torch.__version__}",
                  f"{mesh.ranks} ranks, {mesh.backend}", flush=True)
        if on_card:
            from repro_torch.kernels import build as kbuild
            from repro_torch.kernels.contrastive_loss import ops as cl_ops
            from repro_torch.kernels.flash_attention import ops as fa_ops
            from repro_torch.kernels.ssd_scan import ops as ssd_ops
            libs = (fa_ops.LIB, fa_ops.BWD_LIB, cl_ops.LIB, ssd_ops.LIB,
                    ssd_ops.BWD_LIB)
            if rank == 0:
                kbuild.build_all(libs)
            mesh.barrier()
            for lib in libs:
                lib.lib()
        from repro_torch.kernels.contrastive_loss import ops as cl_ops
        from repro_torch.kernels.flash_attention import ops as fa_ops
        from repro_torch.kernels.ssd_scan import ops as ssd_ops
        counters = (fa_ops.COUNTER, fa_ops.BWD_COUNTER, cl_ops.FWD_COUNTER,
                    cl_ops.BWD_COUNTER, ssd_ops.COUNTER, ssd_ops.BWD_COUNTER)
        lm = args.objective == "lm"
        losses = {} if lm else loss_checks(
            mesh, device, 16 if args.smoke else args.b_local, args.iters)
        checks = [None] * mesh.ranks
        dist.all_gather_object(checks, losses)
        batch = 64 if args.smoke and not lm else args.batch
        arch = cut_arch(args.arch, args.layers, args.experts)
        base = ["--arch", arch, "--attn", "pallas", "--quiet", "--seq",
                str(args.seq), "--objective", args.objective, "--remat",
                args.remat]
        base += ([] if lm else ["--num-micro", "8", "--loss", "chunked"])
        if args.precision or lm:
            base += ["--precision", args.precision or "f32"]
        base += ["--smoke", "--device", "cpu"] if args.smoke else []
        models = [int(m) for m in args.model_parallel.split(",")]
        shardings = args.sharding.split(",")
        run_dir = os.path.join(ROOT, "build", "train_distributed_probe")
        grids = []
        for model, sharding in ((m, sh) for m in models for sh in shardings):
            argv_t = base + ["--batch", str(batch), "--steps",
                             str(args.steps), "--model-parallel", str(model),
                             "--sharding", sharding]
            targs = td.parse_args(argv_t)
            _, gmesh = td.setup(targs)
            if rank == 0:
                shutil.rmtree(run_dir, ignore_errors=True)
            for c in counters:
                c.reset()
            oom, steps, nbytes, peak = None, None, None, None
            t0 = time.perf_counter()
            try:
                nbytes = state_bytes(targs, device, gmesh)
                if on_card:
                    torch.cuda.reset_peak_memory_stats(device)
                with CollectiveBytes() as moved:
                    steps = td.main(argv_t + (["--run-dir", run_dir]
                                              if rank == 0 else []))
            except torch.cuda.OutOfMemoryError as e:
                oom = str(e)
            wall = time.perf_counter() - t0
            if on_card:
                peak = torch.cuda.max_memory_allocated(device)
                torch.cuda.empty_cache()
            everyone = [None] * mesh.ranks
            dist.all_gather_object(everyone, {
                "losses": steps, "peak": peak, "bytes": nbytes, "oom": oom,
                "collective_bytes_per_step": None if oom else {
                    k: v / args.steps for k, v in moved.bytes.items()},
                "launches": {c.name: c.count for c in counters},
                "ssd_shapes": {c.name: {"x".join(map(str, k)): v
                                        for k, v in c.shapes.items()}
                               for c in counters[-2:]}})
            rec = {"grid": [mesh.ranks // model, model],
                   "sharding": sharding, "batch": batch,
                   "losses": everyone[0]["losses"],
                   "losses_equal": all(e["losses"] == everyone[0]["losses"]
                                       for e in everyone),
                   "wall_s": wall,
                   "peak_gib": [e["peak"] / 2**30 if e["peak"] else None
                                for e in everyone],
                   "launches": [e["launches"] for e in everyone],
                   "ssd_shapes": [e["ssd_shapes"] for e in everyone],
                   "collective_bytes_per_step": [
                       e["collective_bytes_per_step"] for e in everyone],
                   "params_bytes": [e["bytes"] and e["bytes"][0]
                                    for e in everyone],
                   "state_bytes": [e["bytes"] and e["bytes"][1]
                                   for e in everyone],
                   "out_of_memory": [e["oom"] for e in everyone]}
            if any(rec["out_of_memory"]):
                if rank == 0:
                    print(f"grid {rec['grid']} {sharding}: out of memory "
                          f"{json.dumps(rec)}", flush=True)
                grids.append(rec)
                continue
            if rank == 0:
                warm, split = run_split(run_dir)
                rec.update(warm_step_median_s=warm, split=split)
                if lm:
                    rec["tokens_per_s"] = batch * args.seq / warm
                else:
                    rec["pairs_per_s"] = batch / warm
                print(f"grid {rec['grid']} {sharding}: {json.dumps(rec)}",
                      flush=True)
            grids.append(rec)
            if on_card:
                torch.cuda.empty_cache()
        f32 = []
        if args.f32_batch and not lm:
            # a basic_ws run against the next grid's step, a tp run against
            # the basic_ws step of its grid, on the same global batch (the
            # loader's layout of R / M blocks)
            f32_argv = base + ["--batch", str(args.f32_batch), "--steps", "3",
                               "--precision", "f32"]
            for i, (model, sharding) in enumerate(
                    (m, sh) for m in models for sh in shardings):
                other = models[(models.index(model) + 1) % len(models)] \
                    if sharding == "basic_ws" else model
                rec = {"grid": [mesh.ranks // model, model],
                       "sharding": sharding,
                       "losses": td.main(f32_argv + [
                           "--model-parallel", str(model), "--sharding",
                           sharding]),
                       "against_grid": [mesh.ranks // other, other],
                       "against_losses": grid_losses(
                           f32_argv + ["--model-parallel", str(other),
                                       "--sharding", "basic_ws"],
                           mesh.ranks // model, device)}
                rec["max_rel_err"] = max(
                    abs(a - b) / abs(b) for a, b in
                    zip(rec["losses"], rec["against_losses"]))
                rec["ok"] = rec["max_rel_err"] <= 1e-4
                f32.append(rec)
                if on_card:
                    torch.cuda.empty_cache()
        if rank != 0:
            return 0
        ok = all(rec["ok"] for e in checks for k, rec in e.items()
                 if k[1] != "single") and \
            all(g["losses_equal"] for g in grids) and \
            all(r["ok"] for r in f32)
        report = {
            "ranks": mesh.ranks, "backend": mesh.backend,
            "card": card_line(), "ok": ok, "arch": arch,
            "loss": {f"{k[0]} {k[1]}": {
                "ms_rank0": losses[k]["ms"],
                **({} if k[1] == "single" else {
                    "worst_loss_rel_err": max(e[k]["loss_rel_err"]
                                              for e in checks),
                    "dtau_rel_err": losses[k]["dtau_rel_err"],
                    "worst_dx_max_abs_err": max(e[k]["dx_max_abs_err"]
                                                for e in checks),
                    "worst_dy_max_abs_err": max(e[k]["dy_max_abs_err"]
                                                for e in checks)})}
                for k in losses},
            "train": grids, "f32_check": f32}
        print("PROBE " + json.dumps(report), flush=True)
        return 0 if ok else 1
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
