"""Distributed trainer of the port (counterpart of
``repro/launch/train_distributed.py``): the production loop over any
number of ``torch.distributed`` ranks, one rank per mesh device.

The same code path drives one card and many. The ranks form the (data
D, model M) grid of ``launch.mesh.make_local_mesh`` (``--model-parallel
M``; rank r is data shard r // M, model index r % M) and the GLOBAL batch
is split over all D·M of them in rank order (paper §5.1: "each core
processes B/2048 examples, regardless of R"). Parameters are drawn from
``--seed`` identically on every rank (or restored from one checkpoint)
and placed by the ``--sharding`` rule (``core.sharding.params_specs``):
under ``basic_ws`` with M > 1 each rank keeps 1/M of every leaf the rule
splits over the model axis, and of its optimizer slots, and the models
gather a layer's weights while they use it (``core.weight_sharding``);
under ``replicated``, or with M = 1, every rank holds the whole model.
The step's gradients are summed over the ranks (a split leaf's part over
its model group by the gather's backward, then over the data axis; a
whole leaf over every rank), so every rank takes the same update.
Under ``--sharding tp`` with M > 1 (Megatron execution,
``core.tensor_parallel``) each rank keeps the same 1/M of the rule's
split leaves but computes with them as they lie: the M ranks of a model
group run their data shard's whole block, column- and row-split
attention and FFN with one all-reduce per sub-block, the Mamba-2 mixer
on H/M of its heads with one all-reduce (its B, C and conv weights
gathered whole), the MoE experts by expert parallelism, the embedding
and the LM loss vocab-parallel; the global batch is split over the D
data shards only, and every gradient is summed over the data axis.
``tp`` covers every family (encoder, dense, ssm, moe, hybrid, vlm; a
vlm's vision frontend is made whole on every rank, its text tail's loss
vocab-parallel). A model whose heads (attention or
SSD), kv heads, ff dim, d_inner or state dim do not divide by M is
refused (ValueError). Two objectives share the loop
(``--objective auto`` picks by arch):

  lm           — next-token loss of a decoder LM or a vlm's text, or an
                 audio encoder's masked-frame loss; every rank draws the
                 global batch of step i from ``host_rng(seed, 0, i)`` and
                 trains on its rows (``batch_specs`` over (data, model),
                 or over (data,) under ``tp``, strictly: the batch must
                 divide over those ranks); the loss and the gradients are
                 the means over the ranks' equal blocks (a masked loss
                 weighing each block by its masked count); a MoE model's
                 capacity groups must fall on a rank's rows as on the
                 whole batch
  contrastive  — the paper's dual-encoder objective: Algorithm-1
                 GradAccum (``--num-micro``, over each rank's block) with
                 the cross-shard global-batch loss (``--loss allgather`` or
                 ``--loss chunked``, ``core.distributed_loss``), so the
                 contrastive batch does not shrink with the number of
                 ranks; per-tower remat via ``--remat-image`` /
                 ``--remat-text``. Images are raw pixels through the
                 patchify frontend.

With one rank (no process group, or a world of 1) the contrastive loss is
the single-device fused loss, as the reference's on a data extent of 1.
``--precision`` (default f32 for lm, bf16 for contrastive) and ``--attn``
('pallas', the flash kernels) as in the reference.

The contrastive input is the sharded data subsystem (``data.sharded``):
the versioned tokenizer artifact (``--tokenizer v1``), one block of the
global batch per data shard (the M ranks of data shard d draw block d
from ``host_rng(seed, d, step)``, the same bytes as the reference's block
d, and keep sub-block r % M of it, or under ``tp`` all of it), optional
``--augment on``, read through the loader's cursor stream
(``ShardedLoader.stream``), and the loader's state (the reference's
layout of D blocks) in every checkpoint's meta, so a resumed run replays
the exact batch sequence. The ``%8``
per-shard batch rule of the reference (its TPU kernel's tiling) does not
apply; each rank's block must divide into ``--num-micro`` microbatches.

    python -m repro_torch.launch.train_distributed --arch basic-s \\
        --batch 2048 --num-micro 8 --loss chunked --steps 100 \\
        --ckpt-dir /path/to/ckpt --ckpt-every 10
    torchrun --nproc-per-node 4 -m repro_torch.launch.train_distributed \\
        --arch basic-s --batch 8192 --num-micro 8 --loss chunked ...
    torchrun --nproc-per-node 4 -m repro_torch.launch.train_distributed \\
        --arch basic-l --model-parallel 4 --sharding basic_ws ...
    torchrun --nproc-per-node 4 -m repro_torch.launch.train_distributed \\
        --arch basic-l --model-parallel 2 --sharding tp ...
    python -m repro_torch.launch.train_distributed --arch llama3.2-1b \\
        --smoke --device cpu --steps 4 --batch 4 --seq 64

Under ``torchrun`` (WORLD_SIZE > 1) ``main`` starts the process group:
NCCL when every local rank has its own card, else gloo (several ranks on
one card, or ``--device cpu``). A caller that has started a group already
(tests, ``chip_smoke.py``) calls ``train`` and the group is used as it is.
It runs on the card (``cuda:LOCAL_RANK``) unless given ``--device cpu``,
and raises without a card otherwise.

Fault tolerance: checkpoints (rank 0 writes them, in the reference's
format, params and AdaFactorW state as one tree of whole leaves: the
ranks of rank 0's model group gather each split leaf, one at a time,
through the host; a checkpoint restores at any model extent) go through
``checkpoint.AsyncCheckpointManager`` (``--ckpt-sync`` for blocking
writes, ``--ckpt-keep`` / ``--ckpt-keep-every`` retention); ``--resume
auto`` restores from the newest checkpoint that verifies, ``latest`` the
newest, ``off`` starts fresh. SIGTERM (or ``--preempt-after N``) ends the
run after the step in flight with a final sync checkpoint, every rank
agreeing on the step; persistent async-write failures degrade to sync
checkpoints. ``--stop-after`` halts early and keeps the ``--steps`` LR
horizon.

Telemetry: with ``--run-dir`` (default ``--ckpt-dir``) rank 0 streams one
schema-v1 JSONL record a step to ``<run-dir>/runlog.jsonl`` (loss,
grad-norm where the step has one, examples/s, and the data-wait /
device-step / ckpt-stall split; data-wait includes the copy of the batch
to the card), checkpoint and resume markers, and a final metrics snapshot,
and exports a Chrome trace (``trace.json``). Summarise with ``python -m
repro_torch.obs.report <run-dir>/runlog.jsonl``. ``--memstats`` prints one
``launch.memstats`` row for the first step (its memory, FLOPs, bytes
accessed and collectives, measured as ``memstats.step_stats`` measures:
on the card its peak is ``torch.cuda.max_memory_allocated`` over the
step) from rank 0, and into the runlog as an ``event`` record
(``event: memstats``), and the loop goes on from that step's state.

Health (DESIGN.md §14): ``--health`` arms the anomaly detectors on rank 0
(non-finite loss or gradient norm, gradient-norm and loss spikes by a
windowed MAD z-score, loss plateau, data-wait stall, per-host straggler
skew): anomalies become runlog records, trace instants, ``health/*``
counters and flight-recorder dumps under ``<run-dir>/flight/``. It also
arms the step guard on every rank (``steps.guard_nonfinite``): a step
whose global loss or gradient norm is not finite keeps the incoming
params and optimizer state on the device, and finite steps are bit for
bit the unguarded ones. ``--metrics-port P`` serves ``/metrics``,
``/healthz`` (the monitor's status) and ``/snapshot.json`` from rank 0
on 127.0.0.1:P for the whole run (0 picks a free port, written to
``<run-dir>/metrics_port``). The step fault hook
(``obs.health.set_step_fault_hook``) sees every rank's batch on the
device right before the step: the seam the NaN-injection checks drive.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import signal
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import checkpoint as ckpt
from repro_torch.configs import (ArchConfig, get_arch, smoke_dual_variant,
                                 smoke_variant)
from repro_torch.core import sharding as shd
from repro_torch.core import tensor_parallel as tpl
from repro_torch.core import weight_sharding as ws
from repro_torch.core.remat import get_policy, list_policies
from repro_torch.data.pipeline import Prefetcher, host_rng
from repro_torch.data.sharded.loader import device_put_global
from repro_torch.device import resolve_device
from repro_torch.interop import init_params
from repro_torch.launch import steps as st
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import frontends
from repro_torch.models import transformer as tf
from repro_torch.models.attention import ALIASES, available_backends
from repro_torch.models.precision import list_policies as precisions
from repro_torch.obs import export as obs_export
from repro_torch.obs import health as obs_health
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import runlog as obs_runlog
from repro_torch.obs import trace as obs_trace
from repro_torch.optim import AdaFactorW, warmup_cosine
from repro_torch.tree import tree_leaves, tree_map, unflatten


def param_layout(cfg, mesh, sharding: str = "basic_ws"):
    """The ``core.weight_sharding`` layout of ``cfg``'s params on ``mesh``
    under the ``sharding`` rule (``core.sharding.params_specs``), or None
    when every leaf stays whole (one model rank, or ``replicated``).
    Under ``tp`` a layout of mode 'tp' (``core.tensor_parallel.layout``,
    which refuses heads, ff dims, d_inner or state dims that do not
    divide)."""
    like = init_params(cfg, torch.Generator(), "meta")
    if sharding == "tp":
        return tpl.layout(cfg, like, mesh)
    return ws.from_specs(shd.params_specs(like, mesh, sharding), mesh)


def state_layout(opt, params, layout):
    """The layout of ``opt``'s state over ``params`` (this rank's parts,
    under ``layout``): ``AdaFactorW.split_dims`` of the whole shapes."""
    if layout is None:
        return None
    return ws.Layout(opt.split_dims(ws.whole_like(params, layout), layout),
                     layout.axis)


def _on(tree, device):
    """``tree`` with every leaf moved to ``device`` (NamedTuples kept)."""
    return unflatten(tree, [x.to(device) for x in tree_leaves(tree)])


def build_state(cfg, opt, seed: int, device, mesh=None,
                sharding: str = "basic_ws"):
    """Params drawn from ``seed`` on ``device`` (the same on every rank: a
    generator of the device's type seeded alike) and their optimizer
    state, placed on ``mesh`` under the ``sharding`` rule: with a split
    over the model axis (``param_layout``) each rank keeps its parts of
    the split leaves and slots. The whole params are cut leaf by leaf,
    each whole leaf freed once its part is taken, and the zeroed slots
    are made at their parts' shapes only, so a rank never holds more than
    the whole params (on a card the peak-memory counter is reset after
    that, so it counts the run). Returns (params, opt_state)."""
    params = init_params(cfg, torch.Generator(device=device).manual_seed(
        seed), device)
    layout = None if mesh is None else param_layout(cfg, mesh, sharding)
    if layout is None:
        return params, opt.init(params)
    like = ws.whole_like(params, None)
    flat = tree_leaves(params)
    del params
    for i, d in enumerate(layout.flat_dims):
        flat[i] = ws.cut_leaf(flat[i], d, layout.axis)
    params = unflatten(like, flat)
    # the slots are zeros: cut their meta stand-ins, then make the parts
    slots = ws.cut(opt.init(like), ws.Layout(opt.split_dims(like, layout),
                                             layout.axis))
    opt_state = unflatten(slots, [torch.zeros_like(t, device=device)
                                  for t in tree_leaves(slots)])
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    return params, opt_state


def _make_manager(args, registry=None):
    """The run's AsyncCheckpointManager (None without ``--ckpt-dir``):
    ``--ckpt-sync`` starts in blocking mode, ``--ckpt-keep`` /
    ``--ckpt-keep-every`` set the retention."""
    if not args.ckpt_dir:
        return None
    return ckpt.AsyncCheckpointManager(
        args.ckpt_dir, sync=bool(getattr(args, "ckpt_sync", False)),
        keep_last=int(getattr(args, "ckpt_keep", 0) or 0),
        keep_every=int(getattr(args, "ckpt_keep_every", 0) or 0),
        registry=registry)


def _make_obs(args, resumed_from, mesh):
    """The run's telemetry: a metrics Registry on every rank, and on rank
    0, when the run has a directory (``--run-dir``, default
    ``--ckpt-dir``), a span Tracer and a RunLogger. A resumed run APPENDS
    to the runlog with a ``resume`` marker. Returns (registry, tracer,
    runlog, run_dir)."""
    run_dir = getattr(args, "run_dir", None) or args.ckpt_dir
    registry = obs_metrics.Registry()
    tracer = runlog = None
    if run_dir and mesh.rank == 0:
        os.makedirs(run_dir, exist_ok=True)
        tracer = obs_trace.Tracer()
        meta = {"arch": args.arch,
                "objective": getattr(args, "objective", "auto"),
                "batch": args.batch, "steps": args.steps, "seed": args.seed,
                "ranks": mesh.ranks, "data": mesh.data_size,
                "model": mesh.model_size,
                "sharding": getattr(args, "sharding", "basic_ws")}
        runlog = obs_runlog.RunLogger(os.path.join(run_dir, "runlog.jsonl"),
                                      meta=meta,
                                      resumed_from=resumed_from or None)
    return registry, tracer, runlog, run_dir


def _make_health(args, registry, tracer, runlog, run_dir, mesh):
    """Rank 0's active monitoring: a ``HealthMonitor`` under ``--health``
    (the default detector set, its flight recorder writing into the run
    dir) and a started ``MetricsServer`` under ``--metrics-port`` (0 =
    ephemeral; the bound port is written to ``<run_dir>/metrics_port``).
    Either can be on without the other; ``/healthz`` reports the
    monitor's status when both are. Returns (monitor, server), None on
    the other ranks."""
    monitor = server = None
    if mesh.rank != 0:
        return monitor, server
    if getattr(args, "health", False):
        monitor = obs_health.HealthMonitor(registry=registry, tracer=tracer,
                                           runlog=runlog, run_dir=run_dir)
    port = getattr(args, "metrics_port", None)
    if port is not None:
        server = obs_export.MetricsServer(
            registry, health=monitor.status if monitor else None,
            port=int(port), run_dir=run_dir).start()
        if not getattr(args, "quiet", False):
            print(f"obs: serving /metrics /healthz /snapshot.json on "
                  f"{server.url}")
    return monitor, server


def _run_loop(args, step_fn, params, opt_state, stream, start, *, mesh,
              device, ckpt_meta_fn=None, registry=None, tracer=None,
              runlog=None, run_dir=None, part=(0, 1), dims=None,
              monitor=None, server=None, memstats_label=None):
    """The step / log / checkpoint loop from step ``start``; returns the
    per-step losses. ``stream`` yields a numpy block of each step from
    ``start`` on (drawn ahead on a prefetch thread; its sub-block ``part``
    is moved to ``device`` on the loop's thread, then passed through the
    step fault hook) and is closed when the loop ends;
    ``ckpt_meta_fn(next_step) -> dict`` is the user meta of every
    checkpoint (the loader's state); ``dims`` the split dims of the leaves
    of (params, opt_state) when they are parts (None: whole).

    Every rank runs the same steps; rank 0 writes checkpoints, the runlog
    and the trace. A checkpoint holds whole leaves: the other ranks of
    rank 0's model group join its gather of each split leaf. SIGTERM (the
    preemption signal) is caught: the step in flight finishes, the ranks
    agree (a max all-reduce of the flag each step), rank 0 writes a final
    SYNC checkpoint, and the loop returns, so a preempted run resumes
    from its last step. A persistent async-write failure degrades the run
    to synchronous checkpoints.

    With a ``monitor`` (rank 0) every step's host-side floats feed the
    anomaly detectors, and a step the guard skipped is marked ``skipped``
    in its runlog record; a ``server`` is stopped when the loop ends.
    With a ``memstats_label`` the first step runs under
    ``memstats.measured_step`` and rank 0 prints its row."""
    stop = getattr(args, "stop_after", None) or args.steps
    lead = mesh.rank == 0
    quiet = bool(getattr(args, "quiet", False)) or not lead
    t0, losses = time.time(), []
    manager = _make_manager(args, registry) if lead else None
    preempted = threading.Event()
    prev_handler = None
    if threading.current_thread() is threading.main_thread():
        prev_handler = signal.signal(
            signal.SIGTERM, lambda signum, frame: preempted.set())
    preempt_after = getattr(args, "preempt_after", None)
    flag = torch.zeros((1,), dtype=torch.float32, device=device)
    whole = None if dims is None else \
        (lambda i, x: ws.gather_leaf(x, dims[i], mesh.model))

    def save(step, *, final=False, event="save"):
        """Checkpoint (rank 0) with degrade-on-failure; returns the loop's
        stall in seconds. Each save that reaches its snapshot gathers the
        split leaves once, so the other ranks of rank 0's model group
        gather along once per call."""
        tree = (params, opt_state)
        if manager is None:
            if whole is not None and args.ckpt_dir and mesh.data_index == 0:
                for i, x in enumerate(tree_leaves(tree)):
                    whole(i, x)
            return 0.0
        meta = ckpt_meta_fn(step) if ckpt_meta_fn else None
        t_save = time.perf_counter()
        try:
            if final:
                manager.save_sync(step, tree, meta=meta, whole=whole)
            else:
                manager.save(step, tree, meta=meta, whole=whole)
        except ckpt.CheckpointError as e:
            # a previous async write died after its retries: keep training
            # only with durability, so go blocking and write this step now
            print(f"ckpt: async write failed ({e}); degrading to sync")
            manager.degrade_to_sync()
            if runlog:
                runlog.log("checkpoint", step=step, event="degrade_to_sync",
                           error=str(e))
            manager.save_sync(step, tree, meta=meta, whole=whole)
        stall = time.perf_counter() - t_save
        if runlog:
            runlog.log("checkpoint", step=step, event=event,
                       sync=bool(final or manager.sync), stall_s=stall)
        return stall

    final_saved = False
    try:
        for i in range(start, min(args.steps, stop)):
            t_iter = time.perf_counter()
            with obs_trace.span(tracer, "data_wait", step=i):
                batch = device_put_global(next(stream), device, part)
            batch = obs_health.apply_step_fault_hook(i, batch)
            t_data = time.perf_counter()
            with obs_trace.span(tracer, "device_step", step=i):
                if memstats_label is not None and i == start:
                    from repro_torch.launch import memstats
                    (params, opt_state, loss, metrics), row = \
                        memstats.measured_step(
                            step_fn, (params, opt_state, batch),
                            label=memstats_label)
                    if lead:
                        print(memstats.format_rows([row]), flush=True)
                    if runlog:
                        runlog.log("event", event="memstats", step=i,
                                   row=row)
                else:
                    params, opt_state, loss, metrics = step_fn(
                        params, opt_state, batch)
                loss_f = float(loss)   # waits for the device step
            t_device = time.perf_counter()
            losses.append(loss_f)
            ckpt_stall, breaking = 0.0, False
            if preempt_after is not None and i - start + 1 == preempt_after:
                # simulated preemption: a REAL SIGTERM to ourselves, so the
                # exact signal path runs
                os.kill(os.getpid(), signal.SIGTERM)
            flag.fill_(float(preempted.is_set()))
            if float(mesh.all_reduce(flag, "max")[0]):
                if args.ckpt_dir and lead:
                    print(f"SIGTERM: preemption checkpoint at step {i + 1}")
                with obs_trace.span(tracer, "ckpt_stall", step=i):
                    ckpt_stall += save(i + 1, final=True,
                                       event="preempt_save")
                final_saved = breaking = True
            elif args.ckpt_dir and args.ckpt_every and \
                    (i + 1) % args.ckpt_every == 0:
                with obs_trace.span(tracer, "ckpt_stall", step=i):
                    ckpt_stall += save(i + 1)
            step_s = time.perf_counter() - t_iter
            gnorm = metrics.get("grad_norm")
            gnorm_f = None if gnorm is None else float(gnorm)
            skipped = bool(int(metrics.get("skipped", 0)))
            step_rec = None
            if runlog:
                extra = {} if gnorm_f is None else {"grad_norm": gnorm_f}
                if skipped:
                    extra["skipped"] = 1
                step_rec = runlog.log_step(
                    i, loss=loss_f, data_wait_s=t_data - t_iter,
                    device_step_s=t_device - t_data, ckpt_stall_s=ckpt_stall,
                    step_s=step_s, examples_per_sec=args.batch / step_s,
                    **extra)
            if monitor is not None:
                monitor.observe_step(obs_health.StepSample(
                    step=i, loss=loss_f,
                    grad_norm=math.nan if gnorm_f is None else gnorm_f,
                    data_wait_s=t_data - t_iter,
                    device_step_s=t_device - t_data, step_s=step_s,
                    skipped=skipped), record=step_rec)
            if not quiet and (i % args.log_every == 0
                              or i == args.steps - 1):
                gtxt = "" if gnorm_f is None else f"gnorm {gnorm_f:.2f} "
                print(f"step {i:5d} loss {loss_f:.4f} {gtxt}"
                      f"{(time.time() - t0) / max(1, i - start + 1):.2f}"
                      f"s/step", flush=True)
            if breaking:
                break
    finally:
        stream.close()
        if prev_handler is not None:
            signal.signal(signal.SIGTERM, prev_handler)
    if args.ckpt_dir and not final_saved:
        with obs_trace.span(tracer, "ckpt_stall"):
            save(min(args.steps, stop), final=True, event="final_save")
    if manager is not None:
        manager.close()
    trace_path = None
    if tracer is not None:
        trace_path = tracer.export(os.path.join(run_dir, "trace.json"))
    if runlog:
        if trace_path:
            runlog.log("event", event="trace_export", path=trace_path,
                       dropped=tracer.dropped)
        runlog.log("metrics", **registry.snapshot())
        runlog.close()
    if trace_path and not quiet:
        print(f"obs: trace -> {trace_path} (open in Perfetto)")
    if server is not None:
        server.stop()
    mesh.barrier()       # rank 0's last checkpoint is on disk for every rank
    return losses


def _restore(args, params, opt_state, mesh, device, layout=None,
             slayout=None):
    """Resume per ``--resume``: ``auto`` (default) from
    ``latest_verified_step`` (torn or corrupt step dirs skipped, stale
    temporary dirs removed by rank 0), ``latest`` from the newest step dir,
    ``off`` fresh. Every rank restores the same checkpoint of whole
    leaves; with the params' ``layout`` and the state's ``slayout`` it
    reads them on the host and keeps its parts (so a checkpoint written at
    any model extent restores at any other). Returns (params, opt_state,
    start)."""
    start = 0
    resume = getattr(args, "resume", None) or "auto"
    if args.ckpt_dir and resume != "off":
        latest = (ckpt.latest_verified_step(args.ckpt_dir,
                                            gc=mesh.rank == 0)
                  if resume == "auto" else ckpt.latest_step(args.ckpt_dir))
        if latest:
            like = (ws.whole_like(params, layout),
                    ws.whole_like(opt_state, slayout))
            params, opt_state = ckpt.restore(
                args.ckpt_dir, latest, like,
                device=device if layout is None else "cpu")
            if layout is not None:
                params = _on(ws.cut(params, layout), device)
                opt_state = _on(ws.cut(opt_state, slayout), device)
            start = latest
            if mesh.rank == 0:
                print(f"resumed from step {start} (--resume {resume})")
    mesh.barrier()
    return params, opt_state, start


def arch_config(args):
    """The run's config: ``--arch``, its ``--smoke`` variant."""
    cfg = get_arch(args.arch)
    if getattr(args, "smoke", False):
        cfg = (smoke_variant(cfg) if isinstance(cfg, ArchConfig)
               else smoke_dual_variant(cfg))
    return cfg


def setup(args):
    """(device, mesh) of a run: the card ``cuda:LOCAL_RANK`` (modulo the
    cards present, so ranks may share one) unless ``--device cpu``, and
    the (data, model) mesh of the live ranks (``--model-parallel``; a
    world that does not divide by it raises ValueError). Under ``--sharding
    tp`` the model is checked first (``tensor_parallel.check``): heads,
    an ff dim, d_inner or a state dim that do not divide by M raise
    ValueError."""
    model = getattr(args, "model_parallel", 1)
    if getattr(args, "sharding", "basic_ws") == "tp":
        tpl.check(arch_config(args), model)
    device = resolve_device(getattr(args, "device", None))
    mesh = make_local_mesh(model=model)
    if device.type == "cuda" and device.index is None:
        local = int(os.environ.get("LOCAL_RANK", mesh.rank))
        device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
    return device, mesh


def train_lm(args):
    """LM objective over the live ranks; returns the per-step losses."""
    device, mesh = setup(args)
    cfg = arch_config(args)
    if getattr(args, "attn", None):
        cfg = dataclasses.replace(cfg, attn_impl=args.attn)
    opt = AdaFactorW(weight_decay=0.0025)
    lr_fn = warmup_cosine(args.lr, args.lr / 100, max(1, args.steps // 10),
                          args.steps)
    moe_args = {"dispatch": "dense"} if args.smoke else None
    layout = param_layout(cfg, mesh, args.sharding)
    ranks = _split_ranks(args, mesh, layout)
    _check_moe_groups(cfg, moe_args, args.batch, args.seq, ranks)
    params, opt_state = build_state(cfg, opt, args.seed, device, mesh,
                                    args.sharding)
    slayout = state_layout(opt, params, layout)
    params, opt_state, start = _restore(args, params, opt_state, mesh,
                                        device, layout, slayout)
    registry, tracer, runlog, run_dir = _make_obs(args, start, mesh)
    monitor, server = _make_health(args, registry, tracer, runlog, run_dir,
                                   mesh)
    step_fn = st.lm_step(cfg, opt, lr_fn,
                         precision=getattr(args, "precision", None) or "f32",
                         remat_policy=get_policy(args.remat),
                         moe_args=moe_args, mesh=mesh, layout=layout,
                         skip_nonfinite=bool(getattr(args, "health", False)))
    axes = (shd.DATA,) if tpl.active(layout) else (shd.DATA, shd.MODEL)

    def make_batch(step):
        # every rank draws the global batch of the step and keeps its rows
        b = frontends.synthetic_inputs(cfg, args.batch, args.seq,
                                       host_rng(args.seed, 0, step),
                                       device="cpu")
        specs = shd.batch_specs(b, mesh, batch_axes=axes, strict=True)
        return tree_map(lambda t: t.numpy(), shd.shard(b, specs, mesh))

    return _run_loop(args, step_fn, params, opt_state,
                     Prefetcher(make_batch, depth=2, start=start), start,
                     mesh=mesh, device=device, registry=registry,
                     tracer=tracer, runlog=runlog, run_dir=run_dir,
                     dims=_dims(layout, slayout), monitor=monitor,
                     server=server, memstats_label=_memstats_label(
                         args, f"seq={args.seq}"))


def _memstats_label(args, what: str):
    """The ``--memstats`` row's label (None without the flag)."""
    if not getattr(args, "memstats", False):
        return None
    return f"{args.arch} B={args.batch} {what} remat={args.remat}"


def _split_ranks(args, mesh, layout) -> int:
    """The ranks the global batch is split over (every rank, or under
    ``tp`` the data shards, whose model ranks share a block); SystemExit
    when ``--batch`` does not divide into equal blocks over them."""
    n = st.batch_group(mesh, layout).ranks
    if args.batch % n:
        what = (f"{n} data shards (tp: the {mesh.model_size} model ranks "
                f"of a shard share its block)" if tpl.active(layout) else
                f"{n} ranks (data {mesh.data_size} x model "
                f"{mesh.model_size}; one equal block each)")
        raise SystemExit(f"--batch {args.batch} must be divisible by the "
                         f"{what}")
    return n


def _dims(layout, slayout):
    """The split dims of the leaves of (params, opt_state), or None."""
    return None if layout is None else layout.flat_dims + slayout.flat_dims


def _check_moe_groups(cfg, moe_args, batch: int, seq: int, ranks: int):
    """A MoE model under capacity dispatch cuts the tokens into groups of
    min(group, b·s) (reference ``repro/models/moe.py:104-112``); the ranks
    must cut theirs as the whole batch would be cut, or the routing would
    differ from the single-device run's. Raises ValueError otherwise."""
    margs = dict(st.DEFAULT_MOE_ARGS, **(moe_args or {}))
    if cfg.moe is None or margs["dispatch"] != "capacity" or ranks == 1:
        return
    whole = min(margs["group"], batch * seq)
    mine = (batch // ranks) * seq
    if min(margs["group"], mine) != whole or mine % whole:
        raise ValueError(
            f"{cfg.name}: capacity groups of {whole} tokens of the global "
            f"batch ({batch} x {seq}) do not fall on a rank's "
            f"{batch // ranks} rows ({mine} tokens) over {ranks} ranks; "
            f"use a batch whose rows per rank hold whole groups")


def make_loader(args, cfg, layout, registry=None, tracer=None):
    """The contrastive run's ``data.sharded.ShardedLoader`` under
    ``layout``: the synthetic world drawn from
    ``np.random.default_rng(seed)`` (16 classes, noise 0.2, as the
    reference's trainer draws it), the tokenizer artifact ``--tokenizer``,
    and ``--augment``'s ops."""
    from repro_torch.data import world_for_tower
    from repro_torch.data.sharded import (ShardedLoader,
                                          default_augmentations,
                                          load_tokenizer)
    world = world_for_tower(np.random.default_rng(args.seed), cfg.image_tower,
                            n_classes=16, noise=0.2)
    tok = load_tokenizer(getattr(args, "tokenizer", None) or "v1")
    augment = default_augmentations() \
        if getattr(args, "augment", "off") == "on" else ()
    return ShardedLoader(world, tok, args.batch, layout=layout,
                         seed=args.seed, text_len=args.seq, augment=augment,
                         registry=registry, tracer=tracer)


def train_contrastive(args):
    """The paper's objective: GradAccum over each rank's block × data
    parallelism, with the cross-shard global-batch contrastive loss.
    Returns the per-step losses.

    Input (DESIGN.md §9): the versioned tokenizer artifact, a
    ``data.sharded.ShardedLoader`` with one block per data shard
    (``HostLayout(data extent, data index)``; the shard's M model ranks
    each keep their sub-block), optional ``--augment``, and the loader's
    state as checkpoint meta: rank 0 records its state, and on resume every
    rank checks it against its own loader (with its own host id), so a
    changed tokenizer, layout, seed or augmentation stops the run instead
    of replaying other batches."""
    from repro_torch.data.sharded import HostLayout
    from repro_torch.data.sharded.loader import LoaderState

    device, mesh = setup(args)
    cfg = arch_config(args)
    num_micro = getattr(args, "num_micro", 2)
    loss = getattr(args, "loss", "chunked")
    layout = param_layout(cfg, mesh, args.sharding)
    ranks = _split_ranks(args, mesh, layout)
    if (args.batch // ranks) % num_micro:
        raise SystemExit(f"each rank's block of {args.batch // ranks} must "
                         f"be divisible by --num-micro {num_micro}")
    step_fn, opt = st.make_contrastive_step(
        cfg, num_micro=num_micro, remat=args.remat,
        remat_image=getattr(args, "remat_image", None),
        remat_text=getattr(args, "remat_text", None),
        precision=getattr(args, "precision", None) or "bf16",
        attn=getattr(args, "attn", None), lr=args.lr, mesh=mesh, loss=loss,
        layout=layout, skip_nonfinite=bool(getattr(args, "health", False)))
    params, opt_state = build_state(cfg, opt, args.seed, device, mesh,
                                    args.sharding)
    slayout = state_layout(opt, params, layout)
    params, opt_state, start = _restore(args, params, opt_state, mesh,
                                        device, layout, slayout)

    registry, tracer, runlog, run_dir = _make_obs(args, start, mesh)
    monitor, server = _make_health(args, registry, tracer, runlog, run_dir,
                                   mesh)
    if tracer is not None:
        tracer.set_process_name(1, "host 0")
    loader = make_loader(args, cfg,
                         HostLayout(mesh.data_size, mesh.data_index),
                         registry, tracer)
    if start and args.ckpt_dir and \
            (meta := ckpt.load_meta(args.ckpt_dir, start)) \
            and "loader" in meta:
        state = LoaderState.from_json(meta["loader"])
        loader.restore(dataclasses.replace(state, host_id=mesh.data_index))
    else:
        loader.restore(loader.state(step=start))

    def ckpt_meta_fn(next_step):
        # the stream advanced the cursor once for each block the loop took
        state = loader.state()
        assert state.step == next_step, (state.step, next_step)
        return {"loader": state.to_json()}

    return _run_loop(args, step_fn, params, opt_state, loader.stream(depth=2),
                     start, mesh=mesh, device=device,
                     ckpt_meta_fn=ckpt_meta_fn, registry=registry,
                     tracer=tracer, runlog=runlog, run_dir=run_dir,
                     part=((0, 1) if tpl.active(layout) else
                           (mesh.model_index, mesh.model_size)),
                     dims=_dims(layout, slayout), monitor=monitor,
                     server=server, memstats_label=_memstats_label(
                         args, f"micro={num_micro} loss={loss}"))


def train(args):
    """Dispatch on ``--objective`` (``auto``: lm for decoder LMs,
    contrastive for dual encoders); returns the per-step losses."""
    objective = getattr(args, "objective", "auto")
    if objective == "auto":
        objective = ("lm" if isinstance(get_arch(args.arch), ArchConfig)
                     else "contrastive")
    if objective == "lm":
        return train_lm(args)
    return train_contrastive(args)


def parse_args(argv: Optional[Sequence[str]] = None):
    """The trainer's command line: the reference's flags and ``--device``."""
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True,
                    help="arch name (decoder LMs train the lm objective; "
                         "basic-{s,m,l} contrastive)")
    ap.add_argument("--objective", default="auto",
                    choices=["auto", "lm", "contrastive"])
    ap.add_argument("--smoke", action="store_true",
                    help="CPU-sized variant of the arch")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8,
                    help="GLOBAL batch (split over the ranks)")
    ap.add_argument("--seq", type=int, default=128,
                    help="sequence length (lm) / caption length "
                         "(contrastive)")
    ap.add_argument("--lr", type=float, default=1e-3,
                    help="peak LR (lm: warmup-cosine; contrastive: "
                         "constant)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sharding", default="basic_ws",
                    choices=["basic_ws", "tp", "replicated"],
                    help="weight-sharding rule (core.sharding."
                         "params_specs) the params are placed by: basic_ws "
                         "splits weights and their optimizer slots over the "
                         "model axis and gathers them on use (paper §5.1), "
                         "tp splits them Megatron-style and computes with "
                         "the parts (the model ranks of a data shard share "
                         "its block; every family), replicated "
                         "keeps them whole")
    remat_names = list_policies() + ["off"]
    ap.add_argument("--remat", default="basic", choices=remat_names)
    ap.add_argument("--remat-image", default=None, choices=remat_names,
                    help="override --remat for the image tower")
    ap.add_argument("--remat-text", default=None, choices=remat_names,
                    help="override --remat for the text tower")
    ap.add_argument("--precision", default=None, choices=precisions(),
                    help="precision policy (default f32 for lm, bf16 for "
                         "contrastive)")
    ap.add_argument("--attn", default=None,
                    choices=sorted(set(available_backends()) | set(ALIASES)
                                   | {"auto"}),
                    help="attention backend of every tower ('pallas' is "
                         "the flash kernels)")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="model-axis size M: the world is a (world / M, M) "
                         "grid; the batch splits over every rank (under tp "
                         "over the world / M data shards)")
    ap.add_argument("--num-micro", type=int, default=2,
                    help="GradAccum microbatches of each rank's block")
    ap.add_argument("--loss", default="chunked",
                    choices=sorted(st.LOSSES) + list(st.DISTRIBUTED_LOSSES),
                    help="contrastive loss: 'allgather' / 'chunked' over "
                         "the global batch, 'local' / 'fused' on one rank")
    ap.add_argument("--memstats", action="store_true",
                    help="print the per-step memory/FLOPs report of the "
                         "first step (launch/memstats.py)")
    ap.add_argument("--augment", default="off", choices=["on", "off"],
                    help="train-time image augmentation (contrastive)")
    ap.add_argument("--tokenizer", default="v1",
                    help="tokenizer artifact version "
                         "(artifacts/tokenizer_<v>.json)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--quiet", action="store_true",
                    help="no per-step stdout lines")
    ap.add_argument("--health", action="store_true",
                    help="active monitoring: anomaly detectors on loss / "
                         "grad / data-wait (anomaly runlog records and "
                         "flight-recorder dumps into the run dir) and the "
                         "non-finite step guard: a NaN loss or gradient "
                         "keeps the incoming params instead of poisoning "
                         "them")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve live /metrics (Prometheus), /healthz and "
                         "/snapshot.json on 127.0.0.1:PORT for the whole "
                         "run (0 = ephemeral; the bound port is written "
                         "to <run-dir>/metrics_port)")
    ap.add_argument("--run-dir", default=None,
                    help="directory of runlog.jsonl and trace.json "
                         "(default --ckpt-dir)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--ckpt-sync", action="store_true",
                    help="blocking checkpoint writes (default async)")
    ap.add_argument("--ckpt-keep", type=int, default=0,
                    help="keep only the newest K checkpoints (0 = all)")
    ap.add_argument("--ckpt-keep-every", type=int, default=0,
                    help="also keep every Nth step (0 = none)")
    ap.add_argument("--resume", default="auto",
                    choices=["auto", "latest", "off"])
    ap.add_argument("--preempt-after", type=int, default=None,
                    help="SIGTERM ourselves after N steps (the preemption "
                         "path)")
    ap.add_argument("--stop-after", type=int, default=None,
                    help="halt early but keep the --steps LR horizon")
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None):
    """Parse ``argv``; under ``torchrun`` start the process group (NCCL
    when each local rank has a card of its own, else gloo); train; return
    the per-step losses."""
    args = parse_args(argv)
    started = False
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 and \
            not dist.is_initialized():
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE",
                                         os.environ["WORLD_SIZE"]))
        own_card = (args.device in (None, "cuda")
                    and torch.cuda.is_available()
                    and torch.cuda.device_count() >= local_world)
        dist.init_process_group("nccl" if own_card else "gloo")
        started = True
    try:
        return train(args)
    finally:
        if started:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
