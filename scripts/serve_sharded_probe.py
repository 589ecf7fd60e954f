"""Sharded serving on NCCL, one rank per card: the prefill and decode steps
on a rank's parts of the weights (``steps.make_prefill_step`` /
``make_serve_step`` with a layout, ``--sharding tp`` or ``basic_ws``).

    torchrun --nproc-per-node 4 scripts/serve_sharded_probe.py
    torchrun --nproc-per-node 2 scripts/serve_sharded_probe.py \\
        --device cpu --smoke             # the same runs on gloo ranks
    torchrun --nproc-per-node 4 scripts/serve_sharded_probe.py \\
        --grid 1,4 --batch 1 --prompt 4096 --cache 524288 \\
        --runs jamba-1.5-large-398b:basic_ws:8   # a KV cache split 4 ways

Each run of ``--runs`` (``arch:rule[:layers]``, a comma list; the rule
``tp``, ``basic_ws`` or ``one``, one card alone: rank 0 serves the whole
model while the others wait; ``layers`` cuts the model to its first ones
at full width: Jamba-1.5-Large runs its first period of 8 of 72 layers,
4 of each MoE layer's 16 experts a card under ``tp``) places the weights
by ``steps.serving_layout`` on the (D, M) mesh of ``--grid`` (default (1,
R) over the R ranks; under ``tp`` the leaves a block uses whole are held
whole, so a step gathers only the logits) and serves one lockstep greedy
batch: ``--batch`` prompts of ``--prompt`` random tokens (a rank serves
its data shard's rows, ``steps.batch_rows``), prefilled into a cache of
``--cache`` slots (``collect_cache_len``: linear, or the window's ring
when it equals the window), then ``--new`` decode steps, each feeding
the last step's argmax back (the prefill runs twice: the first, cold,
warms the libraries and the collectives up, the second is timed; two
decode steps after the timed ones run in ``chip_smoke``'s profiler
window on a card, one small op after the tracer starts and taken again
while it lost a launch's device records, for rank 0's device time a
step, its share of the window (which the profiler slows) and of the
unprofiled step median, with and without the collectives' kernels (which
also wait for the slowest rank), and its kernels' and its host's
milliseconds a step). The attention runs on the hand-written
flash (prefill) and decode kernels on a card (``attn_impl`` 'pallas'),
their plain versions on the CPU. Rank 0 prints, per run, the prefill's
milliseconds, the decode step's median and p90 (host clock around a
synchronized step, argmax included), tokens a second over the steps,
each rank's peak GiB (``max_memory_allocated`` since before its weights
were placed), its params, cache and KV cache bytes, its kernel launches
(by the shapes the wrappers saw), and the bytes it handed to
``launch/mesh.py``'s collectives in the prefill and in a decode step, by
operation (``launch.roofline.CollectiveBytes``). The KV caches lie where
``steps.cache_seq_axis`` places them for the global batch and the cache
length (the reference's ``cache_specs``): a rank then holds its slice of
each cache's sequence, and each decode step merges the slices' partial
attentions (``seq`` in the report: the mesh axis and its ranks). Every
rank's tokens must be those of rank 0 of the ranks that serve the same
rows. A ``one`` run after a sharded run of
the same arch also gives the largest |logit| difference of the sharded
prefill from the one-card prefill (rank 0's rows) and the share of greedy
tokens both runs chose alike.

The weights are not ``init_params``' draw of the whole model (the f32
params of InternVL2-76B, 282 GB, fit no card): each rank draws one layer
at a time with the reference's init law (``transformer._init_block``,
which ``init_params`` stacks), from a generator seeded with ``--seed``
and the layer's index, keeps its part under the rule, casts it to
``--dtype`` and frees the rest; the embedding, the LM head and the final
norm are drawn, cut and cast the same way, leaf by leaf. So a rank never
holds more than one layer's f32 leaves whole (Jamba's MoE layer, 38.7
GB), and every rank draws the same weights.

Rank 0 prints the card's name and power limit first and one ``PROBE
{json}`` line last; it exits non-zero when a check fails (ranks that
disagree, a logit that is not finite, or on a card a rank that did not
launch the flash and decode kernels, and the scan for a model with
Mamba-2 layers).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)        # chip_smoke's profiler windows

RUNS = ("internvl2-76b:tp,jamba-1.5-large-398b:tp:8,llama3.2-1b:tp,"
        "llama3.2-1b:basic_ws,llama3.2-1b:one")


def card_line() -> str:
    """The card's name and power limit (nvidia-smi), or 'cpu'."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return "cpu"
    return out.stdout.strip().splitlines()[0]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="'cuda' or 'cpu'")
    ap.add_argument("--smoke", action="store_true",
                    help="smoke configs, 32-token prompts, a cache of 64 "
                         "and 4 new tokens, f32")
    ap.add_argument("--runs", default=RUNS,
                    help="comma list of arch:rule[:layers], the rule tp, "
                         "basic_ws or one (rank 0 alone, the whole model), "
                         "layers a cut to the first ones")
    ap.add_argument("--grid", default=None,
                    help="D,M: the (data, model) mesh of the ranks "
                         "(default 1,R)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=512)
    ap.add_argument("--cache", type=int, default=4096)
    ap.add_argument("--new", type=int, default=64)
    ap.add_argument("--dtype", default="bf16", choices=["bf16", "f32"])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.smoke:
        args.prompt, args.cache, args.new, args.dtype = 32, 64, 4, "f32"
    return args


def place_params(cfg, layout, dtype, seed, device):
    """This rank's parts of ``cfg``'s params under ``layout`` (whole with
    None) in ``dtype``, drawn one layer (and one top-level leaf) at a time
    with the init law of ``init_params`` (``transformer._init_block``),
    each whole piece freed once its part is taken (the module
    docstring)."""
    import torch

    from repro_torch.core import weight_sharding as ws
    from repro_torch.interop import init_params
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as tf
    from repro_torch.tree import leaves, tree_leaves, unflatten

    def gen(i):
        return torch.Generator(device=device).manual_seed(seed * 100003 + i)

    def part(x, d):
        out = x if layout is None else ws.cut_leaf(x, d, layout.axis)
        return out.to(dtype) if out.is_floating_point() else out

    period = tf.period_of(cfg)
    n = cfg.n_layers // period
    kinds, moe_mask = cfg.layer_kinds(), cfg.moe_layer_mask()
    like = init_params(cfg, torch.Generator(), "meta")
    flat_dims = [None] * len(tree_leaves(like)) if layout is None \
        else layout.flat_dims
    dims = dict(zip((p for p, _ in leaves(like)), flat_dims))
    out = {}
    blocks = {}                 # the rank's stacked leaves, (n, *part)
    for j in range(n):
        for i in range(period):
            # one layer: Jamba's MoE layer is 38.7 GB of f32 experts
            drawn = tf._init_block(cfg, gen(1 + j * period + i), kinds[i],
                                   moe_mask[i], (1,), device)
            for p, x in leaves(drawn):
                x = part(x, dims[f"blocks/{i}/{p}"])
                if j == 0:
                    blocks[f"{i}/{p}"] = torch.empty(
                        (n, *x.shape[1:]), dtype=x.dtype, device=device)
                blocks[f"{i}/{p}"][j] = x[0]
            del drawn, x
    out["blocks"] = unflatten(like["blocks"], [
        blocks[p] for p, _ in leaves(like["blocks"])])
    del blocks
    d = cfg.d_model
    top = {"final_norm": lambda g: torch.ones((d,), device=device),
           "embed": lambda g: L.trunc_normal(g, (cfg.vocab, d), d ** -0.5,
                                             device),
           "lm_head": lambda g: L.dense_init(g, d, cfg.vocab, device=device)}
    if cfg.frontend == "vision":
        from repro_torch.models import frontends as fe
        top["frontend"] = lambda g: fe.init_vision_frontend(cfg, g, device)
    for i, key in enumerate(k for k in like if k != "blocks"):
        drawn = top[key](gen(cfg.n_layers + 1 + i))
        if isinstance(drawn, dict):
            out[key] = {k: part(v, dims[f"{key}/{k}"])
                        for k, v in drawn.items()}
        else:
            out[key] = part(drawn, dims[key])
        del drawn
    return out


# decode steps in the profiled window after the timed ones
PROFILED_STEPS = 2
# the device kernels of the collectives: on a rank they also wait for the
# slowest rank of the group, so their time is not the work of this one
NCCL = "NCCL collectives"


def profiled(step, n, counters):
    """``step(i)`` for i < n in ``chip_smoke.counted_window``: a
    torch.profiler window whose tracing starts one small device op early
    (the tracer can miss a window's first records), taken again while the
    profiler saw fewer device kernels than the wrappers of ``counters``
    launched. Returns the window's host milliseconds a step (slowed by
    the profiler itself), the device milliseconds a step (the window's
    kernels and copies summed, as ``chip_smoke.device_breakdown`` sums
    them, which also prints them by kernel and by group), without the
    collectives' kernels (``NCCL``), and by group, the device's busy share
    of the window, the 8 kernels that took the most device time and the 8 host
    operations with the most self time (ms, calls), a step each."""
    import chip_smoke as cs

    def steps():
        for i in range(n):
            step(i)
    prof, wall_us, calls = cs.counted_window(steps, counters)
    groups = {}
    _, busy = cs.device_breakdown(
        prof, f"{n} decode steps", wall_us, n,
        {k: v for k, v in calls.items() if v},
        groups=((NCCL, ("nccl",)), *cs.KERNEL_GROUPS), by_group_out=groups)
    table = [e for e in prof.key_averages()
             if not e.key.startswith("ProfilerStep")]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
    kernels = sorted((e for e in table if dev_us(e) > 0), key=dev_us,
                     reverse=True)[:8]
    host = sorted(table, key=lambda e: e.self_cpu_time_total,
                  reverse=True)[:8]
    device = busy * wall_us / n / 1e3
    return {"steps": n, "window_ms_per_step": wall_us / n / 1e3,
            "device_ms": device,
            "device_ms_without_collectives": device - groups.get(NCCL, 0.0),
            "device_busy_of_window": busy,
            "device_ms_by_group": groups,
            "device_ms_per_step": {e.key: dev_us(e) / n / 1e3
                                   for e in kernels},
            "host_ms_per_step": {e.key: [e.self_cpu_time_total / n / 1e3,
                                         e.count / n] for e in host}}


def serve_once(cfg, params, layout, mesh, prompt, args, device,
               counters=(), seq_axis=None):
    """The prefill and ``--new`` greedy decode steps of one lockstep batch
    on this rank (``counters``: the launch counters the profiled window
    checks; ``seq_axis``: the ranks the KV caches' sequence lies over):
    returns (report, prefill logits, tokens (b, new + 1))."""
    import torch

    from repro_torch.launch import steps as st
    from repro_torch.launch.roofline import CollectiveBytes

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    kw = dict(precision="bf16" if args.dtype == "bf16" else "f32",
              mesh=mesh, layout=layout, seq_axis=seq_axis)
    prefill = st.make_prefill_step(cfg, collect_cache_len=args.cache, **kw)
    serve = st.make_serve_step(cfg, **kw)
    with torch.no_grad():
        # a first prefill warms the libraries and the collectives up; its
        # seconds are kept as the cold prefill's
        sync()
        t0 = time.perf_counter()
        prefill(params, {"tokens": prompt})
        sync()
        cold_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with CollectiveBytes() as pre_moved:
            logits, caches = prefill(params, {"tokens": prompt})
        tok = logits.argmax(-1).to(torch.int32)
        sync()
        prefill_s = time.perf_counter() - t0
        first = logits.float().cpu()
        out, secs = [tok], []
        with CollectiveBytes() as moved:
            for i in range(args.new):
                t0 = time.perf_counter()
                logits, caches = serve(params, caches, tok, args.prompt + i)
                tok = logits.argmax(-1).to(torch.int32)
                sync()
                secs.append(time.perf_counter() - t0)
                out.append(tok)
        finite = bool(torch.isfinite(logits).all()) and bool(
            torch.isfinite(first).all())
        prof = None
        if device.type == "cuda":
            at = args.prompt + args.new
            prof = profiled(lambda i: serve(params, caches, tok, at + i),
                            PROFILED_STEPS, counters)
    cache_bytes = sum(x.numel() * x.element_size() for c in caches
                      for x in c)
    kv_bytes = sum(x.numel() * x.element_size() for c in caches
                   if type(c).__name__ == "KVCache" for x in c)
    del caches
    steps = sorted(secs)
    if prof is not None:
        # the device's share of an unprofiled step
        median_ms = statistics.median(secs) * 1e3
        prof["device_busy_of_step_median"] = prof["device_ms"] / median_ms
        prof["compute_busy_of_step_median"] = \
            prof["device_ms_without_collectives"] / median_ms
    rep = {"prefill_ms": prefill_s * 1e3, "cold_prefill_ms": cold_s * 1e3,
           "profile": prof,
           "step_median_ms": statistics.median(secs) * 1e3,
           "step_p90_ms": steps[min(len(steps) - 1,
                                    int(0.9 * len(steps)))] * 1e3,
           "tokens_per_s": prompt.shape[0] * len(secs) / sum(secs),
           "cache_bytes": cache_bytes, "kv_cache_bytes": kv_bytes,
           "finite": finite,
           "prefill_collective_bytes": dict(pre_moved.bytes),
           "prefill_collective_calls": dict(pre_moved.calls),
           "step_collective_bytes": {k: v / len(secs)
                                     for k, v in moved.bytes.items()},
           "step_collective_calls": {k: v / len(secs)
                                     for k, v in moved.calls.items()}}
    return rep, first, torch.cat(out, dim=1).cpu()


def run(argv=None) -> dict:
    """Every run of ``--runs`` on this rank of the running process group;
    returns the report (every rank's records gathered on each rank)."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_arch, smoke_variant
    from repro_torch.device import resolve_device
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.launch import steps as st
    from repro_torch.launch.mesh import Mesh, make_local_mesh
    from repro_torch.tree import tree_leaves
    args = parse_args(argv)
    rank, world = dist.get_rank(), dist.get_world_size()
    data, model = ((1, world) if args.grid is None
                   else tuple(int(n) for n in args.grid.split(",")))
    if data * model != world:
        raise ValueError(f"--grid {data},{model} does not cover the "
                         f"{world} ranks")
    device = resolve_device(args.device or "cuda")
    on_card = device.type == "cuda"
    if on_card:             # one card a rank
        device = torch.device("cuda", int(os.environ.get(
            "LOCAL_RANK", rank)) % torch.cuda.device_count())
        torch.cuda.set_device(device)
    mesh = make_local_mesh(model=model)
    counters = (fa_ops.COUNTER, dec_ops.COUNTER, ssd_ops.COUNTER)
    if on_card:
        from repro_torch.kernels import build as kbuild
        libs = (fa_ops.LIB, dec_ops.LIB, ssd_ops.LIB)
        if rank == 0:
            kbuild.build_all(libs)
        mesh.barrier()
        for lib in libs:
            lib.lib()
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    runs, firsts = [], {}
    for spec in args.runs.split(","):
        arch, rule, *cut = spec.split(":")
        cfg = get_arch(arch)
        cfg = dataclasses.replace(smoke_variant(cfg) if args.smoke else cfg,
                                  attn_impl="pallas" if on_card else "naive")
        if cut:                 # its first layers, at full width
            cfg = dataclasses.replace(cfg, n_layers=int(cut[0]))
        g = torch.Generator().manual_seed(args.seed)
        prompt = torch.randint(4, cfg.vocab, (args.batch, args.prompt),
                               generator=g, dtype=torch.int32).to(device)
        rec = None
        if rule != "one" or rank == 0:
            run_mesh = mesh if rule != "one" else Mesh({"data": 1,
                                                        "model": 1})
            layout = None if rule == "one" else st.serving_layout(
                cfg, mesh, rule)
            n = st.batch_rows(args.batch, run_mesh, layout)
            first = (run_mesh.data_index * n) % args.batch
            seq = (None if rule == "one" else st.cache_seq_axis(
                cfg, mesh, layout, args.batch, args.cache))
            seq_rec = None if seq is None else [
                next(a for a in ("batch", "data", "model")
                     if getattr(mesh, a) is seq), seq.size]
            for c in counters:
                c.reset()
            if on_card:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            params = place_params(cfg, layout, dtype, args.seed, device)
            place_s = time.perf_counter() - t0
            rep, logits0, tokens = serve_once(
                cfg, params, layout, run_mesh, prompt[first:first + n], args,
                device, counters, seq)
            rec = dict(rep, place_s=place_s, params_bytes=sum(
                x.numel() * x.element_size() for x in tree_leaves(params)),
                peak_gib=(torch.cuda.max_memory_allocated(device) / 2**30
                          if on_card else None),
                launches={c.name: c.count for c in counters},
                launch_shapes={c.name: {"x".join(map(str, k)): v
                                        for k, v in c.shapes.items()}
                               for c in counters},
                rows=[first, n], seq=seq_rec, tokens=tokens.tolist())
            del params
            if rule == "one" and arch in firsts:
                f, m, sharded, sharded_tokens = firsts[arch]
                rec["max_logit_diff_vs_sharded"] = float(
                    (logits0[f:f + m] - sharded).abs().max())
                rec["max_abs_logit"] = float(logits0.abs().max())
                rec["tokens_equal_vs_sharded"] = float(
                    (tokens[f:f + m] == sharded_tokens).float().mean())
            elif rule != "one":
                firsts.setdefault(arch, (first, n, logits0, tokens))
        everyone = [None] * world
        dist.all_gather_object(everyone, rec)
        ranks = [r for r in everyone if r is not None]
        # every rank's tokens against those of the first rank serving the
        # same rows
        lead = {}
        for r in ranks:
            lead.setdefault(tuple(r["rows"]), r["tokens"])
        out = {"arch": arch, "rule": rule, "layers": cfg.n_layers,
               "grid": [data, model] if rule != "one" else [1, 1],
               "dtype": args.dtype, "batch": args.batch,
               "prompt": args.prompt, "cache": args.cache, "new": args.new,
               "seq": ranks[0]["seq"],
               "ranks_agree": all(r["tokens"] == lead[tuple(r["rows"])]
                                  for r in ranks),
               "finite": all(r["finite"] for r in ranks),
               **{k: ranks[0][k] for k in (
                   "prefill_ms", "cold_prefill_ms", "step_median_ms",
                   "step_p90_ms", "tokens_per_s", "place_s", "profile")},
               **{k: [r[k] for r in ranks] for k in (
                   "rows", "peak_gib", "params_bytes", "cache_bytes",
                   "kv_cache_bytes", "launches", "launch_shapes",
                   "prefill_collective_bytes", "prefill_collective_calls",
                   "step_collective_bytes", "step_collective_calls")},
               **{k: ranks[0][k] for k in (
                   "max_logit_diff_vs_sharded", "max_abs_logit",
                   "tokens_equal_vs_sharded") if k in ranks[0]}}
        out["launched"] = not on_card or all(
            r["launches"]["flash_fwd"] > 0
            and r["launches"]["decode_attention"] > 0
            and (cfg.ssm is None or r["launches"]["ssd_scan"] > 0)
            for r in ranks)
        out["ok"] = out["ranks_agree"] and out["finite"] and out["launched"]
        if rank == 0:
            print(f"{arch} {rule} {out['grid']}: " + json.dumps(
                {k: v for k, v in out.items() if k != "tokens"}), flush=True)
        runs.append(out)
        mesh.barrier()
    return {"ranks": world, "backend": mesh.backend, "card": card_line(),
            "ok": all(r["ok"] for r in runs), "runs": runs}


def main(argv=None) -> int:
    import torch.distributed as dist
    args = parse_args(argv)
    dist.init_process_group("gloo" if args.device == "cpu" else "nccl")
    try:
        if dist.get_rank() == 0:
            print(card_line(), flush=True)
        report = run(argv)
        if dist.get_rank() == 0:
            print("PROBE " + json.dumps(report), flush=True)
        return 0 if report["ok"] else 1
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(main())
