"""Multi-pod dry run of the port (counterpart of ``repro/launch/dryrun.py``):
trace one rank's step of every (arch × input shape × mesh) on ``meta``
tensors, without allocating or launching anything.

Usage::

  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k \\
      --mesh pod --sharding basic_ws [--remat basic] [--out DIR]
  python -m repro_torch.launch.dryrun --all --mesh pod      # every combo

``--arch`` / ``--shape`` are required unless ``--all``; the dual-encoder
archs (basic-{s,m,l}) trace the paper's contrastive GradAccum step
instead of an LM step. Results land one JSON file per combo under
``--out`` (default experiments/dryrun), cached by file name, under the
reference's names and keys.

Where the reference lowers and compiles one GSPMD program over 256 (pod,
(16, 16)) or 512 (multipod, (2, 16, 16)) placeholder devices, the port
runs one program a rank: this process stands in as rank 0 of a world of
that many ranks on torch's ``fake`` process group
(``launch.mesh.fake_world``), takes its parts of the params and the
optimizer state and its rows of the batch (``steps.shardings_for``), and
runs the step once on ``meta`` tensors under ``launch.memstats``: the
memory is the peak of live bytes, the FLOPs and bytes the traced
operations' plus the hand-written kernels' recorded work, the
collectives the bytes handed to the mesh's collectives. ``lower_s`` is
the trace's seconds; nothing compiles (``compile_s`` 0).

The flags are the reference's. ``--unroll`` means nothing here: the
reference extrapolates a scanned layer stack's cost from unroll 1 and 2,
because XLA costs a loop body once, while the port's trace runs every
layer; the value is accepted and recorded in the JSON. ``--attn pallas``
traces the flash kernels' wrappers (their ``meta`` branches), which
count the kernels' work. The prefill and decode shapes trace a rank's
serving step on its parts and its rows' caches, as the train shapes
trace its training step (``steps.shardings_for``: under ``tp`` it
computes with the parts and holds its kv and SSD heads' caches, under
``basic_ws`` it gathers each layer on use and holds its rows' SSM caches
whole; under either its slice of each KV cache's sequence where the
reference's ``cache_specs`` split it, ``steps.cache_seq_axis``, the
decode step merging the ranks' partial attentions); ``memory`` records
the rank's params bytes and, for decode, its cache bytes. A combo that fails (a shape the port's step
refuses, a data-dependent shape under ``meta``) writes ``ok: false``
with the error, and the exit code counts it.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

from repro_torch.configs.base import (INPUT_SHAPES, InputShape,
                                      applicable_shapes, get_arch,
                                      list_archs)
from repro_torch.launch import memstats
from repro_torch.launch import roofline as rf
from repro_torch.launch import steps as st
from repro_torch.launch.mesh import fake_world
from repro_torch.models.attention import kv_cache_len
from repro_torch.tree import tree_leaves, tree_map


def mesh_of(multi_pod: bool = False, mesh=None) -> tuple:
    """The world's axis sizes: ``mesh`` when given, else the reference's
    production mesh (``launch.mesh.make_production_mesh``): (16, 16), or
    (2, 16, 16) multipod."""
    if mesh is not None:
        return tuple(mesh)
    return (2, 16, 16) if multi_pod else (16, 16)


def mesh_name(shape: tuple) -> str:
    """'16x16', '2x16x16', '1x1'."""
    return "x".join(str(n) for n in shape)


def _shape(shape) -> InputShape:
    return INPUT_SHAPES[shape] if isinstance(shape, str) else shape


def lm_step(cfg, shape: InputShape, mesh, *, sharding="basic_ws",
            remat="basic", moe_group=4096, dispatch=None, param_dtype=None,
            batch_over="data"):
    """(step_fn, inputs) of rank ``mesh.rank``'s step of ``shape`` for the
    LM ``cfg``: ``steps.make_train_step`` (bf16, ``remat``),
    ``make_prefill_step`` or ``make_serve_step``, each on the rank's parts
    under ``sharding``, the inputs ``meta`` (``steps.shardings_for``)."""
    import torch
    margs = dict(st.DEFAULT_MOE_ARGS, group=moe_group)
    serve_margs = None
    if dispatch is not None:
        margs["dispatch"] = dispatch
        serve_margs = dict(margs, group=min(moe_group, shape.global_batch))
    params_abs = st.abstract_params(cfg)
    if param_dtype is not None:
        dt = {"bf16": torch.bfloat16, "f32": torch.float32}[param_dtype]
        params_abs = tree_map(
            lambda x: x.to(dt) if x.is_floating_point() else x, params_abs)
    if shape.kind == "train":
        opt = st.make_optimizer()
        (layout, _), inputs = st.shardings_for(
            cfg, shape, mesh, sharding, params_abs, opt.init(params_abs),
            batch_over=batch_over)
        fn, _ = st.make_train_step(
            cfg, remat=remat, moe_args=margs,
            mesh=mesh if mesh.distributed else None, layout=layout)
        return fn, inputs
    (layout, _), inputs = st.shardings_for(cfg, shape, mesh, sharding,
                                           params_abs, batch_over=batch_over)
    if shape.kind == "prefill":
        return st.make_prefill_step(cfg, moe_args=margs, mesh=mesh,
                                    layout=layout), inputs
    seq = st.cache_seq_axis(cfg, mesh, layout, shape.global_batch,
                            kv_cache_len(cfg, shape.seq_len))
    return st.make_serve_step(cfg, moe_args=serve_margs, mesh=mesh,
                              layout=layout, seq_axis=seq), inputs


def contrastive_step(dual_cfg, shape: InputShape, mesh, *,
                     sharding="basic_ws", remat="basic", num_micro=8,
                     batch_over="data", attn=None):
    """(step_fn, inputs) of rank ``mesh.rank``'s contrastive GradAccum
    step of ``shape``, as ``train_distributed`` builds it on that mesh by
    default (bf16, the 'chunked' cross-shard loss; the fused loss at one
    rank), the inputs ``meta``."""
    (layout, _), inputs = st.shardings_for(
        dual_cfg, shape, mesh, sharding, st.abstract_params(dual_cfg),
        st.make_optimizer().init(st.abstract_params(dual_cfg)),
        batch_over=batch_over)
    fn, _ = st.make_contrastive_step(
        dual_cfg, num_micro=num_micro, remat=remat, precision="bf16",
        attn=attn, mesh=mesh, loss="chunked", layout=layout)
    return fn, inputs


# the inputs whose bytes a row records, by the step's kind: (params,
# opt_state, batch), (params, batch) or (params, caches, token, pos)
_HELD = {"train": ("params", "opt_state"), "contrastive": ("params",
         "opt_state"), "prefill": ("params",), "decode": ("params", "caches")}


def _traced(fn, inputs, label, kind):
    """(row, seconds) of ``memstats.step_stats`` on the meta inputs of a
    step of ``kind``, with the bytes of the params and of the optimizer
    state or the decode caches (``_HELD``) in ``memory``."""
    t0 = time.time()
    row = memstats.step_stats(fn, inputs, label=label)
    secs = time.time() - t0
    for key, tree in zip(_HELD[kind], inputs):
        row["memory"][f"{key}_bytes_per_device"] = sum(
            t.numel() * t.element_size() for t in tree_leaves(tree))
    return row, secs


def run_one(arch, shape_name, *, multi_pod=False, sharding="basic_ws",
            remat="basic", verbose=True, unroll=None, attn="naive",
            moe_group=4096, dispatch=None, param_dtype=None,
            batch_over="data", ssm_chunk=None, mesh=None) -> dict:
    """Trace rank 0's step of (``arch``: a name or a config,
    ``shape_name``: a name of ``INPUT_SHAPES`` or an ``InputShape``) on
    the mesh (``mesh``: axis sizes, default the production mesh) and
    return the reference's result dict."""
    cfg = get_arch(arch) if isinstance(arch, str) else arch
    arch = cfg.name
    if not hasattr(cfg, "family"):      # dual-encoder (basic-{s,m,l})
        return run_contrastive_dryrun(
            cfg, shape_name, multi_pod=multi_pod, sharding=sharding,
            remat=remat, verbose=verbose, batch_over=batch_over, mesh=mesh,
            attn=None if attn == "naive" else attn)
    if attn != "naive":
        cfg = dataclasses.replace(cfg, attn_impl=attn)
    if ssm_chunk is not None and cfg.ssm is not None:
        cfg = dataclasses.replace(
            cfg, ssm=dataclasses.replace(cfg.ssm, chunk=ssm_chunk))
    shape = _shape(shape_name)
    axes = mesh_of(multi_pod, mesh)
    with fake_world(axes) as live:
        fn, inputs = lm_step(cfg, shape, live, sharding=sharding,
                             remat=remat, moe_group=moe_group,
                             dispatch=dispatch, param_dtype=param_dtype,
                             batch_over=batch_over)
        row, secs = _traced(fn, inputs, f"{arch} {shape.name}", shape.kind)
        del inputs
    terms = rf.roofline_terms({"flops": row["flops_per_device"],
                               "bytes accessed":
                               row["bytes_accessed_per_device"]},
                              row["collectives"])
    mflops = rf.model_flops(cfg, shape, cfg.param_counts()["active"])
    chips = math.prod(axes)
    hlo_flops_global = terms["flops_per_device"] * chips
    result = {
        "arch": arch, "shape": shape.name, "mesh": mesh_name(axes),
        "chips": chips, "sharding": sharding, "remat": remat,
        "attn": attn, "moe_group": moe_group, "dispatch": dispatch,
        "param_dtype": param_dtype, "batch_over": batch_over,
        "ssm_chunk": ssm_chunk, "unroll": unroll, "ok": True,
        "lower_s": round(secs, 2), "compile_s": 0.0,
        "memory": row["memory"],
        "collectives": row["collectives"],
        "roofline": terms,
        "model_flops_global": mflops,
        "hlo_flops_global": hlo_flops_global,
        "useful_flops_ratio": (mflops / hlo_flops_global
                               if hlo_flops_global else None),
    }
    if verbose:
        print(f"[{arch} × {shape.name} × {result['mesh']} × {sharding}] "
              f"trace={secs:.1f}s "
              f"compute={terms['compute_s']*1e3:.2f}ms "
              f"mem={terms['memory_s']*1e3:.2f}ms "
              f"coll={terms['collective_s']*1e3:.2f}ms "
              f"bottleneck={terms['bottleneck']} "
              f"useful={result['useful_flops_ratio'] and round(result['useful_flops_ratio'], 3)}")
        print("  memory:", result["memory"])
    return result


def run_contrastive_dryrun(dual_cfg, shape_name, *, multi_pod=False,
                           sharding="basic_ws", remat="basic", verbose=True,
                           num_micro=8, batch_over="data", mesh=None,
                           attn=None) -> dict:
    """Trace rank 0's step of the paper's own objective: BASIC's
    contrastive GradAccum (``num_micro`` microbatches) at ``shape_name``
    (a name, e.g. 'contrastive_64k': B = 65536 in 8 of 8192, or an
    ``InputShape``) on the mesh (``mesh``: axis sizes, default the
    production mesh), in bf16 with the cross-shard loss the distributed
    trainer runs by default ('chunked'; the fused loss at one rank), and
    ``attn`` the towers' backend override.
    ``dual_cfg`` is a dual-encoder config or its name. The result holds,
    beside the reference's keys, the rank's params and optimizer-state
    bytes under ``memory``."""
    if isinstance(dual_cfg, str):
        dual_cfg = get_arch(dual_cfg)
    shape = _shape(shape_name)
    if shape.kind != "contrastive":
        raise ValueError(f"{shape.name} is a {shape.kind} shape, not a "
                         f"contrastive one")
    axes = mesh_of(multi_pod, mesh)
    with fake_world(axes) as live:
        fn, inputs = contrastive_step(
            dual_cfg, shape, live, sharding=sharding, remat=remat,
            num_micro=num_micro, batch_over=batch_over, attn=attn)
        row, secs = _traced(fn, inputs, f"{dual_cfg.name} {shape.name}",
                            shape.kind)
        del inputs
    terms = rf.roofline_terms({"flops": row["flops_per_device"],
                               "bytes accessed":
                               row["bytes_accessed_per_device"]},
                              row["collectives"])
    result = {
        "arch": dual_cfg.name, "shape": shape.name, "mesh": mesh_name(axes),
        "chips": math.prod(axes), "sharding": sharding, "remat": remat,
        "num_micro": num_micro, "attn": attn, "ok": True,
        "extrapolated": False,
        "lower_s": round(secs, 2), "compile_s": 0.0,
        "memory": row["memory"], "collectives": row["collectives"],
        "roofline": terms,
    }
    if verbose:
        print(f"[{dual_cfg.name} x {shape.name} x {result['mesh']} x "
              f"{sharding} micro={num_micro}] trace={secs:.1f}s "
              f"peak={result['memory']['peak_gb_per_device']}GB "
              f"coll={terms['collective_s']*1e3:.1f}ms "
              f"bottleneck={terms['bottleneck']}")
    return result


def main(argv=None):
    """Parse, trace every combo not cached under ``--out``, write one JSON
    each; exits 1 when a combo failed."""
    ap = argparse.ArgumentParser(
        description="trace (arch × input-shape × mesh) combos on meta "
                    "tensors for rank 0 of a fake world of 256 or 512 "
                    "ranks; writes one JSON per combo")
    ap.add_argument("--arch", help="arch name from repro_torch.configs "
                                   "(required unless --all)")
    ap.add_argument("--shape", help="input-shape name from "
                                    "configs.INPUT_SHAPES "
                                    "(required unless --all)")
    ap.add_argument("--mesh", choices=["pod", "multipod", "both"],
                    default="pod",
                    help="16x16 pod, 2x16x16 multipod, or both")
    ap.add_argument("--sharding", default="basic_ws",
                    choices=["basic_ws", "tp", "replicated"],
                    help="weight-sharding rule (core.sharding)")
    ap.add_argument("--remat", default="basic",
                    help="checkpoint policy (core.remat registry)")
    ap.add_argument("--all", action="store_true",
                    help="run every applicable (arch × shape)")
    ap.add_argument("--out", default="experiments/dryrun",
                    help="output dir; existing result files are skipped")
    ap.add_argument("--attn", default="naive",
                    choices=["naive", "chunked", "pallas", "auto"],
                    help="attention backend override (models.attention "
                         "registry; 'pallas' traces the flash kernels' "
                         "wrappers, which record the kernels' work)")
    ap.add_argument("--dispatch", default=None,
                    choices=[None, "dense", "capacity"],
                    help="MoE dispatch override")
    ap.add_argument("--param-dtype", default=None,
                    choices=[None, "bf16", "f32"],
                    help="cast floating params before the trace")
    ap.add_argument("--batch-over", default="data", choices=["data", "all"],
                    help="input batch over the data axes only, or over ALL "
                         "ranks incl. model (paper §5.1)")
    ap.add_argument("--ssm-chunk", type=int, default=None,
                    help="SSM scan chunk override")
    ap.add_argument("--moe-group", type=int, default=4096,
                    help="MoE dispatch group size")
    ap.add_argument("--unroll", type=int, default=None,
                    help="accepted and recorded: the port traces every "
                         "layer, so nothing is extrapolated")
    args = ap.parse_args(argv)

    combos = []
    if args.all:
        for a in list_archs():
            cfg = get_arch(a)
            if not hasattr(cfg, "family"):  # dual-encoder configs: skip here
                continue
            for s in applicable_shapes(cfg):
                combos.append((a, s.name))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape are required unless --all")
        combos.append((args.arch, args.shape))

    meshes = {"pod": [False], "multipod": [True], "both": [False, True]}[
        args.mesh]
    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch, shape in combos:
        for mp in meshes:
            tag = (f"{arch}_{shape}_{'2x16x16' if mp else '16x16'}_"
                   f"{args.sharding}_{args.remat}"
                   + ("" if args.attn == "naive" else f"_{args.attn}")
                   + ("" if args.moe_group == 4096 else f"_g{args.moe_group}")
                   + ("" if args.dispatch is None else f"_{args.dispatch}")
                   + ("" if args.param_dtype is None
                      else f"_p{args.param_dtype}")
                   + ("" if args.batch_over == "data" else "_ball")
                   + ("" if args.ssm_chunk is None
                      else f"_sc{args.ssm_chunk}"))
            path = os.path.join(args.out, tag.replace("/", "-") + ".json")
            if os.path.exists(path):
                print(f"[skip cached] {tag}")
                continue
            try:
                res = run_one(arch, shape, multi_pod=mp,
                              sharding=args.sharding, remat=args.remat,
                              unroll=args.unroll, attn=args.attn,
                              moe_group=args.moe_group,
                              dispatch=args.dispatch,
                              param_dtype=args.param_dtype,
                              batch_over=args.batch_over,
                              ssm_chunk=args.ssm_chunk)
            except Exception as e:  # noqa: BLE001 — one combo's failure is its record
                failures += 1
                res = {"arch": arch, "shape": shape,
                       "mesh": "2x16x16" if mp else "16x16",
                       "sharding": args.sharding, "remat": args.remat,
                       "ok": False, "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-3000:]}
                print(f"[FAIL] {tag}: {type(e).__name__}: {e}")
            with open(path, "w") as f:
                json.dump(res, f, indent=1)
    print(f"done; {failures} failures")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
