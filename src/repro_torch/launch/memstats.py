"""Per-step memory and FLOP accounting of the port (counterpart of
``repro/launch/memstats.py``).

The paper's two scaling limits, accelerator memory and the global
contrastive batch, meet in one table: for each remat policy (and loss)
this module runs one step of the contrastive training step of one rank
and reports its memory (argument, output and temporary bytes, the peak)
beside its FLOPs, the bytes its operations read and write, its collective
traffic and the shared memory of the loss kernels' tiles.

The port has no ahead-of-time compile, so a row is measured on the device
the step runs on:

- on the card, the peak is ``torch.cuda.max_memory_allocated`` over the
  step, after ``reset_peak_memory_stats``;
- on ``meta`` tensors (a dry run: nothing is allocated, nothing launched)
  and on the CPU, the peak is the most bytes of live storages while the
  step runs (a dispatch mode that follows every storage an operation
  returns until it is freed; sizes rounded up to the card allocator's 512
  bytes), the step's inputs included;
- FLOPs are ``torch.utils.flop_counter.FlopCounterMode``'s count of the
  step's products plus the hand-written kernels' work, which their
  wrappers record by ``launch.roofline``'s formulas (on ``meta`` and at
  every CUDA launch while a count is open), so that a traced step and a
  run one count alike;
- bytes accessed are the reads and writes of every dispatched operation
  but views and allocations, as XLA's ``bytes accessed`` counts its
  operations', plus the kernels' recorded bytes;
- collectives are the bytes this rank hands to ``launch.mesh``'s
  collectives (``roofline.CollectiveBytes``).

CLI (``--devices N`` traces one rank of an N-rank world on ``meta``, on a
``fake`` process group; without it the report runs on the card)::

  PYTHONPATH=src python -m repro_torch.launch.memstats --arch basic-s \\
      --smoke --devices 8 --model-parallel 2 --batch 64 --num-micro 2 \\
      --remat basic,none,full,dots --loss chunked

Library: ``step_stats(step_fn, example_inputs)`` for one report row of any
step (also printed by ``train_distributed --memstats`` for its first step,
and taken by the dry run of every training, prefill and decode step on a
rank's parts, counted alike: the parts and caches are the arguments, the
gathers or all-reduces the collectives);
``measured_step`` gives the step's outputs beside the row;
``contrastive_report(...)`` for the policy sweep; ``format_rows`` to
render. All rows are plain dicts, JSON-ready (``--json PATH``).
"""
from __future__ import annotations

import argparse
import json
import sys
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.kernels.build import WorkCount, is_abstract
from repro_torch.launch import roofline as rf

# the card's caching allocator hands out blocks in multiples of 512 bytes
ALLOC_ROUND = 512
# allocations write nothing and views move nothing
_NO_ACCESS = {"empty", "empty_like", "empty_strided", "new_empty",
              "new_empty_strided"}


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _rounded(nbytes: int) -> int:
    return -(-nbytes // ALLOC_ROUND) * ALLOC_ROUND


def _storages(tensors) -> dict:
    """{storage key: bytes} of the distinct storages under ``tensors``."""
    out = {}
    for t in tensors:
        st = t.untyped_storage()
        out[st._cdata] = st.nbytes()
    return out


def _access_bytes(tree) -> int:
    seen, n = set(), 0
    for t in _tensors(tree):
        if id(t) not in seen:
            seen.add(id(t))
            n += t.numel() * t.element_size()
    return n


class _StepTrace(TorchDispatchMode):
    """Bytes read and written by every dispatched operation (``accessed``)
    and, with ``track_memory``, the bytes of live storages (``live``, each
    rounded up to ``ALLOC_ROUND``) and their ``peak``: a storage counts
    from the operation that returns it (or ``hold``) until it is freed."""

    def __init__(self, track_memory: bool):
        super().__init__()
        self.track_memory = track_memory
        self.accessed = 0
        self.live = self.peak = 0
        self._held = {}

    def hold(self, t: torch.Tensor) -> None:
        """Count ``t``'s storage as live until it is freed."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._held:
            return
        n = _rounded(st.nbytes())
        self.live += n
        self.peak = max(self.peak, self.live)

        def freed(_, key=key, n=n):
            self.live -= n
            self._held.pop(key, None)
        self._held[key] = weakref.ref(st, freed)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not func.is_view and \
                func.overloadpacket.__name__ not in _NO_ACCESS:
            self.accessed += _access_bytes((args, kwargs)) \
                + _access_bytes(out)
        if self.track_memory:
            for t in _tensors(out):
                self.hold(t)
        return out


def measured_step(step_fn, example_inputs, *, label: str = ""):
    """Run ``step_fn(*example_inputs)`` once and account for it. The
    inputs' device picks the measure: the card's allocator on CUDA, the
    traced live bytes on ``meta`` (a dry run) and on the CPU. Returns
    (the step's outputs, the row: ``label``, ``device``, ``memory``
    (``argument_bytes_per_device``, ``output_bytes_per_device``,
    ``temp_bytes_per_device`` (the peak over the bytes held when the step
    began), ``alias_bytes_per_device`` (outputs in the inputs' storages),
    ``peak_gb_per_device`` and ``peak_bytes_per_device``),
    ``flops_per_device``, ``bytes_accessed_per_device`` and
    ``collectives`` (``roofline.collective_bytes``), with the kernels'
    recorded work under ``kernel_work``)."""
    from torch.utils.flop_counter import FlopCounterMode
    ins = _tensors(example_inputs)
    if not ins:
        raise ValueError("the step's inputs hold no tensor")
    device = ins[0].device
    on_card = device.type == "cuda" and not is_abstract(ins[0])
    args = _storages(ins)
    trace = _StepTrace(track_memory=not on_card)
    if on_card:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        before = torch.cuda.memory_allocated(device)
    else:
        for t in ins:
            trace.hold(t)
        before = trace.live
    flops = FlopCounterMode(display=False)
    with rf.CollectiveBytes() as moved, WorkCount() as work, flops, trace:
        out = step_fn(*example_inputs)
    if on_card:
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
    else:
        peak = trace.peak
    outs = _storages(_tensors(out))
    row = {
        "label": label, "device": str(device),
        "memory": {
            "argument_bytes_per_device": sum(args.values()),
            "output_bytes_per_device": sum(outs.values()),
            "temp_bytes_per_device": peak - before,
            "alias_bytes_per_device": sum(n for k, n in outs.items()
                                          if k in args),
            "peak_gb_per_device": round(peak / 2**30, 4),
            "peak_bytes_per_device": peak,
        },
        "flops_per_device": float(flops.get_total_flops())
        + work.total_flops,
        "bytes_accessed_per_device": float(trace.accessed)
        + work.total_bytes,
        "collectives": rf.collective_bytes(moved),
        "kernel_work": {"flops": dict(work.flops), "bytes": dict(work.bytes),
                        "calls": dict(work.calls)},
    }
    return out, row


def step_stats(step_fn, example_inputs, *, label: str = "") -> dict:
    """``measured_step``'s row for one run of ``step_fn(*example_inputs)``
    (its outputs dropped)."""
    return measured_step(step_fn, example_inputs, label=label)[1]


def compiled_stats(row: dict, *, label: str = "") -> dict:
    """The reference builds a row from an AOT-compiled executable; the
    port has no ahead-of-time compile, so its step has run already and
    ``row`` is ``measured_step``'s (or ``step_stats``') row of that run,
    relabelled with ``label`` where one is given."""
    return dict(row, label=label) if label else dict(row)


def loss_kernel_smem(b_local: int, d: int, itemsize: int = 4) -> dict:
    """The fused contrastive-loss kernels at per-rank batch ``b_local`` and
    embed dim ``d``: the forward's tile edge and tiles a side
    (``contrastive_loss.ops.lse_plan``) and one tile CTA's shared memory,
    the backward CTA's shared memory and scratch (``bwd_plan``), and
    whether its one-launch backward takes D (``MAX_D``; the Hopper
    backward has no legacy fallback: past it the kernel refuses)."""
    from repro_torch.kernels.contrastive_loss import ops
    dtype = torch.float32 if itemsize == 4 else torch.bfloat16
    plan = ops.lse_plan(b_local, dtype)
    return {
        "tile": plan.tile, "tiles": plan.tiles,
        "lse_smem_bytes": ops.lse_smem_bytes(plan.tile, itemsize),
        "bwd_smem_bytes": ops.bwd_smem_bytes(d, itemsize),
        "bwd_scratch_bytes": 4 * ops.bwd_plan(b_local, d).scratch_floats,
        "bwd_one_launch": d <= ops.MAX_D,
    }


def contrastive_inputs(cfg, mesh, sharding: str, opt, batch: int, seq: int,
                       device):
    """One rank's (params, optimizer state, batch) of the contrastive step
    on ``mesh`` under ``sharding``. On ``meta`` the abstract trees cut to
    this rank's parts (``steps.shardings_for``); on a device, params
    drawn from seed 0 and cut as the trainer cuts them
    (``train_distributed.build_state``) and a random batch of the same
    shapes. The batch lies over the data axes, as the reference's report
    lays it: the M ranks of a data shard hold its rows alike."""
    from repro_torch.configs.base import InputShape
    from repro_torch.launch import steps as st
    from repro_torch.launch import train_distributed as td
    shape = InputShape("report", seq, batch, "contrastive")
    params_abs = st.abstract_params(cfg)
    _, (params, opt_state, spec) = st.shardings_for(
        cfg, shape, mesh, sharding, params_abs, opt.init(params_abs))
    if torch.device(device).type == "meta":
        return params, opt_state, spec
    params, opt_state = td.build_state(cfg, opt, 0, device, mesh, sharding)
    g = torch.Generator(device=device).manual_seed(0)
    image, tokens = spec["images"]["image"], spec["texts"]["tokens"]
    return params, opt_state, {
        "images": {"image": torch.rand(image.shape, generator=g,
                                       device=device)},
        "texts": {"tokens": torch.randint(
            4, cfg.text_tower.vocab, tokens.shape, generator=g,
            device=device, dtype=torch.int32)}}


def contrastive_report(arch: str, *, smoke: bool, mesh, sharding: str,
                       batch: int, num_micro: int, seq: int, remats,
                       loss: str = "chunked", precision: str = "bf16",
                       attn=None, device="cuda") -> list:
    """One accounting row per remat policy for the contrastive training
    step (GradAccum × the ranks of ``mesh`` × weight sharding × the
    global-batch loss), run once on ``device`` for this rank: ``meta``
    traces it on abstract inputs (``mesh`` a ``launch.mesh.fake_world``),
    ``cuda`` runs it on the card. ``remats``: ``core.remat`` policy
    names; ``precision`` / ``attn`` select the precision policy and the
    attention backend (``'pallas'``: the flash kernels)."""
    from repro_torch.configs import get_arch, smoke_dual_variant
    from repro_torch.launch import steps as st
    from repro_torch.launch import train_distributed as td
    cfg = get_arch(arch)
    if smoke:
        cfg = smoke_dual_variant(cfg)
    layout = td.param_layout(cfg, mesh, sharding)
    rows = []
    for remat in remats:
        step, opt = st.make_contrastive_step(
            cfg, num_micro=num_micro, remat=remat, mesh=mesh,
            precision=precision, attn=attn, loss=loss, layout=layout)
        inputs = contrastive_inputs(cfg, mesh, sharding, opt, batch, seq,
                                    device)
        row = step_stats(step, inputs,
                         label=f"{arch} B={batch} micro={num_micro} "
                               f"loss={loss} remat={remat}")
        del inputs
        row["remat"] = remat
        # chunked streams (B_local, B_local) chunks; allgather / local /
        # fused run the kernel on the whole gathered batch on every rank.
        # The embeddings are fp32 whatever the towers' dtype.
        kernel_b = (max(8, batch // mesh.data_size) if loss == "chunked"
                    else batch)
        row["loss_kernel_smem"] = loss_kernel_smem(kernel_b, cfg.embed_dim)
        rows.append(row)
    return rows


def format_rows(rows) -> str:
    """Render accounting rows as an aligned text table."""
    head = (f"{'label':<56} {'peak GB/dev':>11} {'temp MB':>9} "
            f"{'args MB':>9} {'GFLOPs/dev':>11} {'coll MB':>9}")
    lines = [head, "-" * len(head)]
    for r in rows:
        m = r["memory"]
        coll = r.get("collectives", {}).get("total", 0) / 2**20
        lines.append(
            f"{r['label']:<56} {m['peak_gb_per_device']:>11.4f} "
            f"{m['temp_bytes_per_device']/2**20:>9.1f} "
            f"{m['argument_bytes_per_device']/2**20:>9.1f} "
            f"{r['flops_per_device']/1e9:>11.3f} {coll:>9.1f}")
        ks = r.get("loss_kernel_smem")
        if ks:
            lines.append(
                f"    loss kernel smem: tile={ks['tile']} "
                f"(x{ks['tiles']}) fwd={ks['lse_smem_bytes']/2**10:.0f}KiB "
                f"bwd={ks['bwd_smem_bytes']/2**10:.0f}KiB "
                f"scratch={ks['bwd_scratch_bytes']/2**10:.0f}KiB "
                f"one-launch-bwd={'yes' if ks['bwd_one_launch'] else 'no (D too wide)'}")
    return "\n".join(lines)


def main(argv=None) -> int:
    """Parse, report, print (and ``--json``); returns the exit code."""
    ap = argparse.ArgumentParser(
        description="per-step memory/FLOPs accounting for the contrastive "
                    "global-batch train step")
    ap.add_argument("--arch", default="basic-s")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--devices", type=int, default=None,
                    help="trace rank 0 of an N-rank world on meta tensors "
                         "(a fake process group; nothing allocated); "
                         "without it the step runs on the card")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--sharding", default="basic_ws",
                    choices=["basic_ws", "tp", "replicated"])
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--num-micro", type=int, default=2)
    ap.add_argument("--seq", type=int, default=16)
    ap.add_argument("--loss", default="chunked",
                    choices=["local", "fused", "allgather", "chunked"])
    ap.add_argument("--precision", default="bf16",
                    choices=["f32", "bf16", "bf16_pure"],
                    help="models.precision policy of the step")
    ap.add_argument("--attn", default=None,
                    choices=[None, "naive", "chunked", "pallas", "auto"],
                    help="attention backend override for both towers")
    ap.add_argument("--remat", default="basic,none,full,dots",
                    help="comma-separated core.remat policy names")
    ap.add_argument("--json", default=None, help="also write rows to PATH")
    args = ap.parse_args(argv)

    from repro_torch.launch.mesh import fake_world, make_local_mesh
    remats = [r.strip() for r in args.remat.split(",") if r.strip()]
    kw = dict(smoke=args.smoke, sharding=args.sharding, batch=args.batch,
              num_micro=args.num_micro, seq=args.seq, remats=remats,
              loss=args.loss, precision=args.precision, attn=args.attn)
    if args.devices:
        if args.devices % args.model_parallel:
            raise SystemExit(f"--devices {args.devices} does not divide "
                             f"into model groups of {args.model_parallel}")
        with fake_world((args.devices // args.model_parallel,
                         args.model_parallel)) as mesh:
            rows = contrastive_report(args.arch, mesh=mesh, device="meta",
                                      **kw)
    else:
        from repro_torch.device import resolve_device
        device = resolve_device("cuda")
        rows = contrastive_report(
            args.arch, mesh=make_local_mesh(model=args.model_parallel),
            device=device, **kw)
    print(format_rows(rows))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
        print(f"wrote {args.json}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
