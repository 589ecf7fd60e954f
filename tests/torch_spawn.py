"""Workers of the port's multi-rank CPU tests.

The tests start their gloo worlds with ``repro_torch.launch.spawn.run_world``
(spawned processes, a ``file://`` rendezvous under the test's tmp dir).
The functions the ranks run live here, in a module that imports ``torch``
and ``repro_torch`` only, never in a test module that imports JAX.
"""
from __future__ import annotations

import contextlib


def worker_losses(rank, world, cases, device="cpu"):
    """The cross-shard losses on this rank's rows of each case's global
    embeddings on ``device``: ``cases`` maps a name to (method, dtype name,
    x, y, log_tau), x and y float32 numpy (B, D) cast to the dtype.
    Returns {name: (loss, dx block, dy block, dlog_tau partial)} as float32
    numpy, and under "launches" {name: this rank's contrastive kernel
    launches in that case's loss and backward} (0 on the CPU, where the
    plain versions run)."""
    import torch

    from repro_torch.core import distributed_loss as dl
    from repro_torch.kernels.contrastive_loss import ops
    from repro_torch.launch.mesh import make_local_mesh
    mesh = make_local_mesh()
    counters = (ops.FWD_COUNTER, ops.BWD_COUNTER)
    out, launches = {}, {}
    for name, (method, dtype, x, y, log_tau) in cases.items():
        dt = getattr(torch, dtype)
        b = x.shape[0] // world
        rows = slice(rank * b, (rank + 1) * b)
        xl = torch.from_numpy(x[rows]).to(device, dt).requires_grad_()
        yl = torch.from_numpy(y[rows]).to(device, dt).requires_grad_()
        lt = torch.tensor(log_tau, dtype=torch.float32, device=device,
                          requires_grad=True)
        loss_fn = dl.make_global_loss_fn(mesh, method)
        for c in counters:
            c.reset()
        loss, _ = loss_fn(xl, yl, torch.exp(lt))
        dx, dy, dtau = torch.autograd.grad(loss, (xl, yl, lt))
        launches[name] = {c.name: c.count for c in counters}
        out[name] = tuple(t.detach().float().cpu().numpy()
                          for t in (loss, dx, dy, dtau))
    out["launches"] = launches
    return out


def worker_train(rank, world, argvs):
    """``repro_torch.launch.train_distributed.main(argv)`` for each argv in
    turn on this rank (in the world's gloo group); returns each run's
    per-step losses."""
    from repro_torch.launch import train_distributed as td
    return [td.main(argv) for argv in argvs]


def worker_train_printed(rank, world, argvs):
    """``worker_train`` with what each run printed on this rank: a list of
    (per-step losses, stdout text)."""
    import io

    from repro_torch.launch import train_distributed as td
    out = []
    for argv in argvs:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            losses = td.main(argv)
        out.append((losses, buf.getvalue()))
    return out


def worker_collectives(rank, world, model, sizes):
    """``roofline.CollectiveBytes`` over one all-gather, one all-reduce and
    one reduce-scatter of float32 tensors of ``sizes`` elements (each) on
    every axis of the (world / model, model) mesh, and the bytes the
    calls were handed, counted here from the tensors' sizes: (the count's
    bytes and calls, the bytes handed by operation)."""
    import torch

    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.roofline import CollectiveBytes
    mesh = make_local_mesh(model=model)
    handed = {"all_gather": 0, "all_reduce": 0, "reduce_scatter": 0}
    with CollectiveBytes() as count:
        for axis in (mesh.batch, mesh.data, mesh.model):
            for n in sizes:
                t = torch.full((n,), float(rank))
                axis.all_gather(t)
                axis.all_reduce(t)
                blocks = torch.zeros((axis.size, n))
                axis.reduce_scatter(blocks)
                if axis.distributed:
                    handed["all_gather"] += 4 * n
                    handed["all_reduce"] += 4 * n
                    handed["reduce_scatter"] += 4 * n * axis.size
    return dict(count.bytes), dict(count.calls), handed


def worker_parts_bytes(rank, world, model, arch, sharding, serving=False):
    """The bytes of this rank's params and optimizer state as the trainer
    places them (``train_distributed.build_state``) on the (world /
    model, model) mesh, for the smoke variant of ``arch`` (a dual encoder
    or an LM); with ``serving`` the bytes of the params alone, drawn
    whole and cut by ``steps.serving_layout``, as a serving step takes
    them."""
    import torch

    from repro_torch import interop
    from repro_torch.configs import (get_arch, smoke_dual_variant,
                                     smoke_variant)
    from repro_torch.core import weight_sharding as ws
    from repro_torch.launch import steps as st
    from repro_torch.launch import train_distributed as td
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.tree import tree_leaves
    cfg = get_arch(arch)
    cfg = (smoke_dual_variant(cfg) if hasattr(cfg, "image_tower")
           else smoke_variant(cfg))
    mesh = make_local_mesh(model=model)
    if serving:
        trees = [ws.cut(interop.init_params(
            cfg, torch.Generator().manual_seed(0), "cpu"),
            st.serving_layout(cfg, mesh, sharding))]
    else:
        trees = td.build_state(cfg, st.make_optimizer(), 0, "cpu", mesh,
                               sharding)
    return [sum(x.numel() * x.element_size() for x in tree_leaves(t))
            for t in trees]


def worker_mesh(rank, world, model):
    """This rank's place on the (world / model, model) mesh and the
    results of each axis's collectives (batch, data, model) on small
    tensors that name the rank."""
    import torch

    from repro_torch.launch.mesh import all_reduce_tree, make_local_mesh
    from repro_torch.tree import tree_leaves
    mesh = make_local_mesh(model=model)
    t = torch.tensor([float(rank)])
    out = {"index": (mesh.data_index, mesh.model_index, mesh.rank),
           "sizes": (mesh.data_size, mesh.model_size, mesh.ranks)}
    for name, axis in (("batch", mesh.batch), ("data", mesh.data),
                       ("model", mesh.model)):
        blocks = torch.arange(axis.size, dtype=torch.float32)[:, None]
        out[name] = {"gather": axis.all_gather(t).flatten().tolist(),
                     "sum": axis.all_reduce(t).item(),
                     "max": axis.all_reduce(t, "max").item(),
                     "scatter": axis.reduce_scatter(
                         blocks * (rank + 1)).tolist()}
    # a tree summed in buckets of at most 12 bytes: one leaf a bucket
    tree = {"a": torch.full((3,), float(rank)), "b": [t.double(), t + 1]}
    out["tree"] = {k: [x.tolist() for x in tree_leaves(v)] for k, v in
                   all_reduce_tree(tree, mesh, bucket_bytes=12).items()}
    return out


def worker_gather(rank, world, model, cases):
    """For each (whole, dim, upstream) of ``cases``:
    ``weight_sharding.gather`` of this rank's part of ``whole`` (split over
    the model axis along ``dim``) and the part's gradient when the
    gathered leaf is multiplied by ``upstream[rank]`` and summed. Returns
    [(gathered leaf, gradient of the part)] as numpy."""
    import torch

    from repro_torch.core import weight_sharding as ws
    from repro_torch.launch.mesh import make_local_mesh
    mesh = make_local_mesh(model=model)
    out = []
    for whole, dim, upstream in cases:
        layout = ws.Layout({"w": dim}, mesh.model)
        part = ws.cut({"w": torch.from_numpy(whole)}, layout)["w"]
        part.requires_grad_()
        full = ws.gather({"w": part}, layout)["w"]
        (g,) = torch.autograd.grad(
            torch.sum(full * torch.from_numpy(upstream[rank])), part)
        out.append((full.detach().numpy(), g.numpy()))
    return out


def worker_adafactor(rank, world, model, params, grads, stream, dims,
                     lr):
    """AdaFactorW on this rank's parts: ``params`` (numpy leaves, whole)
    cut by ``dims`` over the model axis, one ``update`` per whole gradient
    of ``grads``, then one ``update_from_microbatches`` on ``stream``
    (leaves (K, ...), cut along each leaf's dim + 1). Returns the parts
    of the params and of every slot (the first moment widened to
    float32), as numpy, after the updates and after the stream step."""
    import torch

    from repro_torch.core import weight_sharding as ws
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.optim.adafactorw import AdaFactorW, apply_updates
    from repro_torch.tree import tree_map
    mesh = make_local_mesh(model=model)
    opt = AdaFactorW(weight_decay=0.0025)
    layout = ws.Layout(dims, mesh.model)
    whole = tree_map(torch.from_numpy, params)
    slayout = ws.Layout(opt.split_dims(whole, layout), mesh.model)
    p, state = ws.cut(whole, layout), ws.cut(opt.init(whole), slayout)

    def numpy(p, state):
        out = {"params": p, "m": state.m, "v_row": state.v_row,
               "v_col": state.v_col}
        return tree_map(lambda t: t.float().numpy(), out)
    for g in grads:
        g = ws.cut(tree_map(torch.from_numpy, g), layout)
        updates, state = opt.update(g, state, p, lr, layout)
        p = apply_updates(p, updates)
    after = numpy(p, state)
    cstream = ws.cut(tree_map(torch.from_numpy, stream), ws.Layout(
        tree_map(lambda d: None if d is None else d + 1, dims), mesh.model))
    updates, state = opt.update_from_microbatches(cstream, state, p, lr,
                                                  layout=layout)
    return after, numpy(apply_updates(p, updates), state)


def worker_grid(rank, world, model, gather_cases):
    """One world's checks of the (world / model, model) grid:
    ``worker_mesh``, ``worker_gather`` on ``gather_cases`` and
    ``worker_resident`` under 'basic_ws' and 'replicated'."""
    return {"mesh": worker_mesh(rank, world, model),
            "gather": worker_gather(rank, world, model, gather_cases),
            "resident": {s: worker_resident(rank, world, model, s)
                         for s in ("basic_ws", "replicated")}}


def worker_resident(rank, world, model, sharding):
    """The trainer's state on this rank for BASIC-S smoke at (world /
    model, model) under ``sharding``: the params' and the optimizer
    state's resident bytes, and the shapes of the parts, of the first
    moment and of one GradAccum step's gradients (through the towers'
    gather on use), each by leaf path."""
    import torch

    from repro_torch.configs import get_arch, smoke_dual_variant
    from repro_torch.core import weight_sharding as ws
    from repro_torch.core.distributed_loss import make_global_loss_fn
    from repro_torch.core.gradaccum import contrastive_step
    from repro_torch.data.sharded import HostLayout, device_put_global
    from repro_torch.launch import steps as st
    from repro_torch.launch import train_distributed as td
    from repro_torch.models import dual_encoder as de
    from repro_torch.tree import leaves
    args = td.parse_args(["--arch", "basic-s", "--smoke", "--device", "cpu",
                          "--model-parallel", str(model), "--sharding",
                          sharding, "--batch", "16", "--seq", "16"])
    device, mesh = td.setup(args)
    cfg = smoke_dual_variant(get_arch("basic-s"))
    opt = st.make_optimizer()
    layout = td.param_layout(cfg, mesh, sharding)
    params, state = td.build_state(cfg, opt, 0, device, mesh, sharding)

    def nbytes(tree):
        return sum(x.numel() * x.element_size() for _, x in leaves(tree))
    loader = td.make_loader(args, cfg, HostLayout(mesh.data_size,
                                                  mesh.data_index))
    # under tp the model ranks of a data shard share its whole block
    part = (0, 1) if sharding == "tp" else (mesh.model_index,
                                            mesh.model_size)
    batch = device_put_global(loader.local_batch_at(0), device, part)
    _, _, grads = contrastive_step(
        lambda p, x: de.encode_image(cfg, p, x, layout=layout),
        lambda p, x: de.encode_text(cfg, p, x, layout=layout),
        params, batch, 2, loss_fn=make_global_loss_fn(
            st.batch_group(mesh, layout), "chunked"))

    def shapes(tree):
        return {k: tuple(x.shape) for k, x in leaves(tree)}
    return {"params_bytes": nbytes(params), "state_bytes": nbytes(state),
            "params": shapes(params), "m": shapes(state.m),
            "grads": shapes(grads),
            "split": None if layout is None else
            [k for (k, _), d in zip(leaves(params), layout.flat_dims)
             if d is not None]}


def worker_checkpoint(rank, world, model, save_dir, restore_dir,
                      sharding="basic_ws", restore_sharding=None):
    """The trainer's seeded BASIC-S smoke state at (world / model, model)
    under ``sharding``: saved whole into ``save_dir`` at step 1 by rank 0,
    the model group's ranks gathering each split leaf (``io.save`` with
    ``weight_sharding.gather_leaf``), then the checkpoint at step 1 of
    ``restore_dir`` restored into this rank's parts under
    ``restore_sharding`` (default ``sharding``; ``_restore``). Returns the
    restored parts as numpy, by leaf path (bf16 as its bits)."""
    import types

    import torch

    from repro_torch import checkpoint as ckpt
    from repro_torch.configs import get_arch, smoke_dual_variant
    from repro_torch.core import weight_sharding as ws
    from repro_torch.launch import steps as st
    from repro_torch.launch import train_distributed as td
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.tree import leaves, tree_leaves
    mesh = make_local_mesh(model=model)
    cfg = smoke_dual_variant(get_arch("basic-s"))
    opt = st.make_optimizer()
    layout = td.param_layout(cfg, mesh, sharding)
    params, state = td.build_state(cfg, opt, 0, "cpu", mesh, sharding)
    slayout = td.state_layout(opt, params, layout)
    dims = td._dims(layout, slayout)
    tree = (params, state)
    if rank == 0:
        ckpt.save(save_dir, 1, tree, whole=lambda i, x: ws.gather_leaf(
            x, dims[i], mesh.model))
    elif mesh.data_index == 0:
        for i, x in enumerate(tree_leaves(tree)):
            ws.gather_leaf(x, dims[i], mesh.model)
    mesh.barrier()
    if restore_sharding not in (None, sharding):
        layout = td.param_layout(cfg, mesh, restore_sharding)
        params, state = td.build_state(cfg, opt, 0, "cpu", mesh,
                                       restore_sharding)
        slayout = td.state_layout(opt, params, layout)
    params, state, start = td._restore(
        types.SimpleNamespace(ckpt_dir=restore_dir, resume="latest"),
        params, state, mesh, "cpu", layout, slayout)

    def host(x):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x).numpy()
    return start, {k: host(x) for k, x in leaves((params, state))}


def worker_refusals(rank, world, argvs):
    """``repro_torch.launch.train_distributed.main(argv)`` for each argv,
    each expected to refuse its setup: the exception's type name and
    message of each (None where a run did not raise)."""
    from repro_torch.launch import train_distributed as td
    out = []
    for argv in argvs:
        try:
            td.main(argv)
            out.append(None)
        except (SystemExit, ValueError, NotImplementedError) as e:
            out.append((type(e).__name__, str(e)))
    return out


def worker_tp_ops(rank, world, model, case):
    """``core.tensor_parallel``'s four operators on this rank's parts of
    one computation: h = x · n, y = relu(h A) B, z = h C, loss = Σ uy·y +
    Σ uz·z, with ``n`` (d,) made ``whole`` from its part, ``A`` (d, f)
    and ``C`` (d, e) split on their columns, ``B`` (f, d) on its rows: h
    enters through ``copy_to_model``, y leaves through
    ``reduce_from_model``, z through ``gather_from_model``. ``case``:
    numpy x, n, A, B, C, uy, uz. Returns (y, z, and the gradients of x
    and of this rank's parts of n, A, B, C) as numpy."""
    import torch

    from repro_torch.core import tensor_parallel as tp
    from repro_torch.launch.mesh import make_local_mesh
    mesh = make_local_mesh(model=model)
    axis, i = mesh.model, mesh.model_index

    def part(a, dim):
        b = a.shape[dim] // model
        return torch.from_numpy(a.take(range(i * b, (i + 1) * b), axis=dim)
                                ).requires_grad_()
    x = torch.from_numpy(case["x"]).requires_grad_()
    n, A, B, C = (part(case[k], d) for k, d in (("n", 0), ("A", 1),
                                                ("B", 0), ("C", 1)))
    h = tp.copy_to_model(x * tp.whole(n, 0, axis), axis)
    y = tp.reduce_from_model(torch.relu(h @ A) @ B, axis)
    z = tp.gather_from_model(h @ C, axis)
    loss = torch.sum(torch.from_numpy(case["uy"]) * y) + torch.sum(
        torch.from_numpy(case["uz"]) * z)
    grads = torch.autograd.grad(loss, (x, n, A, B, C))
    return [t.detach().numpy() for t in (y, z, *grads)]


def _tp_cfg(arch, changes):
    import dataclasses

    from repro_torch.configs import get_arch, smoke_variant
    cfg = smoke_variant(get_arch(arch))
    changes = dict(changes)
    if "num_experts" in changes:
        changes["moe"] = dataclasses.replace(
            cfg.moe, num_experts=changes.pop("num_experts"))
    return dataclasses.replace(cfg, **changes)


def worker_tp_layer(rank, world, model, cases):
    """One layer of Megatron execution a case on this rank's parts:
    ``cases`` holds (kind, arch, config changes, the layer's whole weights
    as numpy ({'attn': ...}, {'ffn': ...} or {'moe': ...}), numpy input x
    (b, s, d), upstream u, ``moe_ffn`` keywords). The weights are placed
    by ``params_specs(..., 'tp')``; 'attn' runs ``attention`` on the flash
    backend (its plain version here), 'ffn' ``swiglu``, 'moe' ``moe_ffn``
    with the rule's expert share (None when it splits the ff dim). Returns
    per case {out, aux, dx, grads: this rank's part gradients by leaf
    name, dims: their split dims, experts: the share}."""
    import torch

    from repro_torch.core import sharding as shd
    from repro_torch.core import tensor_parallel as tp
    from repro_torch.core import weight_sharding as ws
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import attention as attn
    from repro_torch.models import layers as L
    from repro_torch.models import moe
    from repro_torch.tree import tree_map
    mesh = make_local_mesh(model=model)
    out = []
    for kind, arch, changes, weights, x, up, kwargs in cases:
        cfg = _tp_cfg(arch, changes)
        whole = tree_map(torch.from_numpy, weights)
        lay = ws.from_specs(shd.params_specs(whole, mesh, "tp"), mesh,
                            "tp")[kind]
        p = tree_map(lambda t: t.requires_grad_(), ws.cut(whole[kind], lay))
        xt = torch.from_numpy(x).requires_grad_()
        aux, share = None, None
        if kind == "attn":
            b, s = x.shape[:2]
            pos = torch.arange(s).expand(b, s)
            y = attn.attention(p, cfg, xt, pos, impl="flash",
                               axis=mesh.model)
        elif kind == "ffn":
            y = L.swiglu(xt, p["wi"], p["wg"], p["wo"], mesh.model)
        else:
            share = tp.expert_share(cfg, lay)
            y, aux = moe.moe_ffn(p, cfg, xt, experts=share, axis=mesh.model,
                                 **kwargs)
        loss = torch.sum(y * torch.from_numpy(up))
        if aux is not None:
            loss = loss + aux
        names = list(p)
        g = torch.autograd.grad(loss, [xt] + [p[k] for k in names])
        out.append({"out": y.detach().numpy(),
                    "aux": None if aux is None else aux.item(),
                    "dx": g[0].numpy(),
                    "grads": {k: t.numpy() for k, t in zip(names, g[1:])},
                    "dims": dict(lay.dims), "experts": share})
    return out


def worker_tp_lm(rank, world, model, arch, weights, tokens, moe_args):
    """``transformer.lm_loss`` under Megatron execution on this rank's
    parts of the smoke ``arch``'s whole weights (numpy, as
    ``interop.from_numpy`` takes them) placed by ``tensor_parallel.layout``
    on a (1, ``model``) mesh, for the numpy token batch. Records every
    leaf made ``whole`` (its part's shape and dim), the expert count each
    MoE expert product runs over, and refuses ``weight_sharding``'s
    gather. Returns {loss, xent, aux, grads by leaf path, dims by leaf
    path, whole, experts}."""
    import torch

    from repro_torch import interop
    from repro_torch.core import tensor_parallel as tp
    from repro_torch.core import weight_sharding as ws
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf
    from repro_torch.tree import leaves, tree_map
    mesh = make_local_mesh(model=model)
    cfg = _tp_cfg(arch, {})
    whole = interop.from_numpy(weights, "cpu")
    lay = tp.layout(cfg, whole, mesh)
    p = tree_map(lambda t: t.requires_grad_(), ws.cut(whole, lay))
    made_whole, experts, summed = [], [], []
    real_whole, real_experts = tp.whole, moe._experts
    real_gathered = tp.gathered

    def recording_whole(part, dim, axis):
        if dim is not None:
            made_whole.append((tuple(part.shape), dim))
        return real_whole(part, dim, axis)

    def recording_experts(w, xe):
        experts.append(int(xe.shape[0]))
        return real_experts(w, xe)

    def recording_gathered(part, dim, axis):
        if dim is None:
            return part
        summed.append((tuple(part.shape), dim))
        return real_gather(part, dim, axis)

    def refused(*args):
        raise AssertionError("weight_sharding's gather under tp")
    tp.whole, moe._experts = recording_whole, recording_experts
    tp.gathered = recording_gathered
    real_gather, ws._Gather.apply = ws._Gather.apply, refused
    try:
        with _scan_heads() as heads:
            loss, metrics = tf.lm_loss(
                cfg, p, {"tokens": torch.from_numpy(tokens)},
                moe_args=moe_args, layout=lay)
            paths = [k for k, _ in leaves(p)]
            grads = torch.autograd.grad(loss, [x for _, x in leaves(p)])
    finally:
        tp.whole, moe._experts = real_whole, real_experts
        tp.gathered = real_gathered
        ws._Gather.apply = real_gather
    return {"loss": loss.item(), "xent": metrics["xent"].item(),
            "aux": metrics["aux"].item(),
            "grads": {k: g.numpy() for k, g in zip(paths, grads)},
            "dims": dict(zip(paths, lay.flat_dims)),
            "whole": made_whole, "experts": experts, "summed": summed,
            "scan_heads": heads}


@contextlib.contextmanager
def _scan_heads():
    """A context in which the Mamba-2 mixer's scan records the heads of
    every call (x's third dim) in the list it yields."""
    from repro_torch.models import ssm

    heads, real = [], ssm.ssd_scan

    def recording(x, *args, **kw):
        heads.append(int(x.shape[2]))
        return real(x, *args, **kw)
    ssm.ssd_scan = recording
    try:
        yield heads
    finally:
        ssm.ssd_scan = real


def worker_tp_mixer(rank, world, model, arch, weights, x, up):
    """The Mamba-2 mixer of the smoke ``arch`` under Megatron execution:
    ``weights`` is one layer's whole mixer leaves as numpy, each stacked
    on a leading layer axis of 1 (so the rule sees the trainer's leaves);
    they are placed by ``params_specs(..., 'tp')`` on a (1, ``model``)
    mesh, ``block_params`` gives the layer's parts and gathered leaves,
    and ``mamba_mixer`` runs with the model axis on x (b, l, d), for the
    loss Σ up · out. Returns {out, dx, grads: this rank's part gradients
    by leaf name, dims: their split dims in one layer's view, heads: the
    scan's heads per call}."""
    import torch

    from repro_torch.core import sharding as shd
    from repro_torch.core import tensor_parallel as tp
    from repro_torch.core import weight_sharding as ws
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import ssm
    from repro_torch.tree import tree_map
    mesh = make_local_mesh(model=model)
    cfg = _tp_cfg(arch, {})
    whole = {"blocks": [{"mamba": tree_map(torch.from_numpy, weights)}]}
    stacked = ws.from_specs(shd.params_specs(whole, mesh, "tp"), mesh,
                            "tp")["blocks"][0]
    lay = ws.layer(stacked)
    p = tree_map(lambda t: t[0].clone().requires_grad_(),
                 ws.cut(whole["blocks"][0], stacked))
    xt = torch.from_numpy(x).requires_grad_()
    with _scan_heads() as heads:
        bp = tp.block_params(p, lay)
        y, _ = ssm.mamba_mixer(bp["mamba"], cfg, xt, axis=mesh.model)
        loss = torch.sum(y * torch.from_numpy(up))
        names = list(p["mamba"])
        g = torch.autograd.grad(loss, [xt] + [p["mamba"][k] for k in names])
    return {"out": y.detach().numpy(), "dx": g[0].numpy(),
            "grads": {k: t.numpy() for k, t in zip(names, g[1:])},
            "dims": dict(lay.dims["mamba"]), "heads": heads}


def worker_tp_serve(rank, world, model, cases):
    """The sharded serving steps on this rank's parts, a case each: the
    smoke ``arch``'s whole weights (numpy, as ``interop.from_numpy`` takes
    them) placed by ``steps.serving_layout`` under the case's
    ``sharding`` on the (world / model, ``model``) mesh, then
    ``steps.make_prefill_step`` (f32, ``collect_cache_len``) on the rank's
    rows of the numpy ``batch`` and ``make_serve_step`` on each of the
    case's decode ``tokens`` (n, b, 1) at its ``positions`` (an int, or a
    (b,) numpy array of per-slot positions, a step each). Under 'tp'
    ``weight_sharding``'s gather is refused but through
    ``tensor_parallel.gathered``; every leaf made whole is recorded by its
    path. The KV caches' sequence lies where ``steps.cache_seq_axis``
    places it for the case's global batch and ``cache_len``, and the steps
    take that ``seq_axis``. Returns per case {rows: the rank's first row
    and count, seq: None or the mesh axis the sequence lies over ('batch',
    'data' or 'model') with the rank's slice index and the slice count,
    logits:
    the prefill's and each step's, prefill_caches and caches (after the
    last step) as numpy lists, params_bytes, cache_bytes, whole and
    gathered: the paths made whole, experts: the expert count of each
    expert product, scan_heads}."""
    import torch

    from repro_torch import interop
    from repro_torch.core import tensor_parallel as tp
    from repro_torch.core import weight_sharding as ws
    from repro_torch.launch import steps as st
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import moe
    from repro_torch.tree import leaves, tree_leaves
    mesh = make_local_mesh(model=model)
    out = []
    for case in cases:
        cfg = _tp_cfg(case["arch"], {})
        lay = st.serving_layout(cfg, mesh, case["sharding"])
        params = ws.cut(interop.from_numpy(case["weights"], "cpu"), lay)
        owner = {x.untyped_storage().data_ptr(): path
                 for path, x in leaves(params)}
        b = case["batch"]["tokens"].shape[0]
        n = st.batch_rows(b, mesh, lay)
        first = (mesh.data_index * n) % b
        batch = {k: torch.from_numpy(v[first:first + n])
                 for k, v in case["batch"].items()}
        seq = st.cache_seq_axis(cfg, mesh, lay, b, case["cache_len"])
        seq_rec = None if seq is None else (
            next(a for a in ("batch", "data", "model")
                 if getattr(mesh, a) is seq), seq.index, seq.size)
        rec = {"whole": set(), "gathered": set(), "experts": []}
        real = (tp.whole, tp.gathered, moe._experts, ws._Gather.apply)

        def recording_whole(part, dim, axis):
            if dim is not None:
                rec["whole"].add(owner[part.untyped_storage().data_ptr()])
            return real[0](part, dim, axis)

        def recording_gathered(part, dim, axis):
            if dim is None:
                return part
            rec["gathered"].add(owner[part.untyped_storage().data_ptr()])
            return real[3](part, dim, axis)

        def recording_experts(w, xe):
            rec["experts"].append(int(xe.shape[0]))
            return real[2](w, xe)

        def refused(*args):
            raise AssertionError("weight_sharding's gather under tp")
        tp.whole, tp.gathered = recording_whole, recording_gathered
        moe._experts = recording_experts
        if tp.active(lay):
            ws._Gather.apply = refused
        kw = dict(precision="f32", moe_args=case["moe_args"], mesh=mesh,
                  layout=lay, seq_axis=seq)
        try:
            with torch.no_grad(), _scan_heads() as heads:
                logits, caches = st.make_prefill_step(
                    cfg, collect_cache_len=case["cache_len"], **kw)(params,
                                                                    batch)
                got = [logits.numpy()]
                # a copy: the steps write the caches in place
                pre = [type(c)(*(a.copy() for a in c))
                       for c in interop.caches_to_numpy(caches)]
                serve = st.make_serve_step(cfg, **kw)
                for i, tok in enumerate(case["tokens"]):
                    pos = case["positions"]
                    pos = (torch.from_numpy(pos[first:first + n] + i)
                           if hasattr(pos, "shape") else pos + i)
                    logits, caches = serve(params, caches, torch.from_numpy(
                        tok[first:first + n]), pos)
                    got.append(logits.numpy())
        finally:
            tp.whole, tp.gathered, moe._experts, ws._Gather.apply = real
        out.append({"rows": (first, n), "seq": seq_rec, "logits": got,
                    "prefill_caches": pre,
                    "caches": interop.caches_to_numpy(caches),
                    "params_bytes": sum(x.numel() * x.element_size()
                                        for x in tree_leaves(params)),
                    "cache_bytes": sum(x.numel() * x.element_size()
                                       for x in tree_leaves(caches)),
                    "whole": sorted(rec["whole"]),
                    "gathered": sorted(rec["gathered"]),
                    "experts": rec["experts"], "scan_heads": heads})
    return out


def worker_serve_probe(rank, world, argv):
    """``scripts/serve_sharded_probe.py``'s ``run(argv)`` on this rank, in
    the world's gloo group; returns its report."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "scripts", "serve_sharded_probe.py")
    spec = importlib.util.spec_from_file_location("serve_sharded_probe", path)
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    return probe.run(argv)
