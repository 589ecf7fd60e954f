"""Step factories of the port (counterpart of ``repro/launch/steps.py``):
the optimizer, the LM train / prefill / decode steps, the paper's own
contrastive training step and the phase-1 pretraining step of the BASIC
recipe, and the abstract params, optimizer state and inputs of an
(arch, input shape), built on the ``meta`` device (torch's
``eval_shape``: shapes and dtypes, no storage), with one rank's parts of
them on a mesh (``shardings_for``, which the dry run traces).

``make_contrastive_step`` builds Algorithm-1 GradAccum over ``num_micro``
microbatches followed by one AdaFactorW update, on one device, optionally
with the image tower frozen (phase 2). ``make_pretrain_step`` is phase 1:
softmax cross-entropy of the image tower plus a linear head (the step of
the reference's ``run_pretrain``, ``repro/launch/train.py:116-125``).
``make_train_step`` is the LM's next-token step (``transformer.lm_loss``
then AdaFactorW). ``moe_args`` pick a MoE model's dispatch: the train
and prefill steps default to ``DEFAULT_MOE_ARGS`` (capacity dispatch), the
decode step to dense dispatch, as in the reference. Across
``torch.distributed`` ranks (a ``launch.mesh`` mesh) the global batch is
split over every rank, the contrastive step takes the cross-shard
global-batch losses ('allgather', 'chunked') and the gradients are summed
over the ranks before the update. With a weight-sharding ``layout``
(``core.weight_sharding``, paper §5.1) the params and the optimizer slots
are this rank's parts, the models gather them on use, and a split leaf's
gradient arrives as a part summed over its model group and is then summed
over the data axis; a whole leaf's is summed over every rank. Under a
'tp' layout (Megatron execution, ``core.tensor_parallel``) the models
compute with the parts, the batch is split over the data axis only, and
every gradient is summed over the data axis. The prefill and decode
steps run on a rank's parts under either rule (``shardings_for``): the
reference's sharded serving steps, one program a rank, each rank holding
its part of every KV cache where the reference's ``cache_specs`` place
one (``cache_seq_axis``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.core import remat as remat_lib
from repro_torch.core import distributed_loss as dist_loss
from repro_torch.core import tensor_parallel as tp
from repro_torch.core import weight_sharding as ws
from repro_torch.core.contrastive import contrastive_loss, fused_kernel_loss
from repro_torch.core.gradaccum import contrastive_step as ga_step
from repro_torch.models import dual_encoder as de
from repro_torch.models import frontends
from repro_torch.models import transformer as tf
from repro_torch.optim.adafactorw import AdaFactorW, apply_updates
from repro_torch.tree import tree_map

LOSSES = {"local": contrastive_loss, "fused": fused_kernel_loss}
DEFAULT_MOE_ARGS = {"dispatch": "capacity", "group": 4096,
                    "capacity_factor": 1.25}
DISTRIBUTED_LOSSES = dist_loss.METHODS


def make_optimizer(weight_decay=0.0025) -> AdaFactorW:
    """The reference trainer's AdaFactorW (beta1 0.9, beta2 0.99)."""
    return AdaFactorW(beta1=0.9, beta2=0.99, weight_decay=weight_decay)


def abstract_params(cfg) -> dict:
    """The params of an LM or a dual encoder as ``meta`` tensors: every
    leaf's shape and dtype, nothing allocated or drawn."""
    from repro_torch.interop import init_params
    return init_params(cfg, torch.Generator(), "meta")


def abstract_opt_state(cfg: ArchConfig, opt: AdaFactorW, params_abs):
    """``opt``'s state for ``params_abs`` as ``meta`` tensors."""
    return opt.init(params_abs)


def batch_group(mesh, layout=None):
    """The ranks the global batch is split over: every rank of ``mesh``,
    or under a 'tp' layout (``core.tensor_parallel``) the data group, as
    the M ranks of a model group run the same examples. Either answers
    to ``ranks``, ``rank`` and the collectives the cross-shard loss
    uses."""
    return mesh.data if tp.active(layout) else mesh


def value_and_grad(loss_fn, params):
    """(loss, metrics, gradients) of ``loss_fn(params) -> (loss,
    metrics)``: fresh leaves share the params' storage, so the backward
    fills their ``.grad`` and leaves the params' own flags alone; a leaf
    the loss does not reach gets a zero gradient."""
    live = tree_map(lambda x: x.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss, metrics = loss_fn(live)
        loss.backward()
    grads = tree_map(lambda x: torch.zeros_like(x) if x.grad is None
                     else x.grad, live)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def guard_nonfinite(loss, gnorm, new_params, new_opt, params, opt_state):
    """The step guard: where ``loss`` or the gradient norm ``gnorm`` is
    not finite, the incoming params and optimizer state, else the new ones
    (an elementwise ``torch.where``, no host synchronisation). Returns
    (params, opt_state, skipped: 0/1 int32)."""
    with torch.no_grad():
        ok = torch.isfinite(loss) & torch.isfinite(gnorm)

        def keep(n, o):
            return torch.where(ok, n, o)
        new_params = tree_map(keep, new_params, params)
        new_opt = type(new_opt)(*(tree_map(keep, n, o) for n, o in
                                  zip(new_opt, opt_state)))
    return new_params, new_opt, (~ok).to(torch.int32)


def masked_share(cfg: ArchConfig, batch, group):
    """This rank's weight in the global loss where ``lm_loss`` is a masked
    mean (the encoder family's frame ``mask``, or a ``loss_mask``): its
    masked count over the group's, clamped at 1 as the loss's own
    divisor, so that the ranks' weighted means sum to the mean over the
    global batch, as the reference's loss over the global batch is.
    None for an unmasked mean over equal blocks (each rank weighs 1/n)."""
    if cfg.family == "encoder":
        m = batch["mask"]
    elif batch.get("loss_mask") is not None:
        m = batch["loss_mask"][:, 1:]
    else:
        return None
    count = m.float().sum()
    return count / torch.clamp(group.all_reduce(count), min=1.0)


def lm_step(cfg: ArchConfig, opt: AdaFactorW, lr: Union[float, Callable],
            *, precision, remat_policy=None, moe_args=None, mesh=None,
            layout=None, skip_nonfinite: bool = False):
    """One LM training step: ``transformer.lm_loss`` (with ``moe_args``)
    and its gradients, then one ``opt`` update at ``lr`` (a float, or a
    schedule of the step count before the update). With a ``mesh``
    (``launch.mesh``; the distributed trainer's) ``batch`` is the rank's
    block of the global batch: the gradients and the loss are averaged
    over all its ranks (``weight_sharding.sum_grads``, then a division by
    the rank count; under a 'tp' layout over the data shards, whose model
    ranks share a block), a masked loss weighing each rank by its masked
    count (``masked_share``), and ``metrics`` gains the global gradient
    norm ``grad_norm``. ``layout``: the params' weight-sharding layout when
    they are this rank's parts. ``skip_nonfinite=True`` arms the step
    guard (``guard_nonfinite``): a step whose loss or gradient norm is not
    finite keeps the incoming state, and ``metrics`` gains ``grad_norm``
    and a 0/1 int32 ``skipped``; finite steps take exactly the unguarded
    update. Returns train_step(params, opt_state, batch) -> (params,
    opt_state, loss, metrics)."""
    def train_step(params, opt_state, batch):
        group = share = None
        if mesh is not None and mesh.distributed:
            group = batch_group(mesh, layout)
            share = masked_share(cfg, batch, group)

        def loss_fn(p):
            loss, metrics = tf.lm_loss(cfg, p, batch, precision=precision,
                                       remat_policy=remat_policy,
                                       moe_args=moe_args, layout=layout)
            # weighted before the backward, whose collectives (the gathers'
            # reduce-scatters, tp's all-reduces) sum the ranks' gradients
            return (loss if share is None else loss * share), metrics

        loss, metrics, grads = value_and_grad(loss_fn, params)
        if group is not None:
            grads = ws.sum_grads(grads, mesh, layout)
            loss = group.all_reduce(loss)
            if share is None:
                n = group.ranks
                grads = tree_map(lambda g: g / n, grads)
                loss = loss / n
        if mesh is not None or skip_nonfinite:
            with torch.no_grad():
                metrics = dict(metrics, grad_norm=torch.sqrt(
                    ws.sq_norm(grads, layout)))
        step_lr = lr(opt_state.step) if callable(lr) else lr
        new_params, new_opt = opt.apply(grads, opt_state, params, step_lr,
                                        layout)
        if skip_nonfinite:
            new_params, new_opt, skipped = guard_nonfinite(
                loss, metrics["grad_norm"], new_params, new_opt, params,
                opt_state)
            metrics = dict(metrics, skipped=skipped)
        return new_params, new_opt, loss, metrics

    return train_step


def make_train_step(cfg: ArchConfig, *, remat: Optional[str] = "basic",
                    moe_args: Optional[dict] = None,
                    lr: Union[float, Callable] = 1e-3, precision="bf16",
                    mesh=None, layout=None):
    """The LM train step: ``transformer.lm_loss`` under the ``precision``
    policy (default bf16) with the ``remat`` policy per block (default
    'basic') and ``moe_args`` (default ``DEFAULT_MOE_ARGS``; with
    ``experts`` the params hold that share of every MoE layer, and the
    forward, its remat recompute and so the backward compute it), then
    ``make_optimizer``'s AdaFactorW. The attention backend is
    ``cfg.attn_impl`` ('pallas' runs the flash kernels). With a ``mesh``
    and a weight-sharding ``layout`` the step is one rank's, as in
    ``lm_step`` (the dry run's rank on its world).

    Returns (train_step, opt); train_step(params, opt_state, batch) ->
    (params, opt_state, loss, metrics)."""
    opt = make_optimizer()
    margs = DEFAULT_MOE_ARGS if moe_args is None else moe_args
    return lm_step(cfg, opt, lr, precision=precision,
                   remat_policy=remat_lib.get_policy(remat),
                   moe_args=margs, mesh=mesh, layout=layout), opt


def serving_layout(cfg: ArchConfig, mesh, mode: str):
    """The weight-sharding layout of a serving step's params on ``mesh``
    under the rule ``mode``: ``train_distributed.param_layout``'s, where
    under 'tp' every leaf Megatron uses whole is held whole
    (``tensor_parallel.serving``), so a step gathers no weight."""
    from repro_torch.launch import train_distributed as td
    return tp.serving(td.param_layout(cfg, mesh, mode))


def _serving_layout(mesh, layout):
    """``layout``, after checking that it lies over ``mesh``'s model axis
    (a serving step's weights live there; its caches' sequence may lie
    over other ranks of ``mesh``, ``cache_seq_axis``)."""
    if layout is not None and mesh is not None and \
            layout.axis.size != mesh.model_size:
        raise ValueError(f"the layout splits over {layout.axis.size} model "
                         f"ranks, the mesh has {mesh.model_size}")
    return layout


def make_prefill_step(cfg: ArchConfig, *, moe_args: Optional[dict] = None,
                      precision="bf16", collect_cache_len=None, mesh=None,
                      layout=None, seq_axis=None):
    """The prefill step: prefill_step(params, batch) -> the last position's
    logits (b, 1, vocab), or with ``collect_cache_len`` (logits, the
    decode caches built from the prompt); ``moe_args`` default to
    ``DEFAULT_MOE_ARGS``. With a ``mesh`` and the params' weight-sharding
    ``layout`` (``serving_layout``, as ``shardings_for`` places them) the
    step is one rank's on its parts, its caches the rank's, its logits
    the whole vocab (``transformer.prefill``); it issues collectives over
    the layout's model group alone, and ``mesh`` is checked against it.
    ``seq_axis``: the ranks of ``mesh`` the KV caches' sequence lies over
    (``cache_seq_axis`` of ``collect_cache_len``); the rank builds its
    slice of each alone."""
    margs = DEFAULT_MOE_ARGS if moe_args is None else moe_args
    layout = _serving_layout(mesh, layout)

    def prefill_step(params, batch):
        return tf.prefill(cfg, params, batch, precision=precision,
                          moe_args=margs, collect_cache_len=collect_cache_len,
                          layout=layout, seq_axis=seq_axis)

    return prefill_step


def make_serve_step(cfg: ArchConfig, *, moe_args: Optional[dict] = None,
                    precision="bf16", mesh=None, layout=None, seq_axis=None):
    """The single-token decode step: serve_step(params, caches, token, pos)
    -> (logits (b, 1, vocab), caches), the caches written in place.
    ``moe_args`` default to ``DEFAULT_MOE_ARGS`` with dense dispatch (the
    reference's default for one token a row: exact, every expert on every
    token). With a ``mesh`` and a ``layout`` as in ``make_prefill_step``:
    the rank's parts, the rank's caches (``transformer.init_caches(...,
    layout=, seq_axis=)``), the whole logits; with ``seq_axis`` (the
    caches' placement, ``cache_seq_axis``) each layer's partial attentions
    over the ranks' slices are merged over it."""
    margs = (dict(DEFAULT_MOE_ARGS, dispatch="dense") if moe_args is None
             else dict(moe_args))
    layout = _serving_layout(mesh, layout)

    def serve_step(params, caches, token, pos):
        return tf.decode_step(cfg, params, token, pos, caches,
                              precision=precision, moe_args=margs,
                              layout=layout, seq_axis=seq_axis)

    return serve_step


def input_specs(cfg: ArchConfig, shape: InputShape, *,
                dtype=torch.bfloat16, layout=None, seq_axis=None) -> dict:
    """``meta`` stand-ins for every model input of ``shape``: a train or
    prefill batch (``frontends.train_inputs_spec``), or for decode the
    caches (one rank's under a 'tp' ``layout`` and a ``seq_axis``,
    ``transformer.init_caches``), the token (b, 1) int32 and the position
    () int32."""
    if shape.kind in ("train", "prefill"):
        return frontends.train_inputs_spec(cfg, shape, dtype=dtype)
    b = shape.global_batch
    return {
        "caches": tf.init_caches(cfg, b, shape.seq_len, dtype,
                                 device="meta", layout=layout,
                                 seq_axis=seq_axis),
        "token": torch.empty((b, 1), dtype=torch.int32, device="meta"),
        "pos": torch.empty((), dtype=torch.int32, device="meta"),
    }


def contrastive_input_specs(dual_cfg, shape: InputShape, *,
                            dtype=torch.float32) -> dict:
    """``meta`` stand-ins of the contrastive batch of ``shape``: raw images
    (b, size, size, channels) for the patchify frontend in ``dtype`` and
    caption tokens (b, seq_len) int32, b the shape's global batch."""
    b = shape.global_batch
    it = dual_cfg.image_tower
    return {
        "images": {"image": torch.empty(
            (b, it.image_size, it.image_size, it.channels), dtype=dtype,
            device="meta")},
        "texts": {"tokens": torch.empty((b, shape.seq_len),
                                        dtype=torch.int32, device="meta")},
    }


def batch_rows(global_batch: int, mesh, layout=None,
               batch_over: str = "data") -> int:
    """The rows of a global batch one rank of ``mesh`` holds: the batch
    split over the data axes (``batch_over='all'``: and the model axis,
    the paper's §5.1 input over every core; under a 'tp' layout over the
    data axes only), an axis that does not divide it dropped, as the
    reference's ``batch_specs`` drops it."""
    from repro_torch.core import sharding as shd
    axes = shd.data_axes(mesh)
    if batch_over == "all" and not tp.active(layout):
        axes = (*axes, shd.MODEL)
    n = 1
    for a in axes:
        size = shd.mesh_axis_size(mesh, a)
        if global_batch % (n * size) == 0:
            n *= size
    return global_batch // n


def cache_seq_axis(cfg: ArchConfig, mesh, layout, global_batch: int,
                   cache_len: int):
    """The ranks of ``mesh`` a serving step's KV caches' sequence is split
    over (an ``Axis`` of ``mesh``, its ranks in slice order), or None
    where each rank holds its rows' slots whole: the one place the rule
    lives. It reads the reference's ``cache_specs``
    (``core.sharding.cache_specs``) for a KV leaf (layers, ``global_batch``,
    kv heads, ``cache_len``, head dim), whose batch lies over the data
    axes where it divides (``batch_rows``) and whose longest other dim
    lies over the model axis, or, where the batch does not divide, over
    the data and model axes together:

    - a sequence over the model axis: ``mesh.model`` under any rule but
      'tp'; under a 'tp' ``layout`` None, the kv heads lying over the
      model axis instead (Megatron attends a rank's heads), the same
      bytes a rank;
    - a sequence over the data and model axes: ``mesh.batch`` (every
      rank, data-major, as the reference orders them), or under 'tp'
      ``mesh.data`` beside the heads' split over the model axis;
    - a leaf whose head dim is longest (a cache shorter than a head) or
      whose sequence does not divide: None, the rows' slots whole (the
      reference splits the head dim there, or nothing).

    SSM caches keep their placement (``transformer.init_caches``).
    ``cache_len`` is the cache's length as built: ``collect_cache_len``
    for a prefill, ``attention.kv_cache_len`` of the positions for
    ``init_caches``. None without a mesh, or for a model without
    attention."""
    from repro_torch.core import sharding as shd
    if mesh is None or "attn" not in cfg.layer_kinds():
        return None
    leaf = torch.empty((1, global_batch, cfg.n_kv_heads, cache_len,
                        cfg.resolved_head_dim), device="meta")
    part = shd.cache_specs({"k": leaf}, mesh)["k"][3]
    names = () if part is None else (
        part if isinstance(part, tuple) else (part,))
    every = (*shd.data_axes(mesh), shd.MODEL)
    if tp.active(layout):
        axis = mesh.data if names == every else None
    elif names == (shd.MODEL,):
        axis = mesh.model
    elif names == every:
        axis = mesh.batch
    else:
        axis = None
    return axis if axis is not None and axis.size > 1 else None


def shardings_for(cfg, shape: InputShape, mesh, mode: str, params_abs,
                  opt_abs=None, *, dtype=torch.bfloat16,
                  batch_over: str = "data"):
    """One rank's abstract inputs of the step of ``shape`` on ``mesh``
    under the ``mode`` rule (``core.sharding.params_specs``: basic_ws |
    tp | replicated).

    torch has no shardings. Where the reference returns the in_shardings
    of one GSPMD program and its whole abstract inputs, the port runs one
    program a rank, so this returns what rank ``mesh.rank`` is handed,
    all ``meta``: its parts of ``params_abs`` under the rule
    (``train_distributed.param_layout``; for a prefill or decode step
    ``serving_layout``, which under 'tp' holds whole the norm scales, the
    mixer's B, C and conv weights and the vision frontend, so a rank
    holds (M - 1)/M of those leaves more than the reference's
    ``params_specs`` place on a device), of the optimizer state
    ``opt_abs`` for a train or contrastive step, and its rows of the
    batch (``batch_rows``). A train or contrastive step takes (params,
    opt_state, batch), prefill (params, batch), decode (params, caches,
    token, pos), pos the rows' positions (b,) int32, and the caches the
    rank's (``transformer.init_caches(..., layout=, seq_axis=)``): its
    rows', under 'tp' its KV/M kv heads and H/M SSD heads, and its slice
    of each KV cache's sequence where ``cache_seq_axis`` places one. So a
    rank's KV cache bytes are the reference's ``cache_specs`` bytes under
    every rule; its SSM state is 1/M of its rows' under 'tp' and whole
    under any other rule, and its SSD conv window keeps all of B and C,
    where the reference splits the state and the window's channels
    evenly (give the step that ``cache_seq_axis`` as its ``seq_axis``).

    Returns (layouts, inputs): the (params, opt_state) weight-sharding
    layouts (None where every leaf is whole, and the state's for a
    serving step; give the params' layout to the step) and the tuple of
    the step's inputs."""
    import dataclasses as dc

    from repro_torch.launch import train_distributed as td
    from repro_torch.tree import tree_leaves, unflatten
    serving = shape.kind in ("prefill", "decode")
    layout = (serving_layout(cfg, mesh, mode) if serving
              else td.param_layout(cfg, mesh, mode))
    rows = dc.replace(shape, global_batch=batch_rows(
        shape.global_batch, mesh, layout, batch_over))
    params = ws.cut(params_abs, layout)
    if serving:
        from repro_torch.models.attention import kv_cache_len
        seq = cache_seq_axis(cfg, mesh, layout, shape.global_batch,
                             kv_cache_len(cfg, shape.seq_len))
        ins = input_specs(cfg, rows, dtype=dtype, layout=layout,
                          seq_axis=seq)
        if shape.kind == "prefill":
            return (layout, None), (params, ins)
        # per-slot positions (the continuous engine's), which a trace on
        # meta tensors can carry: one position for every row is a host int
        pos = torch.empty((rows.global_batch,), dtype=torch.int32,
                          device="meta")
        return (layout, None), (params, ins["caches"], ins["token"], pos)
    batch = (contrastive_input_specs(cfg, rows) if shape.kind == "contrastive"
             else input_specs(cfg, rows, dtype=dtype))
    if layout is None:
        return (None, None), (params_abs, opt_abs, batch)
    slayout = ws.Layout(make_optimizer().split_dims(params_abs, layout),
                        layout.axis)
    opt_state = unflatten(opt_abs, [
        ws.cut_leaf(x, d, layout.axis)
        for x, d in zip(tree_leaves(opt_abs), slayout.flat_dims)])
    return (layout, slayout), (params, opt_state, batch)


def make_contrastive_step(dual_cfg, *, num_micro: int = 8,
                          remat: Optional[str] = "basic",
                          remat_image: Optional[str] = None,
                          remat_text: Optional[str] = None,
                          lr: Union[float, Callable] = 2.5e-4,
                          precision="bf16", attn: Optional[str] = None,
                          mesh=None, loss: str = "local",
                          loss_opts: Optional[dict] = None,
                          skip_nonfinite: bool = False,
                          freeze_image: bool = False, layout=None):
    """The paper's training step: Algorithm-1 GradAccum over ``num_micro``
    microbatches, then AdaFactorW.

    ``precision`` is a ``models.precision`` policy: the towers run in its
    compute dtype, the embeddings and the loss land in fp32. ``attn``
    overrides both towers' attention backend (naive | chunked | flash |
    pallas | auto; 'pallas' means the flash kernels); None keeps each
    tower's ``attn_impl``. ``remat`` picks the ``core.remat`` policy of both
    towers and ``remat_image`` / ``remat_text`` override it per tower.
    ``loss``: 'local' (the materialising ``contrastive_loss``) or 'fused'
    (the fused kernels), both on one device's batch; or 'allgather' /
    'chunked', the cross-shard GLOBAL-batch loss over every rank of
    ``mesh`` (required; ``core.distributed_loss``): each rank's ``batch``
    is then its block of the global batch, its gradients are summed over
    the ranks (``weight_sharding.sum_grads``: one all-reduce per dtype
    over every rank, log_tau's included, or over the data axis for the
    parts of split leaves) before the update, and every rank takes the
    same update. On a mesh of one rank both reduce to the fused loss.
    'local' and 'fused' on a mesh of several ranks run as 'allgather'
    when the data extent is 1 (the ranks are one data shard's model
    ranks, and the gathered batch is the single-device batch); across
    data shards they are refused: they would train on each shard's block
    alone. ``layout``: the params' weight-sharding layout when they are
    this rank's parts (the towers gather them on use, the update works on
    parts). Under a 'tp' layout (``core.tensor_parallel``) the towers
    compute with their parts, the M ranks of a model group hold their
    data shard's whole block, and the batch group is the data group
    (``batch_group``): 'local' and 'fused' at a data extent of 1 run as
    they are, 'allgather' and 'chunked' over the data shards, and the
    gradients are summed over the data axis. ``lr`` is a float or a
    schedule of the step count (``opt_state.step`` before the update).

    ``freeze_image=True`` is phase 2 of the recipe: the image tower's
    gradients are zeroed before the update, as the reference does
    (``repro/launch/train.py:157``, ``:164-166``). The image projection and
    ``log_tau`` still train, and the tower is not left unchanged: with a
    zero gradient the preconditioned update is zero, but the decoupled
    weight decay still moves it to p·(1 − lr·weight_decay) each step, and
    its second-moment slots still take in ``eps``.

    ``skip_nonfinite=True`` arms the step guard (``guard_nonfinite``): the
    step also computes the global gradient norm and, when the loss or that
    norm is not finite, keeps the incoming params and optimizer state;
    ``metrics`` gains ``grad_norm`` and a 0/1 int32 ``skipped``. Finite
    steps take exactly the unguarded update.

    Returns (train_step, opt); train_step(params, opt_state, batch) ->
    (params, opt_state, loss, metrics)."""
    group = None if mesh is None else batch_group(mesh, layout)
    if loss in LOSSES:
        if group is not None and group.distributed:
            if mesh.data_size > 1:
                raise ValueError(
                    f"loss={loss!r} trains on one device's batch; across "
                    f"{mesh.data_size} data shards use one of "
                    f"{DISTRIBUTED_LOSSES}")
            loss_fn = dist_loss.make_global_loss_fn(group, "allgather")
        else:
            loss_fn = LOSSES[loss]
    elif loss in DISTRIBUTED_LOSSES:
        if mesh is None:
            raise ValueError(f"loss={loss!r} needs a mesh")
        loss_fn = dist_loss.make_global_loss_fn(group, loss)
    else:
        raise ValueError(f"unknown loss {loss!r}; have "
                         f"{sorted(LOSSES) + list(DISTRIBUTED_LOSSES)}")
    if attn is not None:
        dual_cfg = dataclasses.replace(
            dual_cfg,
            image_tower=dataclasses.replace(dual_cfg.image_tower,
                                            attn_impl=attn),
            text_tower=dataclasses.replace(dual_cfg.text_tower,
                                           attn_impl=attn))
    opt = make_optimizer()
    policy_i = remat_lib.get_policy(remat if remat_image is None
                                    else remat_image)
    policy_t = remat_lib.get_policy(remat if remat_text is None
                                    else remat_text)

    def enc_i(p, images):
        return de.encode_image(dual_cfg, p, images, precision=precision,
                               remat_policy=policy_i, layout=layout)

    def enc_t(p, texts):
        return de.encode_text(dual_cfg, p, texts, precision=precision,
                              remat_policy=policy_t, layout=layout)

    def train_step(params, opt_state, batch):
        loss_val, metrics, grads = ga_step(enc_i, enc_t, params, batch,
                                           num_micro, loss_fn=loss_fn,
                                           loss_opts=loss_opts)
        if mesh is not None:
            grads = ws.sum_grads(grads, mesh, layout)
        if freeze_image:
            grads["image"]["tower"] = tree_map(torch.zeros_like,
                                               grads["image"]["tower"])
        step_lr = lr(opt_state.step) if callable(lr) else lr
        if skip_nonfinite:
            with torch.no_grad():
                gnorm = torch.sqrt(ws.sq_norm(grads, layout))
        new_params, new_opt = opt.apply(grads, opt_state, params, step_lr,
                                        layout)
        if skip_nonfinite:
            new_params, new_opt, skipped = guard_nonfinite(
                loss_val, gnorm, new_params, new_opt, params, opt_state)
            metrics = dict(metrics, grad_norm=gnorm, skipped=skipped)
        return new_params, new_opt, loss_val, metrics

    return train_step, opt


def make_pretrain_step(image_cfg, *, lr: float = 1e-3,
                       remat: Optional[str] = "basic", precision="bf16",
                       attn: Optional[str] = None):
    """Phase 1 of the BASIC recipe (paper §8): the image tower plus a linear
    head ``params = {'tower', 'head'}`` under softmax cross-entropy of the
    class labels, then one update of ``AdaFactorW()`` (weight decay 0, as
    the reference's ``run_pretrain``) at the constant ``lr`` (the
    reference's ``args.lr``).

    ``precision``, ``attn`` and ``remat`` as in ``make_contrastive_step``
    (``attn='pallas'`` runs the tower on the flash kernels).

    Returns (train_step, opt); train_step(params, opt_state, batch) ->
    (params, opt_state, loss, metrics), ``batch = {'image', 'labels'}``;
    int32 labels are widened to int64 for the gather."""
    if attn is not None:
        image_cfg = dataclasses.replace(image_cfg, attn_impl=attn)
    opt = AdaFactorW()
    policy = remat_lib.get_policy(remat)

    def loss_fn(p, images, labels):
        h = tf.encode(image_cfg, p["tower"], {"image": images},
                      precision=precision, remat_policy=policy)
        logits = h @ p["head"].to(h.dtype)
        logp = torch.log_softmax(logits.float(), dim=-1)
        return -torch.mean(torch.gather(logp, 1, labels.long()[:, None]))

    def train_step(params, opt_state, batch):
        loss, _, grads = value_and_grad(
            lambda p: (loss_fn(p, batch["image"], batch["labels"]), {}),
            params)
        updates, new_opt = opt.update(grads, opt_state, params, lr)
        return apply_updates(params, updates), new_opt, loss, {}

    return train_step, opt
