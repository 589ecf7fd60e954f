"""Step factories of the port (counterpart of ``repro/launch/steps.py``):
the optimizer, the LM train / prefill / decode steps, the paper's own
contrastive training step and the phase-1 pretraining step of the BASIC
recipe, and the abstract params, optimizer state and inputs of an
(arch, input shape), built on the ``meta`` device (torch's
``eval_shape``: shapes and dtypes, no storage).

``make_contrastive_step`` builds Algorithm-1 GradAccum over ``num_micro``
microbatches followed by one AdaFactorW update, on one device, optionally
with the image tower frozen (phase 2). ``make_pretrain_step`` is phase 1:
softmax cross-entropy of the image tower plus a linear head (the step of
the reference's ``run_pretrain``, ``repro/launch/train.py:116-125``).
``make_train_step`` is the LM's next-token step (``transformer.lm_loss``
then AdaFactorW). The cross-shard losses and the input shardings wait
for the distributed-training slice; the MoE dispatch options for the MoE
slice.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Union

import torch

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.core import remat as remat_lib
from repro_torch.core.contrastive import contrastive_loss, fused_kernel_loss
from repro_torch.core.gradaccum import contrastive_step as ga_step
from repro_torch.models import dual_encoder as de
from repro_torch.models import frontends
from repro_torch.models import transformer as tf
from repro_torch.optim.adafactorw import AdaFactorW, apply_updates
from repro_torch.tree import tree_leaves, tree_map

LOSSES = {"local": contrastive_loss, "fused": fused_kernel_loss}
DISTRIBUTED_LOSSES = ("allgather", "chunked")


def make_optimizer(weight_decay=0.0025) -> AdaFactorW:
    """The reference trainer's AdaFactorW (beta1 0.9, beta2 0.99)."""
    return AdaFactorW(beta1=0.9, beta2=0.99, weight_decay=weight_decay)


def abstract_params(cfg: ArchConfig) -> dict:
    """The LM's params as ``meta`` tensors: every leaf's shape and dtype,
    nothing allocated or drawn."""
    return tf.init_params(cfg, torch.Generator(), "meta")


def abstract_opt_state(cfg: ArchConfig, opt: AdaFactorW, params_abs):
    """``opt``'s state for ``params_abs`` as ``meta`` tensors."""
    return opt.init(params_abs)


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


def lm_step(cfg: ArchConfig, opt: AdaFactorW, lr: Union[float, Callable],
            *, precision, remat_policy=None):
    """One LM training step: ``transformer.lm_loss`` and its gradients,
    then one ``opt`` update at ``lr`` (a float, or a schedule of the step
    count before the update). Returns train_step(params, opt_state,
    batch) -> (params, opt_state, loss, metrics)."""
    def train_step(params, opt_state, batch):
        loss, metrics, grads = value_and_grad(
            lambda p: tf.lm_loss(cfg, p, batch, precision=precision,
                                 remat_policy=remat_policy), params)
        step_lr = lr(opt_state.step) if callable(lr) else lr
        updates, new_opt = opt.update(grads, opt_state, params, step_lr)
        return apply_updates(params, updates), new_opt, loss, metrics

    return train_step


def make_train_step(cfg: ArchConfig, *, remat: Optional[str] = "basic",
                    lr: Union[float, Callable] = 1e-3, precision="bf16"):
    """The LM train step: ``transformer.lm_loss`` under the ``precision``
    policy (default bf16) with the ``remat`` policy per block (default
    'basic'), then ``make_optimizer``'s AdaFactorW. The attention backend
    is ``cfg.attn_impl`` ('pallas' runs the flash kernels).

    Returns (train_step, opt); train_step(params, opt_state, batch) ->
    (params, opt_state, loss, metrics)."""
    opt = make_optimizer()
    return lm_step(cfg, opt, lr, precision=precision,
                   remat_policy=remat_lib.get_policy(remat)), opt


def make_prefill_step(cfg: ArchConfig, *, precision="bf16"):
    """The prefill step: prefill_step(params, batch) -> the last position's
    logits (b, 1, vocab)."""
    def prefill_step(params, batch):
        return tf.prefill(cfg, params, batch, precision=precision)

    return prefill_step


def make_serve_step(cfg: ArchConfig, *, precision="bf16"):
    """The single-token decode step: serve_step(params, caches, token, pos)
    -> (logits (b, 1, vocab), caches), the caches written in place."""
    def serve_step(params, caches, token, pos):
        return tf.decode_step(cfg, params, token, pos, caches,
                              precision=precision)

    return serve_step


def input_specs(cfg: ArchConfig, shape: InputShape, *,
                dtype=torch.bfloat16) -> dict:
    """``meta`` stand-ins for every model input of ``shape``: a train or
    prefill batch (``frontends.train_inputs_spec``), or for decode the
    caches, the token (b, 1) int32 and the position () int32."""
    if shape.kind in ("train", "prefill"):
        return frontends.train_inputs_spec(cfg, shape, dtype=dtype)
    b = shape.global_batch
    return {
        "caches": tf.init_caches(cfg, b, shape.seq_len, dtype,
                                 device="meta"),
        "token": torch.empty((b, 1), dtype=torch.int32, device="meta"),
        "pos": torch.empty((), dtype=torch.int32, device="meta"),
    }


def make_contrastive_step(dual_cfg, *, num_micro: int = 8,
                          remat: Optional[str] = "basic",
                          remat_image: Optional[str] = None,
                          remat_text: Optional[str] = None,
                          lr: Union[float, Callable] = 2.5e-4,
                          precision="bf16", attn: Optional[str] = None,
                          mesh=None, loss: str = "local",
                          loss_opts: Optional[dict] = None,
                          skip_nonfinite: bool = False,
                          freeze_image: bool = False):
    """The paper's training step: Algorithm-1 GradAccum over ``num_micro``
    microbatches, then AdaFactorW.

    ``precision`` is a ``models.precision`` policy: the towers run in its
    compute dtype, the embeddings and the loss land in fp32. ``attn``
    overrides both towers' attention backend (naive | chunked | flash |
    pallas | auto; 'pallas' means the flash kernels); None keeps each
    tower's ``attn_impl``. ``remat`` picks the ``core.remat`` policy of both
    towers and ``remat_image`` / ``remat_text`` override it per tower.
    ``loss``: 'local' (the materialising ``contrastive_loss``) or 'fused'
    (the fused kernels). ``lr`` is a float or a schedule of the step count
    (``opt_state.step`` before the update).

    ``freeze_image=True`` is phase 2 of the recipe: the image tower's
    gradients are zeroed before the update, as the reference does
    (``repro/launch/train.py:157``, ``:164-166``). The image projection and
    ``log_tau`` still train, and the tower is not left unchanged: with a
    zero gradient the preconditioned update is zero, but the decoupled
    weight decay still moves it to p·(1 − lr·weight_decay) each step, and
    its second-moment slots still take in ``eps``.

    ``skip_nonfinite=True`` arms the step guard: the step also computes the
    global gradient norm and, when the loss or that norm is not finite,
    keeps the incoming params and optimizer state through an elementwise
    ``torch.where`` (no host synchronisation); ``metrics`` gains
    ``grad_norm`` and a 0/1 int32 ``skipped``. Finite steps take exactly
    the unguarded update.

    Returns (train_step, opt); train_step(params, opt_state, batch) ->
    (params, opt_state, loss, metrics)."""
    if loss in DISTRIBUTED_LOSSES or mesh is not None:
        raise NotImplementedError(
            f"loss={loss!r} / mesh: the cross-shard losses come with the "
            f"distributed-training slice of the port")
    if loss not in LOSSES:
        raise ValueError(f"unknown loss {loss!r}; have {sorted(LOSSES)}")
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
    loss_fn = LOSSES[loss]

    def enc_i(p, images):
        return de.encode_image(dual_cfg, p, images, precision=precision,
                               remat_policy=policy_i)

    def enc_t(p, texts):
        return de.encode_text(dual_cfg, p, texts, precision=precision,
                              remat_policy=policy_t)

    def train_step(params, opt_state, batch):
        loss_val, metrics, grads = ga_step(enc_i, enc_t, params, batch,
                                           num_micro, loss_fn=loss_fn,
                                           loss_opts=loss_opts)
        if freeze_image:
            grads["image"]["tower"] = tree_map(torch.zeros_like,
                                               grads["image"]["tower"])
        step_lr = lr(opt_state.step) if callable(lr) else lr
        updates, new_opt = opt.update(grads, opt_state, params, step_lr)
        new_params = apply_updates(params, updates)
        if skip_nonfinite:
            with torch.no_grad():
                gnorm = torch.sqrt(sum(torch.sum(g.float() ** 2)
                                       for g in tree_leaves(grads)))
                ok = torch.isfinite(loss_val) & torch.isfinite(gnorm)

                def keep(n, o):
                    return torch.where(ok, n, o)
                new_params = tree_map(keep, new_params, params)
                new_opt = type(new_opt)(*(tree_map(keep, n, o) for n, o in
                                          zip(new_opt, opt_state)))
            metrics = dict(metrics, grad_norm=gnorm,
                           skipped=(~ok).to(torch.int32))
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
