"""Paper Algorithm 1: GradAccum for the contrastive loss (port of
``repro/core/gradaccum.py:36-108``).

The contrastive loss needs the whole B×B similarity matrix, so
per-microbatch losses cannot be formed independently. Algorithm 1 instead:

  pass 1  (lines 2-5):   forward each microbatch through F and G under
                         ``torch.no_grad``, keeping ONLY the embeddings;
  lines 6-12:            the full-batch loss on (X, Y) and its gradient
                         (dX, dY, dlog_tau) by ``torch.autograd.grad``;
  pass 2  (lines 13-16): re-run each microbatch forward and back-propagate
                         its dX / dY slice into the parameters with
                         ``torch.autograd.backward``, which accumulates the
                         microbatches' contributions in each ``.grad``.

The result is the exact full-batch gradient, with peak memory that of one
microbatch's graph instead of the whole batch's.

``microbatch_grads`` is the streaming form (the paper's "Yields" line): it
returns the per-microbatch gradient stream c_1..c_K that
``core/moment_accum.py`` folds into the optimizer's moment slots (port of
``repro/core/gradaccum.py:111-153``).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.contrastive import contrastive_loss
from repro_torch.tree import tree_leaves, tree_map


def _split(tree, k: int) -> list:
    """Every leaf (B, ...) cut into ``k`` microbatches along dim 0: a list
    of ``k`` trees."""
    b = tree_leaves(tree)[0].shape[0]
    if b % k:
        raise ValueError(f"batch {b} is not a multiple of num_micro={k}")
    return [tree_map(lambda x, i=i: x[i * (b // k):(i + 1) * (b // k)],
                     tree) for i in range(k)]


def _embedding_grads(encode_image: Callable, encode_text: Callable, params,
                     batch, num_micro: int, loss_fn: Callable,
                     loss_opts: Optional[dict]):
    """Algorithm 1 up to pass 2: the microbatches, then (pass 1, lines 2-5)
    the embeddings alone under ``torch.no_grad``, then (lines 6-12) the
    full-batch loss on them and d(loss)/d(X, Y, log_tau). Returns (images,
    texts, loss, metrics, dx, dy, dlog_tau)."""
    images = _split(batch["images"], num_micro)
    texts = _split(batch["texts"], num_micro)
    with torch.no_grad():
        x = torch.cat([encode_image(params, mb) for mb in images])
        y = torch.cat([encode_text(params, mb) for mb in texts])
    x.requires_grad_(True)
    y.requires_grad_(True)
    log_tau = params["log_tau"].detach().requires_grad_(True)
    with torch.enable_grad():
        loss, metrics = loss_fn(x, y, torch.exp(log_tau),
                                **(loss_opts or {}))
        dx, dy, dlog_tau = torch.autograd.grad(loss, (x, y, log_tau))
    return images, texts, loss, metrics, dx, dy, dlog_tau


def contrastive_step(encode_image: Callable, encode_text: Callable,
                     params, batch, num_micro: int,
                     loss_fn: Callable = contrastive_loss,
                     loss_opts: Optional[dict] = None,
                     emb_sharding=None):
    """Exact full-batch contrastive gradient via Algorithm 1.

    encode_image(params, images_mb) -> (M, D) unit-norm embeddings;
    encode_text(params, texts_mb) -> (M, D). ``params`` is a dict tree of
    leaf tensors holding 'log_tau'; ``batch`` = {'images': ..., 'texts':
    ...} with the batch dim B leading every leaf, B a multiple of
    ``num_micro``. ``loss_opts`` is forwarded to ``loss_fn(x, y, tau)``.

    Returns (loss, metrics, grads): grads is a fresh tree with the params'
    leaf paths, equal to the gradient of the monolithic loss. The params'
    ``requires_grad`` flags and ``.grad`` are restored as they were.
    ``emb_sharding`` belongs to the cross-shard loss, which comes with the
    distributed-training slice of the port."""
    if emb_sharding is not None:
        raise NotImplementedError(
            "emb_sharding: the cross-shard global-batch loss comes with the "
            "distributed-training slice of the port")
    images, texts, loss, metrics, dx, dy, dlog_tau = _embedding_grads(
        encode_image, encode_text, params, batch, num_micro, loss_fn,
        loss_opts)

    # ---- pass 2: recompute per microbatch, backward into the weights ----
    leaves = tree_leaves(params)
    saved = [(p.requires_grad, p.grad) for p in leaves]
    for p in leaves:
        p.requires_grad_(True)
        p.grad = None
    try:
        m = dx.shape[0] // num_micro
        with torch.enable_grad():
            for i, (img, txt) in enumerate(zip(images, texts)):
                sl = slice(i * m, (i + 1) * m)
                torch.autograd.backward(
                    [encode_image(params, img), encode_text(params, txt)],
                    [dx[sl], dy[sl]])
        grads = tree_map(lambda p: p.grad if p.grad is not None
                         else torch.zeros_like(p), params)
    finally:
        for p, (flag, grad) in zip(leaves, saved):
            p.grad = grad
            p.requires_grad_(flag)
    # the embeddings' backward gives log_tau nothing; add the direct term
    grads["log_tau"] = grads["log_tau"] + dlog_tau
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def microbatch_grads(encode_image: Callable, encode_text: Callable,
                     params, batch, num_micro: int,
                     loss_fn: Callable = contrastive_loss,
                     loss_opts: Optional[dict] = None):
    """Streaming form of Algorithm 1: returns (loss, metrics, c), where c
    is the stacked per-microbatch gradient stream, a tree with the params'
    leaf paths and leaves (K, ...). Each c_i is K times microbatch i's
    share of the gradient plus the full ``dlog_tau`` (as the reference
    adds it, ``repro/core/gradaccum.py:148``), so mean_K(c) is the exact
    full-batch gradient (paper §4.1).

    Each microbatch's gradients are taken apart by ``torch.autograd.grad``
    on aliases of the params (nothing accumulates in any ``.grad``, and the
    params' own flags are left alone)."""
    images, texts, loss, metrics, dx, dy, dlog_tau = _embedding_grads(
        encode_image, encode_text, params, batch, num_micro, loss_fn,
        loss_opts)
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    flat = tree_leaves(live)
    m = dx.shape[0] // num_micro
    stream = []
    for i, (img, txt) in enumerate(zip(images, texts)):
        sl = slice(i * m, (i + 1) * m)
        with torch.enable_grad():
            g = torch.autograd.grad(
                [encode_image(live, img), encode_text(live, txt)], flat,
                [dx[sl], dy[sl]], allow_unused=True)
        by_leaf = {id(p): gi for p, gi in zip(flat, g)}
        # K * grad-share so that mean_K(c_i) is the exact full gradient
        c = tree_map(lambda p: num_micro * (
            torch.zeros_like(p) if by_leaf[id(p)] is None
            else by_leaf[id(p)]), live)
        c["log_tau"] = c["log_tau"] + dlog_tau
        stream.append(c)
    c = tree_map(lambda *cs: torch.stack(cs), stream[0], *stream[1:])
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, c
