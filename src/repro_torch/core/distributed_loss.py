"""Cross-shard global-batch contrastive loss (port of
``repro/core/distributed_loss.py``; DESIGN.md §7).

The paper's quality lever is the GLOBAL contrastive batch: every example
sees every other example of the batch as a negative, across all the
ranks the batch is split over. Each rank holds the (B_local, D) embedding
blocks of its rows of the global batch (rank r: rows r·B_local ...
(r+1)·B_local), and this module computes the loss of the whole (B, B)
problem from them, two ways:

``all_gather_loss``
    Gather X and Y from every rank and run the fused loss
    (``kernels.contrastive_loss``) on the full (B, D) arrays on every rank.
    Simple and exact, but every rank does all O(B²·D) of the work.

``chunked_loss``
    Each rank keeps its X block and streams the R gathered Y blocks
    through ``chunk_row_col_lse`` (one ``fwd_fused`` launch per square
    (B_local, B_local) chunk): its row block of the similarity matrix and
    partial column LSEs, which a max and a sum all-reduce combine into the
    global column LSE as a stable log-sum-exp. The backward streams the
    same chunks through ``chunk_grads`` (``bwd_fused`` with ``b_norm`` the
    global batch, ``with_diag`` on the rank's own chunk only) and
    reduce-scatters the dY partials to the ranks that own those columns.
    Work per rank is O(B_local·B·D), R/2 times less, and no rank holds a
    (B, B) matrix.

Gradient convention. The loss L is the same scalar on every rank. Each
rank's backward returns the true dL/dX and dL/dY of ITS OWN block, and
its PARTIAL dL/dlog_tau: the ranks' partials sum to the whole. A rank's
tower gradients (from its own block) are partials in the same sense, so
the trainer sums every parameter gradient, log_tau's included, with one
all-reduce over the ranks (``launch.steps.make_contrastive_step``). The
chunked backward's dlog_tau partial covers the rank's rows; the all-gather
variant computes all of dL/dlog_tau on every rank and returns 1/R of it.
(The reference's ``_chunked_bwd`` instead scales by R and leaves dτ
unsummed, to match shard_map's AD convention; torch has no such
convention, so nothing is scaled here.)

``make_global_loss_fn(mesh, method)`` wraps either into the
``loss_fn(x, y, tau) -> (loss, metrics)`` that ``core.gradaccum`` takes;
with one rank it returns the single-device fused loss, as the reference
does on a data extent of 1. The ranks are the mesh's batch group
(``launch.mesh.Mesh``: every rank, data and model, in rank order, since
the global batch is split over all of them, paper §5.1): R, the rank's
index and the collectives are the group's, so ``b_norm`` is the global
batch and the diagonal falls in the chunk of the rank's place in it.
Under ``tp`` the M ranks of a model group hold the same block, and the
loss runs over the data group instead (``mesh.data``, an
``launch.mesh.Axis``, which answers to the same names; the trainer's
``launch.steps.batch_group``), so no rank's rows are taken M times.
"""
from __future__ import annotations

import torch

from repro_torch.core import sharding as shd
from repro_torch.core.contrastive import fused_kernel_loss
from repro_torch.kernels.contrastive_loss import ops

METHODS = ("allgather", "chunked")


def _zero_metrics(device) -> dict:
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return {"row_loss": zero, "col_loss": zero, "i2t_top1": zero}


# ---------------------------------------------------------------------------
# all-gather variant
# ---------------------------------------------------------------------------


class _GatherRows(torch.autograd.Function):
    """Every rank's (B_local, ...) block concatenated in rank order. Every
    rank computes the same loss from the gathered array, so its gradient
    is the same on every rank and each keeps its own rows of it."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return mesh.all_gather(t).reshape(-1, *t.shape[1:])

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        b = g.shape[0] // mesh.ranks
        return g[mesh.rank * b:(mesh.rank + 1) * b], None


class _Share(torch.autograd.Function):
    """Identity on a value every rank computes alike; its gradient is
    divided by the rank count, so the trainer's sum over ranks counts it
    once."""

    @staticmethod
    def forward(ctx, t, n):
        ctx.n = n
        return t.clone()

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def all_gather_loss(x_l: torch.Tensor, y_l: torch.Tensor,
                    log_tau: torch.Tensor, mesh) -> torch.Tensor:
    """Global-batch contrastive loss from the rank's (B_local, D) fp32 or
    bf16 unit-norm blocks ``x_l``, ``y_l`` (row i of each the two views of
    one pair) and the scalar fp32 ``log_tau``, by gathering both sides and
    running the fused loss on the full arrays. Returns the scalar fp32 loss
    (the same on every rank); differentiable (module docstring's
    convention)."""
    x_g = _GatherRows.apply(x_l, mesh)
    y_g = _GatherRows.apply(y_l, mesh)
    return ops.fused_contrastive_loss(x_g, y_g,
                                      _Share.apply(log_tau, mesh.ranks))


# ---------------------------------------------------------------------------
# chunked-negatives variant
# ---------------------------------------------------------------------------


class _ChunkedLoss(torch.autograd.Function):
    """The chunked loss's forward (reference ``_chunked_fwd``) and
    backward (``_chunked_bwd``, without its shard_map scaling)."""

    @staticmethod
    def forward(ctx, x_l, y_l, log_tau, mesh):
        x_l, y_l = x_l.detach().contiguous(), y_l.detach().contiguous()
        n, own = mesh.ranks, mesh.rank
        inv_tau = torch.exp(-log_tau.detach().float())
        y_all = mesh.all_gather(y_l)                     # (R, B_local, D)
        row_lse, col_parts = None, []
        for r in range(n):
            rl, cl = ops.chunk_row_col_lse(x_l, y_all[r], inv_tau)
            row_lse = rl if row_lse is None else torch.logaddexp(row_lse, rl)
            col_parts.append(cl)
        # col_parts[r]: log-sum over THIS rank's rows for chunk r's
        # columns; the global column LSE is the stable log-sum-exp over
        # the ranks: a max all-reduce, then a sum of exp(parts - max)
        col_parts = torch.stack(col_parts)               # (R, B_local)
        m = mesh.all_reduce(col_parts, "max")
        col_lse = m + torch.log(mesh.all_reduce(torch.exp(col_parts - m)))
        diag = torch.sum(x_l.float() * y_l.float(), dim=1) * inv_tau
        terms = torch.stack([torch.mean(row_lse - diag),
                             torch.mean(col_lse[own] - diag)])
        terms = mesh.all_reduce(terms) / n
        ctx.mesh = mesh
        ctx.save_for_backward(x_l, y_l, y_all, inv_tau, row_lse, col_lse)
        return 0.5 * (terms[0] + terms[1])

    @staticmethod
    def backward(ctx, g):
        x_l, y_l, y_all, inv_tau, row_lse, col_lse = ctx.saved_tensors
        mesh = ctx.mesh
        n, b_l = y_all.shape[:2]
        dx, dtau, dy_parts = 0.0, 0.0, []
        for r in range(n):
            # the positive pairs (the -δ_ij / B term) live in the own chunk
            dx_r, dy_r, dtau_r = ops.chunk_grads(
                x_l, y_all[r], inv_tau, row_lse, col_lse[r], b_norm=n * b_l,
                with_diag=r == mesh.rank)
            dx, dtau = dx + dx_r, dtau + dtau_r
            dy_parts.append(dy_r)
        # each rank holds dY partials of ALL columns (from its rows): sum
        # them over the ranks and hand each rank its own block
        dy = mesh.reduce_scatter(torch.stack(dy_parts))
        return ((g * dx).to(x_l.dtype), (g * dy).to(y_l.dtype), g * dtau,
                None)


def chunked_loss(x_l: torch.Tensor, y_l: torch.Tensor,
                 log_tau: torch.Tensor, mesh) -> torch.Tensor:
    """Global-batch contrastive loss by the chunked-negatives scheme (module
    docstring), from the rank's (B_local, D) fp32 or bf16 unit-norm blocks
    and the scalar fp32 ``log_tau``. Returns the scalar fp32 loss (the same
    on every rank); value and gradients match ``all_gather_loss`` and the
    single-device fused loss at the same global batch."""
    return _ChunkedLoss.apply(x_l, y_l, log_tau, mesh)


# ---------------------------------------------------------------------------
# the loss_fn of core.gradaccum
# ---------------------------------------------------------------------------


def make_global_loss_fn(mesh, method: str = "chunked"):
    """``loss_fn(x, y, tau) -> (loss, metrics)`` of the cross-shard GLOBAL
    batch, for ``core.gradaccum.contrastive_step(loss_fn=...)``: x, y are
    the rank's (B_local, D) blocks. ``method``: 'allgather' or 'chunked'.
    On a mesh of one rank the single-device fused loss is returned (the
    same value and gradients: the distributed paths reduce to it). Metrics
    are zeros, as in the reference (the argmax metric has no blockwise
    form)."""
    if method not in METHODS:
        raise ValueError(f"method must be one of {METHODS}, got {method!r}")
    if mesh.ranks == 1:
        return fused_kernel_loss
    if not mesh.distributed:
        raise ValueError(f"{mesh} splits its batch over {mesh.ranks} ranks "
                         f"but has no ranks to run them (no process group: "
                         f"make_local_mesh under torch.distributed)")
    fn = all_gather_loss if method == "allgather" else chunked_loss

    def loss_fn(x, y, tau):
        loss = fn(x, y, torch.log(tau), mesh)
        return loss, _zero_metrics(loss.device)

    return loss_fn


def emb_sharding(mesh) -> shd.P:
    """The layout of the (B, D) embedding blocks ``make_global_loss_fn``
    expects: batch over the data axes, D whole. The reference pins it with
    a sharding constraint; in the port each rank already holds only its own
    block, so this records the layout and nothing is pinned."""
    return shd.P(tuple(a for a in shd.data_axes(mesh) if a in mesh.shape),
                 None)
