"""Paper §5.2 rematerialisation as ``torch.utils.checkpoint`` policies
(port of ``repro/core/remat.py``).

BASIC's rule: keep every output of a weight-bearing op, recompute what has
no weights (norms, activations, softmax, attention). In the towers every
weight op is a dense layer, a matmul without batch dimensions, which
PyTorch dispatches as ``aten.mm`` (or ``aten.addmm``); a selective
checkpoint saves exactly those outputs. Each policy wraps one transformer
block, as the reference wraps one period step:

  basic        save the weight ops' outputs (mm / addmm), recompute the rest
               (the flash kernel's forward included)
  none         save everything (checkpointing with nothing recomputed)
  full         save nothing: the whole block is recomputed in the backward
  dots         save the matmuls without batch dimensions and recompute the
               batched ones (attention scores in the ``naive`` backend); on
               these towers that is the same set as ``basic``, as it is in
               the reference
  dots-only, full-block   aliases of dots and full
  off / None   no wrapping at all (distinct from ``none``)
"""
from __future__ import annotations

import functools
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

POLICIES = {}

_WEIGHT_OPS = frozenset({torch.ops.aten.mm.default,
                         torch.ops.aten.addmm.default})
_UNBATCHED_DOTS = _WEIGHT_OPS | {torch.ops.aten.mv.default,
                                 torch.ops.aten.dot.default}


def _register(name):
    def deco(fn):
        POLICIES[name] = fn
        return fn
    return deco


def _runner(context_fn=None) -> Callable:
    """A policy: ``policy(fn, *args)`` runs ``fn(*args)`` under a
    non-reentrant checkpoint with the given selective context."""
    kwargs = {} if context_fn is None else {"context_fn": context_fn}

    def run(fn, *args):
        return checkpoint(fn, *args, use_reentrant=False, **kwargs)
    return run


def _saving(decide: Callable) -> Callable:
    def policy_fn(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if decide(op)
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return _runner(functools.partial(create_selective_checkpoint_contexts,
                                     policy_fn))


@_register("basic")
def basic_policy():
    """Paper §5.2: save weight-op outputs, recompute norms/activations."""
    return _saving(lambda op: op in _WEIGHT_OPS)


@_register("none")
def no_remat_policy():
    """Save everything (vanilla; maximal memory)."""
    return _saving(lambda op: True)


@_register("full")
def full_remat_policy():
    """Save nothing: recompute the whole block in the backward pass."""
    return _runner()


@_register("dots")
def dots_policy():
    """Save matmul outputs without batch dimensions (the reference's
    ``checkpoint_dots_with_no_batch_dims``)."""
    return _saving(lambda op: op in _UNBATCHED_DOTS)


POLICIES["dots-only"] = dots_policy
POLICIES["full-block"] = full_remat_policy


def list_policies() -> list:
    """Registered policy names, usable with :func:`get_policy` and every
    ``--remat*`` flag of the trainer."""
    return sorted(POLICIES)


def get_policy(name: Optional[str]) -> Optional[Callable]:
    """Resolve a registry name to a policy ``policy(fn, *args)``; None or
    'off' means no wrapping (returns None). Raises KeyError on unknown
    names."""
    if name is None or name == "off":
        return None
    return POLICIES[name]()


def apply(policy: Optional[Callable], fn: Callable, *args):
    """``fn(*args)`` under ``policy``; without a policy, or with autograd
    off (GradAccum's pass 1), the block runs as it is."""
    if policy is None or not torch.is_grad_enabled():
        return fn(*args)
    return policy(fn, *args)
