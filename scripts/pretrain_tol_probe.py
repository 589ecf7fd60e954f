"""Read the errors behind the card test of the pretrain step's kernel path.

    python3 scripts/pretrain_tol_probe.py

``tests/test_torch_cuda_train.py::test_pretrain_step_kernel_path_matches_
plain_path`` holds phase 1's loss and gradients on the flash kernels against
materialised attention, at smoke size (BASIC-S's image tower cut by
``smoke_dual_variant``, 16 labelled images, seed 0). This script computes
the same two readings (the loss's relative error, and the largest gradient
error over the leaves as a share of that leaf's largest entry) in f32 and
bf16 for:

- ``sound``: the kernel path as it is;
- ``causal``: the flash forward and backward run with a causal mask, which
  the image tower does not use (a wrong mask);
- ``lse+5%``: the backward given the forward's log-sum-exp plus log 1.05,
  so every softmax weight of the backward is 5% small (a wrong
  normaliser);
- ``vs f32 plain``: the kernel path at the precision against the plain
  path in f32 (how far that precision's rounding moves the step).

Prints the card line, one line per precision and case, then ``PROBE
<json>``. Needs a card; exits non-zero without one.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "src"))


def loss_and_grads(icfg, params, batch, precision, attn):
    """Phase 1's loss and its gradients by autograd, the tower's attention
    on ``attn`` (as the card test computes them)."""
    import torch

    from repro_torch.core.remat import get_policy
    from repro_torch.models import transformer as tf
    from repro_torch.tree import tree_leaves, tree_map
    cfg = dataclasses.replace(icfg, attn_impl=attn)
    live = tree_map(lambda x: x.detach().requires_grad_(), params)
    h = tf.encode(cfg, live["tower"], {"image": batch["image"]},
                  precision=precision, remat_policy=get_policy("basic"))
    logp = torch.log_softmax((h @ live["head"].to(h.dtype)).float(), dim=-1)
    loss = -torch.mean(torch.gather(logp, 1,
                                    batch["labels"].long()[:, None]))
    return float(loss.detach()), torch.autograd.grad(loss, tree_leaves(live))


def errors(got, ref):
    """(relative loss error, max over leaves of the gradient error as a
    share of the leaf's largest entry)."""
    (lg, gg), (lr, gr) = got, ref
    grad = max(float((a.float() - b.float()).abs().max())
               / max(float(b.float().abs().max()), 1e-30)
               for a, b in zip(gg, gr))
    return abs(lg - lr) / abs(lr), grad


def main() -> int:
    """Print every reading; returns the exit code."""
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("pretrain_tol_probe: needs a CUDA card", file=sys.stderr)
        return 1
    from unittest import mock

    from repro_torch.configs import get_arch, smoke_dual_variant
    from repro_torch.data import jft_batch, world_for_tower
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch.train import batch_to, init_pretrain_params

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    icfg = smoke_dual_variant(get_arch("basic-s")).image_tower
    rng = np.random.default_rng(0)
    world = world_for_tower(rng, icfg, n_classes=16)
    batch = batch_to(jft_batch(world, 16, rng)[0], "cuda")
    params = init_pretrain_params(icfg, 16, torch.Generator().manual_seed(0),
                                  "cuda")
    fwd, bwd = fa_ops.flash_fwd, fa_ops.flash_bwd

    def causal_fwd(*a, **k):
        return fwd(*a, **{**k, "causal": True})

    def causal_bwd(*a, **k):
        return bwd(*a, **{**k, "causal": True})

    def lse_bwd(q, k, v, bias, out, lse, dout, **kw):
        return bwd(q, k, v, bias, out, lse + math.log(1.05), dout, **kw)

    faults = {"causal": {"flash_fwd": causal_fwd, "flash_bwd": causal_bwd},
              "lse+5%": {"flash_bwd": lse_bwd}}
    f32_plain = loss_and_grads(icfg, params, batch, "f32", "naive")
    readings = {}
    for precision in ("f32", "bf16"):
        plain = loss_and_grads(icfg, params, batch, precision, "naive")
        cases = {"sound": errors(loss_and_grads(
            icfg, params, batch, precision, "pallas"), plain)}
        for name, patches in faults.items():
            with mock.patch.multiple(fa_ops, **patches):
                cases[name] = errors(loss_and_grads(
                    icfg, params, batch, precision, "pallas"), plain)
        cases["vs f32 plain"] = errors(loss_and_grads(
            icfg, params, batch, precision, "pallas"), f32_plain)
        for name, (loss_rel, grad) in cases.items():
            print(f"{precision} {name}: loss rel err {loss_rel!r}, gradient "
                  f"err / leaf max {grad!r}", flush=True)
        readings[precision] = {name: {"loss_rel": lr, "grad_of_max": g}
                               for name, (lr, g) in cases.items()}
    print("PROBE " + json.dumps(readings), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
