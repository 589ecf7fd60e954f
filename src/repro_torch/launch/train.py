"""Trainer of the port: BASIC contrastive training on one device
(counterpart of ``repro/launch/train.py`` in ``--mode contrastive`` and
``--mode finetune``, ``run_contrastive`` at :404-447).

Each step draws a batch of image-caption pairs from the synthetic world,
runs Algorithm-1 GradAccum over ``--num-micro`` microbatches and one
AdaFactorW update on the reference's ``warmup_cosine(lr, lr/100,
steps//10 or 1, steps)`` schedule, built through
``launch.steps.make_contrastive_step`` with the single-device options of
``repro/launch/train_distributed.py``: ``--loss local|fused``, ``--attn``,
``--precision``, ``--remat``, ``--remat-image``, ``--remat-text``.
The defaults are the kernel path in the reference trainer's precision:
``--loss fused --attn pallas --precision bf16 --remat basic``.

    python -m repro_torch.launch.train --mode contrastive --arch basic-s \\
        --batch 2048 --num-micro 8 --steps 6
    python -m repro_torch.launch.train --mode contrastive --arch basic-s \\
        --smoke --device cpu --steps 3 --batch 8 --num-micro 2

It runs on the card unless given ``--device cpu``, and raises without a
card otherwise. ``--mode finetune`` trains both towers, as ``contrastive``
does when no pretrained image tower is given (the reference's command line
gives none). ``--mode lm`` and ``--mode pretrain`` wait for the LM training
slice of the port (LM serving is ported: ``launch/serve.py``), ``--ckpt-dir`` for the port of ``checkpoint/io.py``.
"""
from __future__ import annotations

import argparse
import statistics
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_arch, smoke_dual_variant
from repro_torch.core.remat import list_policies
from repro_torch.data import contrastive_batch, load_tokenizer, \
    world_for_tower
from repro_torch.device import resolve_device
from repro_torch.interop import init_params
from repro_torch.launch.steps import LOSSES, make_contrastive_step
from repro_torch.models.attention import ALIASES, available_backends
from repro_torch.models.precision import list_policies as precisions
from repro_torch.optim import warmup_cosine
from repro_torch.tree import tree_map


def batch_to(batch, device):
    """A numpy batch tree -> torch tensors on ``device``."""
    return tree_map(lambda a: torch.from_numpy(a).to(device), batch)


def build_contrastive(args, device: torch.device) -> dict:
    """Config, synthetic world, tokenizer, data rng, params, optimizer state
    and step function (on the reference's schedule) of a contrastive run,
    drawn as the reference draws them: the world and the batches from
    ``np.random.default_rng(seed)``, the weights from ``seed + 1`` (a
    ``torch.Generator``)."""
    rng = np.random.default_rng(args.seed)
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = smoke_dual_variant(cfg, embed_dim=64)
    world = world_for_tower(rng, cfg.image_tower, n_classes=args.classes)
    tok = load_tokenizer(args.tokenizer)
    if tok.vocab_size > cfg.text_tower.vocab and not args.smoke:
        raise ValueError(f"tokenizer {args.tokenizer} has {tok.vocab_size} "
                         f"pieces, the text tower {cfg.text_tower.vocab}")
    params = init_params(cfg, torch.Generator().manual_seed(args.seed + 1),
                         device)
    lr_fn = warmup_cosine(args.lr, args.lr / 100, args.steps // 10 or 1,
                          args.steps)
    step_fn, opt = make_contrastive_step(
        cfg, num_micro=args.num_micro, remat=args.remat,
        remat_image=args.remat_image, remat_text=args.remat_text, lr=lr_fn,
        precision=args.precision, attn=args.attn, loss=args.loss)
    return {"cfg": cfg, "world": world, "tok": tok, "rng": rng,
            "params": params, "opt_state": opt.init(params),
            "step_fn": step_fn}


def run_contrastive(args) -> dict:
    """Phases 2/3 of the BASIC recipe: contrastive training with
    Algorithm-1 GradAccum. Returns a report: per-step losses, step and
    data seconds, the warm step median, steps and pairs per second, and on
    the card the peak of ``torch.cuda.max_memory_allocated``."""
    device = resolve_device(args.device)
    run = build_contrastive(args, device)
    params, opt_state = run["params"], run["opt_state"]
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    losses, step_s, data_s = [], [], []
    for i in range(args.steps):
        t0 = time.perf_counter()
        batch, _ = contrastive_batch(run["world"], run["tok"], args.batch,
                                     run["rng"])
        batch = batch_to(batch, device)
        if on_card:
            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        params, opt_state, loss, _ = run["step_fn"](params, opt_state, batch)
        losses.append(float(loss))          # waits for the step to finish
        t2 = time.perf_counter()
        data_s.append(t1 - t0)
        step_s.append(t2 - t1)
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"contrastive step {i:5d} loss {losses[-1]:.4f} "
                  f"({step_s[-1]:.3f}s/step, {1 / step_s[-1]:.3f} steps/s, "
                  f"{args.batch / step_s[-1]:.1f} pairs/s; data "
                  f"{data_s[-1]:.3f}s)", flush=True)
    warm = step_s[1:] or step_s
    median = statistics.median(warm)
    report = {"losses": losses, "step_s": step_s, "data_s": data_s,
              "warm_step_median_s": median, "steps_per_s": 1 / median,
              "pairs_per_s": args.batch / median, "device": str(device)}
    if on_card:
        report["max_memory_allocated"] = torch.cuda.max_memory_allocated(
            device)
    print(f"contrastive: {args.steps} steps of {args.batch} pairs, warm "
          f"step median {median:.3f}s, {report['steps_per_s']:.3f} steps/s, "
          f"{report['pairs_per_s']:.1f} pairs/s", flush=True)
    return report


def parse_args(argv: Optional[Sequence[str]] = None):
    """The trainer's command line (see the module docstring)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", required=True,
                    choices=["lm", "pretrain", "contrastive", "finetune"])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--num-micro", "--micro", dest="num_micro", type=int,
                    default=4, help="GradAccum microbatches")
    ap.add_argument("--classes", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--tokenizer", default="v1",
                    help="tokenizer artifact version "
                         "(artifacts/tokenizer_<v>.json)")
    ap.add_argument("--loss", default="fused", choices=sorted(LOSSES),
                    help="contrastive loss: the materialising 'local' or "
                         "the fused kernels")
    ap.add_argument("--attn", default="pallas",
                    choices=sorted(set(available_backends()) | set(ALIASES)
                                   | {"auto"}),
                    help="attention backend of both towers ('pallas' is "
                         "the flash kernels)")
    ap.add_argument("--precision", default="bf16", choices=precisions())
    remat_names = list_policies() + ["off"]
    ap.add_argument("--remat", default="basic", choices=remat_names)
    ap.add_argument("--remat-image", default=None, choices=remat_names)
    ap.add_argument("--remat-text", default=None, choices=remat_names)
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Parse ``argv``, run the mode, return its report."""
    args = parse_args(argv)
    if args.mode in ("lm", "pretrain"):
        raise NotImplementedError(f"--mode {args.mode} comes with the LM "
                                  f"training slice of the port")
    if args.ckpt_dir:
        raise NotImplementedError("--ckpt-dir comes with the port of "
                                  "checkpoint/io.py")
    if args.batch % args.num_micro:
        raise SystemExit(f"--batch {args.batch} must be divisible by "
                         f"--num-micro {args.num_micro}")
    return run_contrastive(args)


if __name__ == "__main__":
    main()
