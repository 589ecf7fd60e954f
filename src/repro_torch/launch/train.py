"""Trainer of the port: LM next-token training and the BASIC three-phase
recipe on one device (counterpart of ``repro/launch/train.py``:
``run_lm`` at :50-82, ``run_pretrain`` at :104-135, ``run_contrastive`` at
:138-181).

- ``--mode lm``: next-token training of a decoder LM (dense or ssm) on
  ``frontends.synthetic_inputs`` of ``--batch`` × ``--seq`` tokens, a
  fresh batch a step from ``np.random.default_rng(seed)``: ``lm_loss`` in
  f32 with no remat, then ``AdaFactorW(weight_decay=0.0025)`` on
  ``warmup_cosine(lr, lr/100, steps//10 or 1, steps)``, as the reference
  computes it. ``--precision`` and ``--remat`` are refused here (the
  reference's ``run_lm`` has neither); ``--attn`` picks the backend
  ('pallas', the default, is the flash kernels: on the card, the causal
  grouped-query forward and backward). The SSM family trains on the CPU,
  where the scan's plain version is differentiable; on the card its
  ``ssd_scan`` kernel has no backward yet and raises.

- ``--mode pretrain`` (phase 1, paper §8): the image tower plus a linear
  head under softmax cross-entropy of ``jft_batch``'s labels, one update
  of ``AdaFactorW()`` per step at the constant ``--lr``
  (``launch.steps.make_pretrain_step``).
- ``--mode contrastive`` (phase 2) and ``--mode finetune`` (phase 3): each
  step draws a batch of image-caption pairs, runs Algorithm-1 GradAccum
  over ``--num-micro`` microbatches and one AdaFactorW update on the
  reference's ``warmup_cosine(lr, lr/100, steps//10 or 1, steps)``
  schedule, built through ``launch.steps.make_contrastive_step`` with the
  single-device options of ``repro/launch/train_distributed.py``:
  ``--loss local|fused``, ``--attn``, ``--precision``, ``--remat``,
  ``--remat-image``, ``--remat-text``.

The recipe's defaults are the kernel path in the reference trainer's
precision: ``--loss fused --attn pallas --precision bf16 --remat basic``.
``--ckpt-dir`` saves the final params as step ``--steps`` there, in the
reference's checkpoint format (``repro_torch.checkpoint``), in every mode.

    python -m repro_torch.launch.train --mode lm --arch llama3.2-1b \\
        --batch 4 --seq 1024 --steps 4 --ckpt-dir /path/to/ckpt
    python -m repro_torch.launch.train --mode pretrain --arch basic-s \\
        --batch 1024 --steps 4
    python -m repro_torch.launch.train --mode contrastive --arch basic-s \\
        --batch 2048 --num-micro 8 --steps 6
    python -m repro_torch.launch.train --mode contrastive --arch basic-s \\
        --smoke --device cpu --steps 3 --batch 8 --num-micro 2

Every phase sees one world: ``np.random.default_rng(seed)`` draws the
synthetic world, then the phase's batches; the pretraining weights come
from ``seed``, the dual encoder's from ``seed + 1``. The phases chain in
Python as the reference's (``examples/contrastive_pretrain_torch.py``):
``run_contrastive(args, image_tower_init=..., train_image=False)`` starts
from a pretrained tower and keeps its gradients at zero; every run returns
its params in its report. From the command line no tower is given, so
``contrastive`` and ``finetune`` both train both towers, as in the
reference.

It runs on the card unless given ``--device cpu``, and raises without a
card otherwise. No mode resumes from a checkpoint, as in the reference:
resuming belongs to the distributed trainer.
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch import checkpoint as ckpt
from repro_torch.configs import (ArchConfig, get_arch, smoke_dual_variant,
                                 smoke_variant)
from repro_torch.core.remat import list_policies
from repro_torch.data import contrastive_batch, jft_batch, load_tokenizer, \
    world_for_tower
from repro_torch.device import resolve_device
from repro_torch.interop import init_params
from repro_torch.launch.steps import LOSSES, lm_step, \
    make_contrastive_step, make_pretrain_step
from repro_torch.models import frontends
from repro_torch.models import transformer as tf
from repro_torch.models.attention import ALIASES, available_backends
from repro_torch.models.precision import list_policies as precisions
from repro_torch.optim import AdaFactorW, warmup_cosine
from repro_torch.tree import tree_map


def batch_to(batch, device):
    """A numpy batch tree -> torch tensors on ``device``."""
    return tree_map(lambda a: torch.from_numpy(a).to(device), batch)


def _build_world(args):
    """(config, synthetic world, tokenizer, data rng) of a run, drawn as the
    reference's ``_build_world`` draws them (``:90-101``): the world from
    ``np.random.default_rng(seed)``, whose state then draws the batches."""
    rng = np.random.default_rng(args.seed)
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = smoke_dual_variant(cfg, embed_dim=64)
    world = world_for_tower(rng, cfg.image_tower, n_classes=args.classes)
    tok = load_tokenizer(args.tokenizer)
    if tok.vocab_size > cfg.text_tower.vocab and not args.smoke:
        raise ValueError(f"tokenizer {args.tokenizer} has {tok.vocab_size} "
                         f"pieces, the text tower {cfg.text_tower.vocab}")
    return cfg, world, tok, rng


def init_pretrain_params(image_cfg, n_classes: int,
                         generator: torch.Generator, device) -> dict:
    """Phase-1 params with the reference's law: the image tower and a head
    (d_model, n_classes) of standard normals times d_model^-0.5."""
    tower = tf.init_params(image_cfg, generator, device)
    head = torch.randn((image_cfg.d_model, n_classes), generator=generator,
                       device=generator.device) * image_cfg.d_model ** -0.5
    return {"tower": tower, "head": head.to(device)}


def build_contrastive(args, device: torch.device, image_tower_init=None,
                      train_image: bool = False) -> dict:
    """Config, world, tokenizer, data rng, params (from ``seed + 1``, with
    a copy of ``image_tower_init`` in place of the image tower when one is
    given), optimizer state and step function (on the reference's
    schedule) of a phase-2/3 run. A tower given and not trained is frozen
    (``make_contrastive_step(freeze_image=True)``)."""
    cfg, world, tok, rng = _build_world(args)
    params = init_params(cfg, torch.Generator().manual_seed(args.seed + 1),
                         device)
    if image_tower_init is not None:
        params["image"]["tower"] = tree_map(
            lambda t: t.detach().to(device, copy=True), image_tower_init)
    lr_fn = warmup_cosine(args.lr, args.lr / 100, args.steps // 10 or 1,
                          args.steps)
    step_fn, opt = make_contrastive_step(
        cfg, num_micro=args.num_micro, remat=args.remat,
        remat_image=args.remat_image, remat_text=args.remat_text, lr=lr_fn,
        precision=args.precision, attn=args.attn, loss=args.loss,
        freeze_image=image_tower_init is not None and not train_image)
    return {"cfg": cfg, "world": world, "tok": tok, "rng": rng,
            "params": params, "opt_state": opt.init(params),
            "step_fn": step_fn}


def _run_steps(args, run, device: torch.device, draw: Callable, mode: str,
               metric: str, unit: str, per_step: Optional[int] = None
               ) -> dict:
    """``args.steps`` timed steps of ``run`` on batches from ``draw()`` (a
    tree of tensors on ``device``); prints each logged step and a summary,
    saves the final params as step ``args.steps`` under ``args.ckpt_dir``
    when one is given, and returns the report: per-step losses, step and
    data seconds, the warm step median, steps and ``unit`` per second
    (``per_step`` units a step, default ``args.batch``), the final params
    and optimizer state, on the card the peak of
    ``torch.cuda.max_memory_allocated``, and with a checkpoint its path
    and the seconds the blocking save took."""
    per_step = args.batch if per_step is None else per_step
    params, opt_state = run["params"], run["opt_state"]
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    losses, step_s, data_s = [], [], []
    for i in range(args.steps):
        t0 = time.perf_counter()
        batch = draw()
        if on_card:
            torch.cuda.synchronize(device)
        t1 = time.perf_counter()
        params, opt_state, loss, _ = run["step_fn"](params, opt_state, batch)
        losses.append(float(loss))          # waits for the step to finish
        t2 = time.perf_counter()
        data_s.append(t1 - t0)
        step_s.append(t2 - t1)
        if i % args.log_every == 0 or i == args.steps - 1:
            print(f"{mode} step {i:5d} {metric} {losses[-1]:.4f} "
                  f"({step_s[-1]:.3f}s/step, {1 / step_s[-1]:.3f} steps/s, "
                  f"{per_step / step_s[-1]:.1f} {unit}/s; data "
                  f"{data_s[-1]:.3f}s)", flush=True)
    warm = step_s[1:] or step_s
    median = statistics.median(warm)
    report = {"losses": losses, "step_s": step_s, "data_s": data_s,
              "warm_step_median_s": median, "steps_per_s": 1 / median,
              f"{unit}_per_s": per_step / median, "device": str(device),
              "params": params, "opt_state": opt_state}
    if on_card:
        report["max_memory_allocated"] = torch.cuda.max_memory_allocated(
            device)
    print(f"{mode}: {args.steps} steps of {per_step} {unit}, warm step "
          f"median {median:.3f}s, {report['steps_per_s']:.3f} steps/s, "
          f"{report[f'{unit}_per_s']:.1f} {unit}/s", flush=True)
    if args.ckpt_dir:
        t0 = time.perf_counter()
        report["ckpt_path"] = ckpt.save(args.ckpt_dir, args.steps, params)
        report["ckpt_save_s"] = time.perf_counter() - t0
        print(f"saved: {report['ckpt_path']} "
              f"({report['ckpt_save_s']:.3f}s)", flush=True)
    return report


def run_lm(args, params_init=None) -> dict:
    """Next-token training of the decoder LM ``args.arch`` (its smoke
    variant with ``args.smoke``) on synthetic tokens, computing what the
    reference's ``run_lm`` computes. The weights come from ``seed`` (drawn
    on the run's device), or are a copy of ``params_init`` when given (the
    test hook; never changed in place). Returns the report of
    ``_run_steps`` (tokens/s); ``report['params']`` is the LM's params."""
    device = resolve_device(args.device)
    cfg = get_arch(args.arch)
    if not isinstance(cfg, ArchConfig):
        raise ValueError(f"--mode lm trains a decoder LM; {args.arch} is a "
                         f"dual encoder (--mode pretrain, contrastive, "
                         f"finetune)")
    if args.smoke:
        cfg = smoke_variant(cfg)
    cfg = dataclasses.replace(cfg, attn_impl=args.attn)
    if params_init is not None:
        params = tree_map(lambda t: t.detach().to(device, copy=True),
                          params_init)
    else:
        params = tf.init_params(
            cfg, torch.Generator(device=device).manual_seed(args.seed),
            device)
    opt = AdaFactorW(weight_decay=0.0025)
    lr_fn = warmup_cosine(args.lr, args.lr / 100, args.steps // 10 or 1,
                          args.steps)
    run = {"params": params, "opt_state": opt.init(params),
           "step_fn": lm_step(cfg, opt, lr_fn, precision="f32")}
    rng = np.random.default_rng(args.seed)
    return _run_steps(
        args, run, device,
        lambda: frontends.synthetic_inputs(cfg, args.batch, args.seq, rng,
                                           device=device),
        "lm", "loss", "tokens", per_step=args.batch * args.seq)


def run_pretrain(args) -> dict:
    """Phase 1 of the BASIC recipe: the image tower and a linear classifier
    on the synthetic JFT analog's labels, the weights from ``seed``.
    Returns the report of ``_run_steps`` (images/s); ``report['params']``
    is ``{'tower', 'head'}``."""
    device = resolve_device(args.device)
    cfg, world, _, rng = _build_world(args)
    params = init_pretrain_params(cfg.image_tower, world.n_classes,
                                  torch.Generator().manual_seed(args.seed),
                                  device)
    step_fn, opt = make_pretrain_step(
        cfg.image_tower, lr=args.lr, precision=args.precision,
        attn=args.attn,
        remat=args.remat if args.remat_image is None else args.remat_image)
    run = {"params": params, "opt_state": opt.init(params),
           "step_fn": step_fn}
    return _run_steps(
        args, run, device,
        lambda: batch_to(jft_batch(world, args.batch, rng)[0], device),
        "pretrain", "xent", "images")


def run_contrastive(args, image_tower_init=None,
                    train_image: bool = False) -> dict:
    """Phases 2/3 of the BASIC recipe: contrastive training with
    Algorithm-1 GradAccum, from ``image_tower_init`` when given (frozen
    unless ``train_image``; never changed in place). Returns the report of
    ``_run_steps`` (pairs/s); ``report['params']`` is the dual encoder's
    params."""
    device = resolve_device(args.device)
    run = build_contrastive(args, device, image_tower_init, train_image)
    return _run_steps(
        args, run, device,
        lambda: batch_to(contrastive_batch(run["world"], run["tok"],
                                           args.batch, run["rng"])[0],
                         device),
        "contrastive", "loss", "pairs")


def parse_args(argv: Optional[Sequence[str]] = None):
    """The trainer's command line (see the module docstring)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", required=True,
                    choices=["lm", "pretrain", "contrastive", "finetune"])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=128,
                    help="tokens per sequence (--mode lm)")
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
    ap.add_argument("--precision", default=None, choices=precisions(),
                    help="the recipe's precision policy (default bf16)")
    remat_names = list_policies() + ["off"]
    ap.add_argument("--remat", default=None, choices=remat_names,
                    help="the recipe's remat policy (default basic)")
    ap.add_argument("--remat-image", default=None, choices=remat_names)
    ap.add_argument("--remat-text", default=None, choices=remat_names)
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)
    tuned = [f for f in ("precision", "remat", "remat_image", "remat_text")
             if getattr(args, f) is not None]
    if args.mode == "lm":
        if tuned:
            ap.error(f"--mode lm computes the reference's run_lm (f32, no "
                     f"remat); it takes no "
                     f"{', '.join('--' + f.replace('_', '-') for f in tuned)}")
    else:
        args.precision = args.precision or "bf16"
        args.remat = args.remat or "basic"
    return args


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Parse ``argv``, run the mode, return its report."""
    args = parse_args(argv)
    if args.mode == "lm":
        return run_lm(args)
    if args.mode == "pretrain":
        return run_pretrain(args)
    if args.batch % args.num_micro:
        raise SystemExit(f"--batch {args.batch} must be divisible by "
                         f"--num-micro {args.num_micro}")
    return run_contrastive(args, train_image=args.mode == "finetune")


if __name__ == "__main__":
    main()
