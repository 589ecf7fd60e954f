"""The port's zero-shot accuracy table, the paper's Tables 1/3 analog
(counterpart of ``benchmarks/zero_shot.py``): one short contrastive run of
a smoke-size BASIC-S dual encoder, then top-1 accuracy on held-out class
splits with their own images:

  seen       classes 0-15, used in contrastive training (ImageNet analog)
  unseen     classes 16-23, never in training (open-vocabulary transfer)
  shifted    seen classes rendered at 2x noise (robustness analog)

The recipe is the reference's: ``AdaFactorW()`` at lr 2e-3, Algorithm-1
GradAccum in 2 microbatches with the local loss, 80 steps of 32 pairs over
the seen classes, 128 fresh images per row, one prompt per class
(``classification_prompts``). Weights come from ``torch.Generator`` seed 3
unless given (a reference's converted weights reproduce its rows).

    python -m repro_torch.eval.zero_shot_table [--device cpu]

prints the reference's three CSV lines (name, microseconds to the end of
training, top-1 and chance).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import interop
from repro_torch.configs import get_arch, smoke_dual_variant
from repro_torch.core.gradaccum import contrastive_step
from repro_torch.data import (classification_prompts, contrastive_batch,
                              load_tokenizer, render_images, world_for_tower)
from repro_torch.device import resolve_device
from repro_torch.models import dual_encoder as de
from repro_torch.optim import AdaFactorW, apply_updates
from repro_torch.tree import tree_map

CHANCE = 0.042     # the reference's printed chance level (1/24)


def tiny_dual_cfg(embed_dim: int = 32):
    """The smoke-size BASIC-S dual encoder of the table (a copy of
    ``benchmarks/common.py:tiny_dual_cfg``)."""
    return smoke_dual_variant(get_arch("basic-s"), embed_dim=embed_dim)


def world_and_tok(cfg, seed: int = 0, n_classes: int = 16,
                  noise: float = 0.25):
    """The table's world for a dual config, the committed v1 tokenizer and
    the world's rng (a copy of ``benchmarks/common.py:world_and_tok``)."""
    rng = np.random.default_rng(seed)
    world = world_for_tower(rng, cfg.image_tower, n_classes=n_classes,
                            noise=noise)
    return world, load_tokenizer(), rng


def run(device=None, *, steps: int = 80, attn: str = "pallas",
        params=None) -> dict:
    """Train and evaluate; returns ``{'seen', 'unseen_openvocab',
    'shifted_robustness'}`` top-1 accuracies and ``'us'``, the
    microseconds to the end of training. The towers run in f32, as the
    reference's; ``attn`` is their backend ('pallas': the flash kernels on
    the card). ``params`` replaces the seed-3 weights (not changed in
    place)."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    cfg = tiny_dual_cfg()
    cfg = dataclasses.replace(
        cfg, image_tower=dataclasses.replace(cfg.image_tower, attn_impl=attn),
        text_tower=dataclasses.replace(cfg.text_tower, attn_impl=attn))
    world, tok, _ = world_and_tok(cfg, n_classes=24)
    seen = np.arange(16)
    unseen = np.arange(16, 24)

    if params is None:
        params = interop.init_params(cfg, torch.Generator().manual_seed(3),
                                     dev)
    else:
        params = tree_map(lambda t: t.detach().to(dev, copy=True), params)
    opt = AdaFactorW()
    st = opt.init(params)

    def enc_i(p, im):
        return de.encode_image(cfg, p, im, precision="f32")

    def enc_t(p, tx):
        return de.encode_text(cfg, p, tx, precision="f32")

    def on_dev(tree):
        return tree_map(lambda a: torch.from_numpy(a).to(dev), tree)

    rng = np.random.default_rng(11)
    for _ in range(steps):
        batch, _ = contrastive_batch(world, tok, 32, rng, classes=seen)
        _, _, g = contrastive_step(enc_i, enc_t, params, on_dev(batch), 2)
        up, st = opt.update(g, st, params, 2e-3)
        params = apply_updates(params, up)

    with torch.no_grad():
        temb = enc_t(params, on_dev(classification_prompts(world, tok)))

    def acc_on(cls_pool, noise_mult=1.0):
        cls = cls_pool[rng.integers(0, len(cls_pool), 128)]
        old = world.noise
        world.noise = old * noise_mult
        try:
            imgs = render_images(world, cls, rng)
        finally:
            world.noise = old
        with torch.no_grad():
            iemb = enc_i(params, on_dev({"image": imgs}))
        pred = torch.argmax(iemb @ temb.T, dim=1).cpu().numpy()
        return float(np.mean(pred == cls))

    us = (time.perf_counter() - t0) * 1e6
    return {"seen": acc_on(seen), "unseen_openvocab": acc_on(unseen),
            "shifted_robustness": acc_on(seen, 2.0), "us": us}


def csv_lines(rows: dict) -> list:
    """The reference's three CSV lines for ``run``'s rows."""
    return [f"zeroshot/{name},{rows['us']:.1f},top1={rows[name]:.3f};"
            f"chance={CHANCE}"
            for name in ("seen", "unseen_openvocab", "shifted_robustness")]


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Parse ``argv``, run the table, print its CSV lines."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)
    rows = run(args.device)
    for line in csv_lines(rows):
        print(line, flush=True)
    return rows


if __name__ == "__main__":
    main()
