"""End-to-end example on the PyTorch port: the BASIC three-phase recipe
(paper §8) on the synthetic ALIGN+JFT analog, the counterpart of
``examples/contrastive_pretrain.py``.

  PYTHONPATH=src python examples/contrastive_pretrain_torch.py [--steps 80]
      [--batch 32] [--device cpu] [trainer options, e.g. --precision f32]

Phase 1 pretrains the image tower with a linear head; phase 2 trains the
text tower contrastively against the frozen image tower; phase 3 trains
both at lr 5e-4 for max(10, steps // 4) steps. It runs on the card unless
given ``--device cpu``; options it does not know go to the trainer's
command line (``repro_torch.launch.train``).
"""
import argparse
import sys

from repro_torch.launch.train import parse_args, run_contrastive, \
    run_pretrain


def main(argv=None):
    """Run the three phases; returns phase 3's report."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--batch", type=int, default=32)
    args_in, rest = ap.parse_known_args(argv)
    args = parse_args(["--mode", "pretrain", "--arch", "basic-s", "--smoke",
                       "--steps", str(args_in.steps),
                       "--batch", str(args_in.batch), "--micro", "4",
                       "--classes", "16", "--lr", "2e-3", "--seed", "0",
                       "--log-every", "20", *rest])

    print("=== phase 1: supervised image-tower pretraining (JFT analog) ===")
    pre = run_pretrain(args)

    print("=== phase 2: frozen-image contrastive (text tower only) ===")
    params = run_contrastive(args, image_tower_init=pre["params"]["tower"],
                             train_image=False)["params"]

    print("=== phase 3: joint finetune at reduced LR ===")
    args.lr = 5e-4
    args.steps = max(10, args_in.steps // 4)
    rep = run_contrastive(args, image_tower_init=params["image"]["tower"],
                          train_image=True)
    print("done; see repro_torch/launch/train.py for the command line")
    return rep


if __name__ == "__main__":
    main(sys.argv[1:])
