"""Host-side image augmentation ops, paper §7.1's crop / flip analog
(copy of ``repro/data/sharded/augment.py``, numpy only).

ALIGN/BASIC train on noisy web pairs with light augmentation; CLIP uses
random-crop only. Here each op is a frozen dataclass acting on a RAW image
batch ``(b, H, W, C)`` float32 with an explicit ``np.random.Generator`` —
no global state — so an augmented batch is a pure function of
``(ops, images, rng)``. The sharded loader derives that rng from the SAME
``(seed, host, step)`` key family as the batch draw (tagged so the two
streams stay disjoint), which gives the two properties the input subsystem
guarantees (DESIGN.md §9):

  determinism  — same (seed, host, step) ⇒ bit-identical augmented batch,
  shard-exactness — augmentation is applied per host block with that
      block's rng, so a multi-host run and a single-process run that
      materializes all blocks produce byte-identical global batches.

Ops are composed with ``apply_ops`` in list order. ``from_names`` rebuilds
a default-parameter pipeline from op names (e.g. a CLI flag); resumable
``LoaderState`` persists full op REPRS so restore validation catches
parameter changes, not just pipeline membership.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class RandomCrop:
    """Random crop/patch jitter: edge-pad by ``pad`` pixels on each side,
    then crop back to the original size at a per-image random offset in
    ``[0, 2·pad]²`` — image content shifts by up to ±pad pixels, the toy
    analog of CLIP's random square crop."""
    pad: int = 2

    name = "random_crop"

    def __call__(self, images: np.ndarray,
                 rng: np.random.Generator) -> np.ndarray:
        """images: (b, H, W, C) -> same shape, per-image jittered."""
        b, hh, ww, _ = images.shape
        p = int(self.pad)
        if p == 0:
            return images
        padded = np.pad(images, ((0, 0), (p, p), (p, p), (0, 0)),
                        mode="edge")
        oy = rng.integers(0, 2 * p + 1, b)
        ox = rng.integers(0, 2 * p + 1, b)
        out = np.empty_like(images)
        for i in range(b):
            out[i] = padded[i, oy[i]:oy[i] + hh, ox[i]:ox[i] + ww]
        return out


@dataclasses.dataclass(frozen=True)
class HorizontalFlip:
    """Mirror each image left-right with probability ``prob``."""
    prob: float = 0.5

    name = "hflip"

    def __call__(self, images: np.ndarray,
                 rng: np.random.Generator) -> np.ndarray:
        """images: (b, H, W, C) -> same shape, a random subset mirrored."""
        flip = rng.random(images.shape[0]) < self.prob
        out = images.copy()
        out[flip] = out[flip, :, ::-1, :]
        return out


@dataclasses.dataclass(frozen=True)
class ChannelNoise:
    """Photometric jitter: per-image-per-channel gain ``1 ± scale`` plus
    i.i.d. gaussian pixel noise of the same scale — the 'noisy alt-text
    pair' analog on the image side."""
    scale: float = 0.05

    name = "channel_noise"

    def __call__(self, images: np.ndarray,
                 rng: np.random.Generator) -> np.ndarray:
        """images: (b, H, W, C) -> same shape, jittered float32."""
        b, _, _, c = images.shape
        gain = 1.0 + self.scale * rng.standard_normal((b, 1, 1, c))
        noise = self.scale * rng.standard_normal(images.shape)
        return (images * gain + noise).astype(images.dtype)


_OPS = {op.name: op for op in (RandomCrop, HorizontalFlip, ChannelNoise)}


def default_augmentations() -> Tuple:
    """The standard train-time pipeline: crop jitter → flip → noise."""
    return (RandomCrop(), HorizontalFlip(), ChannelNoise())


def from_names(names: Sequence[str]) -> Tuple:
    """Rebuild a default-parameter pipeline from persisted op names (the
    inverse of ``[op.name for op in ops]``; unknown names raise)."""
    try:
        return tuple(_OPS[n]() for n in names)
    except KeyError as e:
        raise KeyError(f"unknown augmentation {e.args[0]!r}; "
                       f"have {sorted(_OPS)}") from None


def apply_ops(ops: Sequence, images: np.ndarray,
              rng: np.random.Generator) -> np.ndarray:
    """Run ``ops`` over ``images`` in order with one shared rng stream.
    Empty ``ops`` returns the input unchanged (and un-copied)."""
    for op in ops:
        images = op(images, rng)
    return images
