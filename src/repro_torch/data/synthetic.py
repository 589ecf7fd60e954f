"""Synthetic open-vocabulary image world (copy of the ``World`` part of
``repro/data/synthetic.py``).

Concepts are unit vectors in a latent space, one per adjective-noun class
name. Images are raw pixels: per patch, the concept vector plus noise goes
through a fixed random "camera" map into ``patch_size²·C`` pixel values, and
the patch grid is assembled into the image, the inverse of the model's
patchify frontend. Everything is numpy, drawn from a caller's
``np.random.Generator``, so the reference and the port see the same bytes.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

ADJECTIVES = ["red", "blue", "green", "small", "large", "striped", "spotted",
              "shiny", "old", "young", "wild", "fluffy", "sleek", "bright"]
NOUNS = ["cat", "dog", "bird", "fish", "tree", "car", "boat", "house",
         "flower", "horse", "plane", "train", "apple", "chair", "clock",
         "river", "mountain", "beetle", "lamp", "guitar", "violin", "drum",
         "bridge", "tower", "island", "lizard", "rabbit", "wolf", "bear",
         "eagle", "shark", "whale", "rose", "oak", "pine", "truck", "bicycle",
         "kettle", "mirror", "ladder"]


@dataclasses.dataclass
class World:
    """Latent concept vectors, the camera map that renders them to pixels,
    the class-name strings, and the image geometry every render matches."""
    concept_vecs: np.ndarray      # (n_classes, k)
    camera: np.ndarray            # (k, patch_size²·channels)
    class_names: List[str]
    image_size: int
    patch_size: int
    channels: int = 3
    noise: float = 0.35

    @property
    def n_classes(self):
        """Number of concepts (classes)."""
        return self.concept_vecs.shape[0]

    @property
    def n_patches(self):
        """Patches per image: (image_size // patch_size)²."""
        return (self.image_size // self.patch_size) ** 2


def make_world(rng: np.random.Generator, n_classes=64, latent=32,
               image_size=16, patch_size=4, channels=3,
               noise=0.35) -> World:
    """Compositional concepts: class 'red cat' = v(red) + v(cat) in the
    latent space, normalised."""
    adj_vecs = rng.standard_normal((len(ADJECTIVES), latent))
    noun_vecs = rng.standard_normal((len(NOUNS), latent))
    names, vecs = [], []
    for i in range(n_classes):
        ai = (i * 5 + i // len(ADJECTIVES)) % len(ADJECTIVES)
        ni = i % len(NOUNS)
        names.append(f"{ADJECTIVES[ai]} {NOUNS[ni]}")
        vecs.append(adj_vecs[ai] + noun_vecs[ni])
    v = np.stack(vecs)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    pix = patch_size * patch_size * channels
    cam = rng.standard_normal((latent, pix)) / np.sqrt(latent)
    return World(v, cam, names, image_size, patch_size, channels, noise)


def world_for_tower(rng: np.random.Generator, tower, n_classes=64,
                    latent=32, noise=0.35) -> World:
    """A World whose image geometry matches a vision tower config, so its
    renders feed the tower's patchify frontend directly."""
    return make_world(rng, n_classes=n_classes, latent=latent,
                      image_size=tower.image_size,
                      patch_size=tower.patch_size,
                      channels=tower.channels, noise=noise)


def render_images(world: World, cls: np.ndarray, rng: np.random.Generator):
    """cls: (b,) int -> raw images (b, H, W, C) float32: per-patch noisy
    concept latents through the camera map, assembled on the patch grid."""
    b = cls.shape[0]
    g = world.image_size // world.patch_size
    ps, c = world.patch_size, world.channels
    z = world.concept_vecs[cls]
    z = z[:, None, :] + world.noise * rng.standard_normal(
        (b, world.n_patches, z.shape[-1]))
    pix = (z @ world.camera).astype(np.float32)
    pix = pix.reshape(b, g, g, ps, ps, c).transpose(0, 1, 3, 2, 4, 5)
    return np.ascontiguousarray(pix.reshape(b, g * ps, g * ps, c))
