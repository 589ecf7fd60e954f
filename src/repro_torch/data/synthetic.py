"""Synthetic open-vocabulary image-text world (copy of
``repro/data/synthetic.py``).

Concepts are unit vectors in a latent space, one per adjective-noun class
name. Images are raw pixels: per patch, the concept vector plus noise goes
through a fixed random "camera" map into ``patch_size²·C`` pixel values, and
the patch grid is assembled into the image, the inverse of the model's
patchify frontend. Captions are templated alt-text over the class names;
``contrastive_batch`` pairs them with images and ``jft_batch`` gives the
labelled pretraining pairs. Everything is numpy, drawn from a caller's
``np.random.Generator`` in the reference's order, so one seed gives the
reference and the port the same bytes.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

ADJECTIVES = ["red", "blue", "green", "small", "large", "striped", "spotted",
              "shiny", "old", "young", "wild", "fluffy", "sleek", "bright"]
NOUNS = ["cat", "dog", "bird", "fish", "tree", "car", "boat", "house",
         "flower", "horse", "plane", "train", "apple", "chair", "clock",
         "river", "mountain", "beetle", "lamp", "guitar", "violin", "drum",
         "bridge", "tower", "island", "lizard", "rabbit", "wolf", "bear",
         "eagle", "shark", "whale", "rose", "oak", "pine", "truck", "bicycle",
         "kettle", "mirror", "ladder"]
TEMPLATES = ["a photo of a {} {}", "the {} {}", "{} {} in the wild",
             "a picture showing a {} {}", "my {} {}", "one {} {}, outdoors"]


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


def render_captions(world: World, cls: np.ndarray, rng: np.random.Generator,
                    class_names: Optional[List[str]] = None) -> List[str]:
    """Noisy alt-text: one templated caption per class id in ``cls``,
    templates drawn from the grammar."""
    names = class_names or world.class_names
    out = []
    for c in cls:
        t = TEMPLATES[rng.integers(len(TEMPLATES))]
        out.append(t.format(*names[int(c)].split(" ", 1)))
    return out


def caption_corpus(world: World, rng: np.random.Generator, n=2000):
    """``n`` sampled captions over the world's classes."""
    cls = rng.integers(0, world.n_classes, n)
    return render_captions(world, cls, rng)


def grammar_corpus() -> List[str]:
    """Every caption the template grammar can produce (adjective × noun ×
    template, in a fixed order): the corpus behind the committed tokenizer
    artifact."""
    return [t.format(a, n) for a in ADJECTIVES for n in NOUNS
            for t in TEMPLATES]


def contrastive_batch(world: World, tok, batch: int, rng: np.random.Generator,
                      text_len=16, classes: Optional[np.ndarray] = None):
    """Returns ({'images': {'image'}, 'texts': {'tokens', 'attn_mask'}},
    cls): ``batch`` image-caption pairs of random classes (from ``classes``
    when given), as numpy arrays."""
    pool = classes if classes is not None else np.arange(world.n_classes)
    cls = pool[rng.integers(0, len(pool), batch)]
    imgs = render_images(world, cls, rng)
    caps = render_captions(world, cls, rng)
    ids = [tok.encode(c, max_len=text_len) for c in caps]
    tokens, mask = tok.pad_batch(ids, max_len=text_len)
    return ({"images": {"image": imgs},
             "texts": {"tokens": tokens, "attn_mask": mask}}, cls)


def classification_prompts(world: World, tok, text_len=16,
                           template="a photo of a {} {}"):
    """CLIP-style class prompts for zero-shot eval: one prompt per class of
    the world, as a numpy payload {'tokens', 'attn_mask'}."""
    ids = [tok.encode(template.format(*n.split(" ", 1)), max_len=text_len)
           for n in world.class_names]
    tokens, mask = tok.pad_batch(ids, max_len=text_len)
    return {"tokens": tokens, "attn_mask": mask}


def jft_batch(world: World, batch: int, rng: np.random.Generator,
              classes: Optional[np.ndarray] = None):
    """Labelled pretraining pairs (paper §8): ({'image', 'labels'}, cls)."""
    pool = classes if classes is not None else np.arange(world.n_classes)
    cls = pool[rng.integers(0, len(pool), batch)]
    return {"image": render_images(world, cls, rng),
            "labels": cls.astype(np.int32)}, cls
