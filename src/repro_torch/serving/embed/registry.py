"""Class-embedding registry (port of ``repro/serving/embed/registry.py:32-150``).

Deployment of a zero-shot classifier hinges on computing the
prompt-ensembled class matrix once per label space and amortising it over
every classify call. The registry memoises unit-normalised class matrices
keyed on ``(class_names, templates, checkpoint)``: the checkpoint
fingerprint is in the key, so new weights or a retrained tokenizer
invalidate every matrix computed under the old ones by construction.

``refresh()`` recomputes under the same key with version + 1, and the
version travels with the matrix. Persistence to disk waits for the port of
the checkpoint I/O; until then the registry keeps its matrices in memory,
as the reference does without a ``cache_dir``.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch import interop


def params_fingerprint(params) -> str:
    """Checkpoint identity: sha256 over every leaf's path, dtype, shape and
    bytes. Two parameter sets that classify differently fingerprint
    differently; serving start-up pays the one-time hash."""
    h = hashlib.sha256()
    for path, leaf in interop.leaves(params):
        arr = leaf.detach().cpu().numpy() if isinstance(leaf, torch.Tensor) \
            else np.asarray(leaf)
        h.update(str((path, arr.dtype.str, arr.shape)).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def checkpoint_fingerprint(params, tok=None) -> str:
    """The registry's checkpoint tag: the params fingerprint plus the
    tokenizer's version and content hash (class matrices are computed from
    tokenised prompts, so a retrained vocab changes them under identical
    weights)."""
    tag = params_fingerprint(params)
    if tok is not None and hasattr(tok, "content_hash"):
        tag += f":tok-{getattr(tok, 'version', 'unversioned')}" \
               f"-{tok.content_hash()}"
    return tag


@dataclasses.dataclass(frozen=True)
class ClassMatrix:
    """A registry artifact: one prompt-ensembled class-embedding matrix
    plus its provenance."""
    key: str            # full registry key (sha256 hex)
    version: int        # artifact version under this key
    matrix: np.ndarray  # (n_classes, D) unit-norm fp32
    source: str         # "memory" | "computed"


class ClassEmbeddingRegistry:
    """Memoised prompt-ensembled class matrices.

    compute_fn(class_names, templates) -> (n, D) array or tensor; the
    service passes its batched text encode + ensembling
    (``eval.zero_shot.class_embeddings``).
    """

    def __init__(self, compute_fn: Optional[Callable] = None):
        self._compute = compute_fn
        self._mem: dict = {}
        self.stats = {"mem_hits": 0, "computes": 0}

    @staticmethod
    def key(class_names: Sequence[str], templates: Sequence[str],
            checkpoint_tag: str) -> str:
        """sha256 over the label space, the templates and the checkpoint
        tag (the reference's key scheme)."""
        h = hashlib.sha256()
        for part in ("classes", *class_names, "templates", *templates,
                     "ckpt", checkpoint_tag):
            h.update(part.encode())
            h.update(b"\x00")
        return h.hexdigest()

    def get(self, class_names: Sequence[str], templates: Sequence[str],
            checkpoint_tag: str, *, embed_dim: int) -> ClassMatrix:
        """Memory, else compute (version 1)."""
        key = self.key(class_names, templates, checkpoint_tag)
        hit = self._mem.get(key)
        if hit is not None:
            self.stats["mem_hits"] += 1
            return dataclasses.replace(hit, source="memory")
        return self._compute_and_store(key, class_names, templates,
                                       embed_dim, 1)

    def refresh(self, class_names: Sequence[str], templates: Sequence[str],
                checkpoint_tag: str, *, embed_dim: int) -> ClassMatrix:
        """Force a recompute under the same key, bumping the version."""
        key = self.key(class_names, templates, checkpoint_tag)
        latest = self._mem[key].version if key in self._mem else 0
        return self._compute_and_store(key, class_names, templates,
                                       embed_dim, latest + 1)

    def _compute_and_store(self, key, class_names, templates, embed_dim,
                           version) -> ClassMatrix:
        if self._compute is None:
            raise RuntimeError(
                f"registry miss for key {key[:16]} and no compute_fn given")
        matrix = self._compute(class_names, templates)
        if isinstance(matrix, torch.Tensor):
            matrix = matrix.detach().cpu().numpy()
        matrix = np.asarray(matrix, np.float32)
        if matrix.shape != (len(class_names), embed_dim):
            raise ValueError(f"compute_fn returned {matrix.shape} for "
                             f"{len(class_names)} classes of width "
                             f"{embed_dim}")
        self.stats["computes"] += 1
        cm = ClassMatrix(key, version, matrix, "computed")
        self._mem[key] = cm
        return cm
