"""Class-embedding registry (port of ``repro/serving/embed/registry.py:30-150``).

Deployment of a zero-shot classifier hinges on computing the
prompt-ensembled class matrix once per label space and amortising it over
every classify call. The registry memoises unit-normalised class matrices
keyed on ``(class_names, templates, checkpoint)``: the checkpoint
fingerprint is in the key, so new weights or a retrained tokenizer
invalidate every matrix computed under the old ones by construction.

With a ``cache_dir`` the matrices persist through ``checkpoint.io`` in
the reference's layout (``<cache_dir>/<key[:16]>/step_<version>/``), so
serving replicas and evaluation jobs of either package share one on-disk
artifact instead of re-encoding the label space per process. Each key
directory holds versions as checkpoint steps: ``refresh()`` writes
version + 1 and ``get()`` serves the latest; the version travels with the
matrix. The two-stage retrieval's centroid index comes with that retrieval
mode.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpoint import io as ckpt_io
from repro_torch.tree import leaves, treedef_str

# numpy's dtype string of a bf16 leaf under ml_dtypes (2-byte void), which
# the reference hashes; the port hashes the same bits under the same name
_BF16_STR = "<V2"


def params_fingerprint(params) -> str:
    """Checkpoint identity, the reference's: sha256 over the tree's
    structure (JAX's ``str(treedef)``), then per leaf its
    ``(dtype.str, shape)`` and bytes. The same parameters give the same
    fingerprint in either package, so both find one registry artifact; two
    parameter sets that classify differently fingerprint differently."""
    h = hashlib.sha256()
    h.update(treedef_str(params).encode())
    for _, leaf in leaves(params):
        if leaf is None:             # JAX's empty subtree: not a leaf
            continue
        host = ckpt_io.to_host(leaf)
        dtype_str = (_BF16_STR if host.dtype == "bfloat16"
                     else host.array.dtype.str)
        h.update(str((dtype_str, host.array.shape)).encode())
        h.update(host.array.tobytes())
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
    source: str         # "memory" | "disk" | "computed"


class ClassEmbeddingRegistry:
    """Memoised prompt-ensembled class matrices with disk persistence.

    compute_fn(class_names, templates) -> (n, D) array or tensor; the
    service passes its batched text encode + ensembling
    (``eval.zero_shot.class_embeddings``). ``cache_dir``: where matrices
    persist (None keeps them in memory only).
    """

    def __init__(self, compute_fn: Optional[Callable] = None, *,
                 cache_dir: Optional[str] = None):
        self._compute = compute_fn
        self.cache_dir = cache_dir
        self._mem: dict = {}
        self.stats = {"mem_hits": 0, "disk_hits": 0, "computes": 0}

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

    def _key_dir(self, key: str) -> Optional[str]:
        return (os.path.join(self.cache_dir, key[:16])
                if self.cache_dir else None)

    def get(self, class_names: Sequence[str], templates: Sequence[str],
            checkpoint_tag: str, *, embed_dim: int) -> ClassMatrix:
        """Memory, else the latest version on disk, else compute (version
        1, persisted when the registry has a ``cache_dir``)."""
        key = self.key(class_names, templates, checkpoint_tag)
        hit = self._mem.get(key)
        if hit is not None:
            self.stats["mem_hits"] += 1
            return dataclasses.replace(hit, source="memory")
        kdir = self._key_dir(key)
        if kdir is not None:
            version = ckpt_io.latest_step(kdir)
            if version is not None:
                like = {"class_emb": torch.empty(
                    (len(class_names), embed_dim), device="meta")}
                tree = ckpt_io.restore(kdir, version, like, device="cpu")
                cm = ClassMatrix(key, version, tree["class_emb"].numpy(),
                                 "disk")
                self._mem[key] = cm
                self.stats["disk_hits"] += 1
                return cm
        return self._compute_and_store(key, class_names, templates,
                                       embed_dim, 1)

    def refresh(self, class_names: Sequence[str], templates: Sequence[str],
                checkpoint_tag: str, *, embed_dim: int) -> ClassMatrix:
        """Force a recompute under the same key, bumping the version past
        the latest on disk or in memory."""
        key = self.key(class_names, templates, checkpoint_tag)
        kdir = self._key_dir(key)
        latest = ckpt_io.latest_step(kdir) if kdir else None
        if latest is None:
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
        kdir = self._key_dir(key)
        if kdir is not None:
            ckpt_io.save(kdir, version, {"class_emb": matrix})
        cm = ClassMatrix(key, version, matrix, "computed")
        self._mem[key] = cm
        return cm
