"""Zero-shot evaluation machinery (port of ``repro/eval/zero_shot.py``: the
prompt-ensembled class matrix and the numpy metric helpers).

  - Prompt ensembling: each class is rendered through several templates;
    the class embedding is the normalised mean of its prompt embeddings
    (Radford et al. §3.1.4, used by BASIC).
  - top-k accuracy, mean per-class recall, and paired retrieval
    recall@K, all on host numpy arrays.

``classify``, ``evaluate_benchmark`` and ``evaluate_with_service`` wait for
a later slice of the port.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

DEFAULT_TEMPLATES = (
    "a photo of a {} {}",
    "a picture showing a {} {}",
    "the {} {}",
    "one {} {}, outdoors",
)


def class_embeddings(encode_text: Callable, tok, class_names: Sequence[str],
                     templates: Sequence[str] = DEFAULT_TEMPLATES,
                     text_len: int = 16,
                     chunk_size: int = 512) -> torch.Tensor:
    """Prompt-ensembled class embeddings: (n_classes, D) fp32, unit norm.

    All classes × templates are tokenised up front and encoded in chunks of
    ``chunk_size`` prompts (rounded down to whole classes).
    ``encode_text`` takes a payload ``{'tokens', 'attn_mask'}`` of numpy
    arrays and returns (m, D) embeddings (numpy or a tensor); the result
    lies where those embeddings do (the CPU for numpy)."""
    n_t = len(templates)
    ids = []
    for name in class_names:
        parts = name.split(" ", 1)
        ids.extend(tok.encode(t.format(*parts), max_len=text_len)
                   for t in templates)
    tokens, mask = tok.pad_batch(ids, max_len=text_len)
    chunk = max(n_t, chunk_size // n_t * n_t)
    embs = [torch.as_tensor(encode_text({"tokens": tokens[s:s + chunk],
                                         "attn_mask": mask[s:s + chunk]}))
            for s in range(0, len(ids), chunk)]
    emb = torch.cat(embs, dim=0).float()
    mean = torch.mean(emb.reshape(len(class_names), n_t, -1), dim=1)
    norm = torch.clamp(torch.linalg.vector_norm(mean, dim=1, keepdim=True),
                       min=1e-6)
    return mean / norm


def topk_accuracy(logits, labels, k: int = 1) -> float:
    """Share of rows whose label is among the row's k largest logits."""
    logits = np.asarray(logits)
    labels = np.asarray(labels)
    k = min(k, logits.shape[1])
    top = np.argpartition(-logits, k - 1, axis=1)[:, :k]
    return float(np.mean(np.any(top == labels[:, None], axis=1)))


def mean_per_class_recall(logits, labels) -> float:
    """Mean over classes of the share of that class's rows predicted
    right (the paper's metric for Caltech/Flowers/Pets, App. C)."""
    pred = np.argmax(np.asarray(logits), axis=1)
    labels = np.asarray(labels)
    recalls = [float(np.mean(pred[labels == c] == c))
               for c in np.unique(labels)]
    return float(np.mean(recalls))


def retrieval_recall_at_k(x_emb, y_emb, ks=(1, 5)) -> dict:
    """Paired retrieval: row i's positive is column i (both directions).
    The positive's rank is the count of strictly better candidates in its
    row (exact ties rank optimistically)."""
    sim = np.asarray(x_emb) @ np.asarray(y_emb).T
    out = {}
    for name, mat in (("i2t", sim), ("t2i", sim.T)):
        pos = np.diagonal(mat)
        ranks = np.sum(mat > pos[:, None], axis=1)
        for k in ks:
            out[f"{name}@{k}"] = float(np.mean(ranks < k))
    return out
