"""Zero-shot open-vocabulary evaluation (port of
``repro/eval/zero_shot.py``, the paper's §9.2 machinery).

  - Prompt ensembling: each class is rendered through several templates;
    the class embedding is the normalised mean of its prompt embeddings
    (Radford et al. §3.1.4, used by BASIC).
  - ``classify``: argmax of the materialised logits; ``evaluate_benchmark``
    one paper-style benchmark row from it, and ``evaluate_with_service``
    the same row served through a ``ZeroShotService`` (the fused
    similarity→top-k kernel on the card).
  - top-k accuracy, mean per-class recall, and paired retrieval
    recall@K, all on host numpy arrays.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

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


def classify(image_emb, class_emb):
    """Predicted class ids (b,), the first index on a tie, and the full
    (b, n) logit matrix image_emb @ class_embᵀ."""
    logits = torch.as_tensor(image_emb) @ torch.as_tensor(class_emb).T
    return torch.argmax(logits, dim=1), logits


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


def evaluate_benchmark(encode_image: Callable, encode_text: Callable, tok,
                       class_names: Sequence[str], images, labels,
                       templates: Sequence[str] = DEFAULT_TEMPLATES,
                       metric: str = "accuracy") -> dict:
    """One paper-style benchmark row. ``encode_image(images)`` returns (b, D)
    embeddings, ``encode_text`` as in ``class_embeddings``. metric:
    'accuracy' or 'recall' (mean per-class recall, App. C)."""
    cemb = class_embeddings(encode_text, tok, class_names, templates)
    iemb = torch.as_tensor(encode_image(images))
    _, logits = classify(iemb, cemb.to(iemb.device))
    logits = logits.detach().cpu().numpy()
    out = {
        "top1": topk_accuracy(logits, labels, 1),
        "top5": topk_accuracy(logits, labels, 5),
        "mean_per_class_recall": mean_per_class_recall(logits, labels),
        "n": int(np.shape(labels)[0]),
    }
    out["headline"] = out["top1"] if metric == "accuracy" else \
        out["mean_per_class_recall"]
    return out


def evaluate_with_service(service, class_names: Sequence[str], images,
                          labels, templates: Optional[Sequence[str]] = None,
                          metric: str = "accuracy") -> dict:
    """The same benchmark row as ``evaluate_benchmark``, served through a
    ``ZeroShotService``: class embeddings from its registry, image
    embeddings from the micro-batcher, and the metrics from the fused
    similarity→top-k kernel's indices; the (b, n_classes) logit matrix is
    never materialised."""
    labels = np.asarray(labels)
    res = service.classify(images, class_names, templates=templates,
                           k=min(5, len(class_names)))
    idx = np.asarray(res.indices)
    pred = idx[:, 0]
    recalls = [float(np.mean(pred[labels == c] == c))
               for c in np.unique(labels)]
    out = {
        "top1": float(np.mean(pred == labels)),
        "top5": float(np.mean(np.any(idx == labels[:, None], axis=1))),
        "mean_per_class_recall": float(np.mean(recalls)),
        "n": int(labels.shape[0]),
        "class_matrix_version": res.version,
    }
    out["headline"] = out["top1"] if metric == "accuracy" else \
        out["mean_per_class_recall"]
    return out
