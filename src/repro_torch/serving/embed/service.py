"""ZeroShotService: the public zero-shot inference API (port of
``repro/serving/embed/service.py``, its ``retrieval="fused"`` mode).

Ties the embedding subsystem together over a BASIC dual encoder:

  classify(images, class_names)  image tower via the micro-batcher, class
      matrix via the registry (computed once per label space and
      checkpoint, and read back from ``registry_dir`` when a process
      before this one put it there), then the fused similarity→top-k kernel over the class
      axis with the learned temperature: the (b, n_classes) logit matrix
      never exists.
  embed_images / embed_texts     unit-norm embeddings, micro-batched.
  retrieve(queries, gallery)     text→gallery top-k on the same kernel
      (inv_tau = 1: no temperature sharpening).

The service runs on the card unless it is given ``device="cpu"``; with no
card and no CPU request it raises. Class matrices and galleries are put on
the device once per artifact. The reference's ``sharded`` and
``twostage`` sweeps, its SLO tracker and its live metrics endpoint wait
for later slices of the port.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import interop
from repro_torch.configs.dual import DualEncoderConfig
from repro_torch.device import resolve_device
from repro_torch.eval.zero_shot import DEFAULT_TEMPLATES, class_embeddings
from repro_torch.kernels.similarity_topk import ops as topk_ops
from repro_torch.models import dual_encoder as de
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serving.embed.batcher import DEFAULT_BUCKETS, MicroBatcher
from repro_torch.serving.embed.registry import (ClassEmbeddingRegistry,
                                                checkpoint_fingerprint)


@dataclasses.dataclass(frozen=True)
class ClassifyResult:
    """Top-k classification output of ``ZeroShotService.classify``."""
    values: np.ndarray        # (b, k) fp32 similarity/temperature logits
    indices: np.ndarray       # (b, k) int32 class ids, ties to lower id
    class_names: tuple        # the label space, for decoding
    version: int              # registry artifact version that classified

    def top_names(self, row: int):
        """Class-name strings of row ``row``'s top-k, best first."""
        return [self.class_names[i] for i in self.indices[row]]


@dataclasses.dataclass(frozen=True)
class GalleryHandle:
    """A gallery put on the service's device once, so every ``retrieve``
    against it uploads nothing. Obtain via
    ``ZeroShotService.prepare_gallery``."""
    data: torch.Tensor                 # (n, D) on the service's device
    n: int                             # gallery rows


class ZeroShotService:
    """Zero-shot inference front door: micro-batched embedding
    (MicroBatcher) + memoised class matrices (ClassEmbeddingRegistry) + the
    fused similarity→top-k kernel, behind ``classify`` / ``embed_images`` /
    ``embed_texts`` / ``retrieve``. A context manager (stops the batcher on
    exit).

    ``params`` is the port's parameter dict (``interop.init_params`` or
    ``interop.from_numpy`` of a reference checkpoint); it is moved to
    ``device`` if it lies elsewhere. ``precision`` is a policy name
    ('f32' | 'bf16' | 'bf16_pure'). The towers' attention backend is each
    tower config's ``attn_impl``. ``registry_dir``: where the registry
    persists class matrices, in the reference's layout (None: memory only).
    """

    def __init__(self, cfg: DualEncoderConfig, params, tok, *,
                 templates: Sequence[str] = DEFAULT_TEMPLATES,
                 text_len: int = 16,
                 registry_dir: Optional[str] = None,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 max_delay_ms: float = 2.0,
                 request_timeout_s: float = 60.0,
                 precision="f32",
                 device=None,
                 tracer: Optional[obs_trace.Tracer] = None,
                 autostart: bool = True):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = interop.to_device(params, self.device)
        self.tok = tok
        self.templates = tuple(templates)
        self.text_len = int(text_len)
        self.precision = precision
        # params fingerprint + tokenizer artifact hash: new weights or a
        # retrained vocab both invalidate cached class matrices
        self.checkpoint_tag = checkpoint_fingerprint(self.params, tok)
        # 1/tau from the learned log-temperature (paper §3: A = X·Yᵀ/tau)
        self.inv_tau = float(torch.exp(-self.params["log_tau"]))

        self.metrics = obs_metrics.Registry()
        self.tracer = tracer if tracer is not None else obs_trace.Tracer()
        self.batcher = MicroBatcher(
            {"image": self._encode_images, "text": self._encode_texts},
            buckets=buckets, max_delay_ms=max_delay_ms,
            request_timeout_s=request_timeout_s, autostart=autostart,
            registry=self.metrics)
        self.registry = ClassEmbeddingRegistry(self._compute_class_matrix,
                                               cache_dir=registry_dir)
        self._cm_device: dict = {}       # (key, version) -> device matrix
        self._gallery_memo = collections.OrderedDict()  # id -> (ref, handle)
        self._gallery_memo_cap = 4

    # -- the towers, as the batcher calls them -----------------------------
    def _encode_images(self, payload) -> torch.Tensor:
        with torch.inference_mode():
            images = torch.from_numpy(payload["image"]).to(self.device)
            return de.encode_image(self.cfg, self.params, {"image": images},
                                   precision=self.precision)

    def _encode_texts(self, payload) -> torch.Tensor:
        with torch.inference_mode():
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in payload.items()}
            return de.encode_text(self.cfg, self.params, batch,
                                  precision=self.precision)

    # -- embedding ---------------------------------------------------------
    def embed_images(self, images, *, wait: bool = True):
        """images: raw (b, H, W, C) pixels matching the image tower's
        geometry (or a payload {'image': ...}). Returns (b, D) unit-norm
        fp32 numpy, or the future when wait=False."""
        payload = images if isinstance(images, dict) else \
            {"image": np.asarray(images, np.float32)}
        fut = self.batcher.submit_many("image", payload)
        return self._result(fut) if wait else fut

    def embed_texts(self, texts, *, wait: bool = True):
        """texts: list of strings (tokenised here) or a pre-tokenised
        {'tokens', 'attn_mask'} payload. Returns (b, D), or the future."""
        if not isinstance(texts, dict):
            ids = [self.tok.encode(t, max_len=self.text_len) for t in texts]
            tokens, mask = self.tok.pad_batch(ids, max_len=self.text_len)
            texts = {"tokens": tokens, "attn_mask": mask}
        fut = self.batcher.submit_many("text", texts)
        return self._result(fut) if wait else fut

    def _result(self, fut):
        if not self.batcher.running:
            self.batcher.flush_now()   # thread-free (autostart=False) path
        # the per-request deadline bounds the wait
        return np.asarray(fut.result(timeout=self.batcher.request_timeout))

    # -- classification ----------------------------------------------------
    def classify(self, images, class_names: Sequence[str], *,
                 templates: Optional[Sequence[str]] = None,
                 k: int = 5) -> ClassifyResult:
        """Top-k classes of each image among ``class_names`` (k clamped to
        the label space), values descending, ties to the lower class id."""
        k = int(k)
        if k < 1:
            raise ValueError(f"k={k} must be >= 1")
        class_names = tuple(class_names)
        templates = tuple(templates) if templates is not None \
            else self.templates
        with obs_trace.span(self.tracer, "serve/classify",
                            n_classes=len(class_names), k=k, mode="fused"):
            iemb_fut = self.embed_images(images, wait=False)
            cm = self.registry.get(class_names, templates,
                                   self.checkpoint_tag,
                                   embed_dim=self.cfg.embed_dim)
            data = self._class_data(cm)
            iemb = self._result(iemb_fut)
            vals, idx = self._topk(iemb, data, min(k, len(class_names)),
                                   inv_tau=self.inv_tau)
        return ClassifyResult(vals, idx, class_names, cm.version)

    # -- retrieval ---------------------------------------------------------
    def prepare_gallery(self, gallery_emb) -> GalleryHandle:
        """Put ``gallery_emb`` (m, D) on the device once; repeated
        ``retrieve`` calls against the handle upload nothing."""
        n = int(np.shape(gallery_emb)[0])
        self.metrics.counter("serve/gallery_uploads").inc()
        with obs_trace.span(self.tracer, "serve/prepare_gallery", n=n,
                            mode="fused"):
            data = torch.as_tensor(np.asarray(gallery_emb, np.float32),
                                   device=self.device).contiguous()
        return GalleryHandle(data, n)

    def retrieve(self, queries: Sequence[str], gallery, *, k: int = 5):
        """Text→gallery retrieval: top-k gallery rows per query by cosine
        similarity. gallery: a ``GalleryHandle`` from ``prepare_gallery``,
        or a raw (m, D) unit-norm array (prepared on first sight, memoised
        by object identity). Returns (values (q, k), indices (q, k)); k is
        clamped to the gallery size."""
        k = int(k)
        if k < 1:
            raise ValueError(f"k={k} must be >= 1")
        handle = gallery if isinstance(gallery, GalleryHandle) \
            else self._memo_gallery(gallery)
        with obs_trace.span(self.tracer, "serve/retrieve", n=handle.n, k=k,
                            mode="fused"):
            qemb = self.embed_texts(list(queries))
            return self._topk(qemb, handle.data, min(k, handle.n),
                              inv_tau=1.0)

    def _memo_gallery(self, gallery_emb) -> GalleryHandle:
        """Bounded identity-keyed memo for raw-array galleries (the memo
        holds the reference, so the id stays valid while cached)."""
        key = id(gallery_emb)
        hit = self._gallery_memo.get(key)
        if hit is not None and hit[0] is gallery_emb:
            self._gallery_memo.move_to_end(key)
            self.metrics.counter("serve/gallery_memo_hits").inc()
            return hit[1]
        handle = self.prepare_gallery(gallery_emb)
        self._gallery_memo[key] = (gallery_emb, handle)
        while len(self._gallery_memo) > self._gallery_memo_cap:
            self._gallery_memo.popitem(last=False)
        return handle

    # -- the top-k sweep ---------------------------------------------------
    def _topk(self, q, data: torch.Tensor, k: int, *, inv_tau: float):
        """The (b, k) sweep on the fused kernel, timed into
        ``serve/retrieval_latency_s``."""
        t0 = time.perf_counter()
        with obs_trace.span(self.tracer, "serve/topk_fused", n=data.shape[0],
                            k=k):
            qt = torch.as_tensor(np.asarray(q, np.float32),
                                 device=self.device)
            vals, idx = topk_ops.similarity_topk(qt, data, k,
                                                 inv_tau=inv_tau)
            vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
        self.metrics.histogram("serve/retrieval_latency_s", mode="fused",
                               stage="total").observe(
            time.perf_counter() - t0)
        return vals, idx

    def _class_data(self, cm) -> torch.Tensor:
        """The device-resident copy of a registry artifact, put there once
        per (key, version): a refresh re-uploads by construction."""
        ck = (cm.key, cm.version)
        hit = self._cm_device.get(ck)
        if hit is None:
            hit = torch.as_tensor(cm.matrix, device=self.device).contiguous()
            self._cm_device[ck] = hit
        return hit

    # -- internals ---------------------------------------------------------
    def _compute_class_matrix(self, class_names, templates):
        """Registry compute path: batched prompt ensembling through the
        text tower, via the same ``eval.zero_shot.class_embeddings`` the
        offline eval uses."""
        def encode(texts):
            fut = self.batcher.submit_many("text", texts)
            if not self.batcher.running:
                self.batcher.flush_now()
            return fut.result(timeout=self.batcher.request_timeout)
        return class_embeddings(encode, self.tok, class_names, templates,
                                text_len=self.text_len)

    def stats(self) -> dict:
        """Service-wide stats: the batcher's counters, the registry's
        hit/compute counts, and ``metrics``, the shared registry
        snapshot."""
        return {"batcher": dict(self.batcher.stats),
                "compiled_shapes": len(self.batcher.compiled_shapes()),
                "registry": dict(self.registry.stats),
                "retrieval_mode": "fused",
                "metrics": self.metrics.snapshot()}

    def close(self):
        """Stop the micro-batcher."""
        self.batcher.stop()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
