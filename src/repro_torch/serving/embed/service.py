"""ZeroShotService: the public zero-shot inference API (port of
``repro/serving/embed/service.py``, DESIGN.md §6, §13, §14.3).

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

One flag, ``retrieval``, selects how the top-k sweep runs:

  "fused"     the fused kernel on the service's device (default),
  "sharded"   the exact device-sharded sweep: rows split over ``mesh`` (a
              sequence of devices; default every card, or the service's
              device on the CPU), per-shard kernels and a top-k-of-top-k
              merge, the same answer as "fused" bit for bit
              (``serving/retrieval/sharded.py``),
  "twostage"  coarse centroid prune, then an exact rerank; the class
              matrix's index is cached through the registry under the
              matrix's key and version, so a refresh invalidates it.
              ``nprobe`` trades recall for latency; ``nprobe="all"`` is
              exact.

The service runs on the card unless it is given ``device="cpu"``; with no
card and no CPU request it raises. Class matrices and galleries are
prepared once per artifact (put on the device, sharded, or indexed), so a
repeated call uploads nothing. ``latency_slo_s`` arms an SLO tracker over
every ``classify`` / ``retrieve`` call's wall time (``serve/slo_*``), and
``serve_metrics()`` serves ``/metrics``, ``/healthz`` and
``/snapshot.json`` live.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch import interop
from repro_torch.configs.dual import DualEncoderConfig
from repro_torch.device import resolve_device
from repro_torch.eval.zero_shot import DEFAULT_TEMPLATES, class_embeddings
from repro_torch.kernels.similarity_topk import ops as topk_ops
from repro_torch.models import dual_encoder as de
from repro_torch.obs import export as obs_export
from repro_torch.obs import health as obs_health
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serving import retrieval as rtv
from repro_torch.serving.embed.batcher import DEFAULT_BUCKETS, MicroBatcher
from repro_torch.serving.embed.registry import (ClassEmbeddingRegistry,
                                                checkpoint_fingerprint)

RETRIEVAL_MODES = ("fused", "sharded", "twostage")


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
    """A gallery prepared for the service's retrieval mode once (on the
    device, sharded for "sharded", centroid-indexed for "twostage"), so
    every ``retrieve`` against it uploads nothing and builds no index.
    Obtain via ``ZeroShotService.prepare_gallery``."""
    data: object                       # tensor (n, D) | ShardedMatrix
    n: int                             # gallery rows
    mode: str                          # retrieval mode it was prepared for
    index: Optional[rtv.CentroidIndex] = None   # "twostage" only


class ZeroShotService:
    """Zero-shot inference front door: micro-batched embedding
    (MicroBatcher) + memoised class matrices (ClassEmbeddingRegistry) + the
    similarity→top-k sweep ``retrieval`` selects, behind ``classify`` /
    ``embed_images`` / ``embed_texts`` / ``retrieve``. A context manager
    (stops the batcher on exit).

    ``params`` is the port's parameter dict (``interop.init_params`` or
    ``interop.from_numpy`` of a reference checkpoint); it is moved to
    ``device`` if it lies elsewhere. ``precision`` is a policy name
    ('f32' | 'bf16' | 'bf16_pure'). The towers' attention backend is each
    tower config's ``attn_impl``. ``registry_dir``: where the registry
    persists class matrices, in the reference's layout (None: memory only).

    retrieval: "fused" | "sharded" | "twostage" (module docstring). mesh:
    the devices of "sharded". nprobe: "twostage" blocks probed per query
    (None ≡ "all" ≡ exact). index_blocks: centroid count (default
    ≈ √n).
    All modes share one metrics registry (``self.metrics``, also fed by
    the batcher) and one tracer. ``latency_slo_s`` arms an ``SLOTracker``
    (windowed p99 against the target, error-budget burn, readiness) over
    every ``classify`` / ``retrieve`` call, with ``slo_objective`` and
    ``slo_window``.
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
                 retrieval: str = "fused",
                 mesh=None,
                 nprobe: Union[int, str, None] = None,
                 index_blocks: Optional[int] = None,
                 tracer: Optional[obs_trace.Tracer] = None,
                 autostart: bool = True,
                 latency_slo_s: Optional[float] = None,
                 slo_objective: float = 0.99,
                 slo_window: int = 256):
        if retrieval not in RETRIEVAL_MODES:
            raise ValueError(f"retrieval={retrieval!r} not in "
                             f"{RETRIEVAL_MODES}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = interop.to_device(params, self.device)
        self.tok = tok
        self.templates = tuple(templates)
        self.text_len = int(text_len)
        self.precision = precision
        self.retrieval = retrieval
        if mesh is None and retrieval == "sharded":
            mesh = (rtv.default_data_mesh() if self.device.type == "cuda"
                    else (self.device,))
        self.mesh = mesh
        self.nprobe = nprobe
        self.index_blocks = index_blocks
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
        self._cm_device: dict = {}       # (key, version, mode) -> prepared
        self._gallery_memo = collections.OrderedDict()  # id -> (ref, handle)
        self._gallery_memo_cap = 4
        self.slo = None
        if latency_slo_s is not None:
            self.slo = obs_health.SLOTracker(
                target_s=float(latency_slo_s), objective=slo_objective,
                window=slo_window, registry=self.metrics, name="serve")

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
        t_req = time.perf_counter()
        try:
            with obs_trace.span(self.tracer, "serve/classify",
                                n_classes=len(class_names), k=k,
                                mode=self.retrieval):
                iemb_fut = self.embed_images(images, wait=False)
                cm = self.registry.get(class_names, templates,
                                       self.checkpoint_tag,
                                       embed_dim=self.cfg.embed_dim)
                data = self._class_data(cm)
                index = self.registry.get_centroid_index(
                    cm, n_blocks=self.index_blocks, device=self.device) \
                    if self.retrieval == "twostage" else None
                iemb = self._result(iemb_fut)
                vals, idx = self._topk(iemb, data, len(class_names),
                                       min(k, len(class_names)),
                                       inv_tau=self.inv_tau, index=index)
        finally:
            if self.slo is not None:
                self.slo.observe(time.perf_counter() - t_req)
        return ClassifyResult(vals, idx, class_names, cm.version)

    # -- retrieval ---------------------------------------------------------
    def prepare_gallery(self, gallery_emb) -> GalleryHandle:
        """Prepare ``gallery_emb`` (m, D; numpy, or a tensor on any device)
        for the service's retrieval mode once: on the device ("fused"),
        sharded over the mesh ("sharded"), or on the device with its
        centroid index ("twostage"). Repeated ``retrieve`` calls against
        the handle move no gallery rows and build no index."""
        n = int(np.shape(gallery_emb)[0])
        mode = self.retrieval
        self.metrics.counter("serve/gallery_uploads").inc()
        with obs_trace.span(self.tracer, "serve/prepare_gallery", n=n,
                            mode=mode):
            index = None
            if mode == "sharded":
                data = rtv.shard_matrix(gallery_emb, self.mesh)
            else:
                data = self._on_device(gallery_emb)
                if mode == "twostage":
                    index = rtv.build_centroid_index(
                        data, n_blocks=self.index_blocks)
        return GalleryHandle(data, n, mode, index)

    def _on_device(self, matrix) -> torch.Tensor:
        """``matrix`` (numpy as fp32, or a tensor) on the service's device,
        contiguous (no copy when it is there already)."""
        if not isinstance(matrix, torch.Tensor):
            matrix = torch.from_numpy(np.asarray(matrix, np.float32))
        return matrix.to(self.device).contiguous()

    def retrieve(self, queries: Sequence[str], gallery, *, k: int = 5,
                 nprobe: Union[int, str, None] = None):
        """Text→gallery retrieval: top-k gallery rows per query by cosine
        similarity. gallery: a ``GalleryHandle`` from ``prepare_gallery``,
        or a raw (m, D) unit-norm array (prepared on first sight, memoised
        by object identity). Returns (values (q, k), indices (q, k)); k is
        clamped to the gallery size. ``nprobe`` overrides the service's
        for this call ("twostage")."""
        k = int(k)
        if k < 1:
            raise ValueError(f"k={k} must be >= 1")
        handle = gallery if isinstance(gallery, GalleryHandle) \
            else self._memo_gallery(gallery)
        if handle.mode != self.retrieval:
            raise ValueError(f"gallery prepared for mode {handle.mode!r}; "
                             f"service runs {self.retrieval!r}: call "
                             f"prepare_gallery again")
        t_req = time.perf_counter()
        try:
            with obs_trace.span(self.tracer, "serve/retrieve", n=handle.n,
                                k=k, mode=self.retrieval):
                qemb = self.embed_texts(list(queries))
                return self._topk(qemb, handle.data, handle.n,
                                  min(k, handle.n), inv_tau=1.0,
                                  index=handle.index, nprobe=nprobe)
        finally:
            if self.slo is not None:
                self.slo.observe(time.perf_counter() - t_req)

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
    def _topk(self, q, data, n: int, k: int, *, inv_tau: float, index=None,
              nprobe=None):
        """The (b, k) sweep of the retrieval mode, recording the serving
        telemetry: ``serve/retrieval_latency_s`` (total, and per stage for
        "twostage"), ``serve/retrieval_prune_ratio`` ("twostage":
        candidates / n) and ``serve/retrieval_shard_share`` ("sharded": the
        largest shard's share of the winners; 1/S balanced, 1 one hot
        shard). Returns host (values, indices)."""
        mode = self.retrieval
        t0 = time.perf_counter()
        with obs_trace.span(self.tracer, f"serve/topk_{mode}", n=n, k=k):
            qt = torch.as_tensor(np.asarray(q, np.float32),
                                 device=self.device)
            if mode == "sharded":
                vals, idx = rtv.sharded_similarity_topk(qt, data, k,
                                                        inv_tau=inv_tau)
                shares = rtv.shard_winner_shares(idx, data)
                self.metrics.histogram(
                    "serve/retrieval_shard_share",
                    buckets=obs_metrics.RATIO_BUCKETS,
                    mode=mode).observe(float(shares.max()))
            elif mode == "twostage":
                vals, idx, info = rtv.two_stage_topk(
                    qt, data, index, k,
                    nprobe=self.nprobe if nprobe is None else nprobe,
                    inv_tau=inv_tau)
                self.metrics.histogram(
                    "serve/retrieval_prune_ratio",
                    buckets=obs_metrics.RATIO_BUCKETS,
                    mode=mode).observe(info["prune_ratio"])
                for stage in ("coarse", "gather", "rerank"):
                    self.metrics.histogram(
                        "serve/retrieval_latency_s", mode=mode,
                        stage=stage).observe(info[f"{stage}_s"])
                if self.tracer is not None:
                    self.tracer.instant("serve/twostage_info", **info)
            else:
                vals, idx = topk_ops.similarity_topk(qt, data, k,
                                                     inv_tau=inv_tau)
            vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
        self.metrics.histogram("serve/retrieval_latency_s", mode=mode,
                               stage="total").observe(
            time.perf_counter() - t0)
        return vals, idx

    def _class_data(self, cm):
        """The mode-shaped copy of a registry artifact (on the device, or
        sharded over the mesh), prepared once per (key, version): a refresh
        re-prepares by construction."""
        ck = (cm.key, cm.version, self.retrieval)
        hit = self._cm_device.get(ck)
        if hit is None:
            if self.retrieval == "sharded":
                hit = rtv.shard_matrix(cm.matrix, self.mesh)
            else:
                hit = self._on_device(cm.matrix)
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
        hit/compute counts, the retrieval mode, ``metrics`` (the shared
        registry snapshot: batcher latency and occupancy and the
        serve/retrieval_* series) and, with an SLO, ``slo`` (its
        status)."""
        out = {"batcher": dict(self.batcher.stats),
               "compiled_shapes": len(self.batcher.compiled_shapes()),
               "registry": dict(self.registry.stats),
               "retrieval_mode": self.retrieval,
               "metrics": self.metrics.snapshot()}
        if self.slo is not None:
            out["slo"] = self.slo.status()
        return out

    def serve_metrics(self, *, port: int = 0,
                      host: str = "127.0.0.1") -> obs_export.MetricsServer:
        """Start a live HTTP endpoint over this service's registry:
        ``/metrics`` (Prometheus), ``/healthz`` (SLO readiness when a
        ``latency_slo_s`` was set: 503 while the error budget is
        exhausted), ``/snapshot.json``. Localhost-only by default; the
        caller owns the returned server (``stop()`` it)."""
        return obs_export.MetricsServer(
            self.metrics,
            health=self.slo.status if self.slo is not None else None,
            host=host, port=port).start()

    def close(self):
        """Stop the micro-batcher."""
        self.batcher.stop()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
