"""Zero-shot serving launcher: the port's ZeroShotService under synthetic
traffic (port of ``repro/launch/serve_zeroshot.py``).

  PYTHONPATH=src python -m repro_torch.launch.serve_zeroshot \
      --classes 512 --batch 16 --requests 8 --k 5

Builds a BASIC dual encoder (``basic-s`` at full width by default) with
random weights from ``--seed`` and both towers on the flash-attention
kernel (``attn_impl="pallas"``, the reference's kernel backend),
precomputes the class matrix through the registry (persisted under
``--registry-dir`` when given, so a second launch reads it back and skips
the text tower), then pushes
``--requests`` classify batches of raw synthetic images through the
micro-batcher and the similarity→top-k sweep and reports latency and
throughput. It runs on the card; ``--device cpu`` (with ``--smoke`` for a
size the CPU can take) runs the plain PyTorch path.

``--retrieval`` picks the sweep (``fused``, ``sharded`` over every card,
or ``twostage`` with ``--nprobe`` blocks probed per query, ``all`` being
exact); ``--slo-ms`` arms the SLO tracker (windowed p99 against the
target, error-budget burn, readiness; an ``slo:`` report line) and
``--metrics-port P`` serves ``/metrics``, ``/healthz`` and
``/snapshot.json`` on 127.0.0.1:P (0 picks a free port) for the run.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.configs import get_arch, smoke_dual_variant
from repro_torch.data import load_tokenizer, render_images, world_for_tower
from repro_torch.device import resolve_device
from repro_torch.models import dual_encoder as de
from repro_torch.serving import ZeroShotService


def build(arch: str = "basic-s", *, smoke: bool = False, seed: int = 0,
          device=None):
    """(cfg, params): the dual encoder ``arch`` (its smoke variant with
    ``smoke``), both towers on the flash-attention kernel, weights drawn
    from ``seed`` and put on the device."""
    dev = resolve_device(device)
    cfg = get_arch(arch)
    if smoke:
        cfg = smoke_dual_variant(cfg, embed_dim=64)
    cfg = dataclasses.replace(
        cfg,
        image_tower=dataclasses.replace(cfg.image_tower, attn_impl="pallas"),
        text_tower=dataclasses.replace(cfg.text_tower, attn_impl="pallas"))
    params = de.init_params(cfg, torch.Generator().manual_seed(seed), dev)
    return cfg, params


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cfg, params, tok, *, classes: int = 64, batch: int = 16,
        requests: int = 8, k: int = 5, seed: int = 0, device=None,
        max_delay_ms: float = 2.0, registry_dir: Optional[str] = None,
        retrieval: str = "fused", nprobe: Union[int, str, None] = None,
        latency_slo_s: Optional[float] = None,
        metrics_port: Optional[int] = None) -> dict:
    """Serve ``requests`` classify calls of ``batch`` images over a
    ``classes``-name label space, the class matrix through a registry that
    persists under ``registry_dir`` when given, the sweep by
    ``retrieval`` (and ``nprobe``); with ``latency_slo_s`` an SLO, with
    ``metrics_port`` the live endpoint for the run. Returns the report
    (timings in seconds, the class matrix and where the registry found it,
    the last request's images and result, ``slo`` status or None)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    world = world_for_tower(rng, cfg.image_tower, n_classes=classes)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    with ZeroShotService(cfg, params, tok, device=dev,
                         max_delay_ms=max_delay_ms,
                         registry_dir=registry_dir, retrieval=retrieval,
                         nprobe=nprobe, latency_slo_s=latency_slo_s) as svc:
        server = None
        if metrics_port is not None:
            server = svc.serve_metrics(port=metrics_port)
            print(f"obs: serving /metrics /healthz /snapshot.json on "
                  f"{server.url}")
        t0 = time.perf_counter()
        cm = svc.registry.get(world.class_names, svc.templates,
                              svc.checkpoint_tag, embed_dim=cfg.embed_dim)
        _sync(dev)
        class_matrix_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        svc.classify(render_images(world, rng.integers(0, classes, batch),
                                   rng), world.class_names, k=k)
        first_s = time.perf_counter() - t0

        lat, hits = [], 0
        for _ in range(requests):
            cls = rng.integers(0, classes, batch)
            images = render_images(world, cls, rng)
            t0 = time.perf_counter()
            res = svc.classify(images, world.class_names, k=k)
            lat.append(time.perf_counter() - t0)
            hits += int(np.sum(res.indices[:, 0] == cls))
        stats = svc.stats()
        if server is not None:
            server.stop()
    n = requests * batch
    return {
        "device": str(dev),
        "class_matrix_s": class_matrix_s,
        "first_classify_s": first_s,
        "latencies_s": lat,
        "p50_s": float(np.median(lat)),
        "max_s": float(max(lat)),
        "img_per_s": n / sum(lat),
        "top1": hits / n,
        "chance": 1.0 / classes,
        "max_memory_allocated": (torch.cuda.max_memory_allocated(dev)
                                 if dev.type == "cuda" else None),
        "stats": stats,
        "class_matrix": cm.matrix,
        "class_matrix_source": cm.source,
        "last_images": images,
        "last_result": res,
        "slo": stats.get("slo"),
    }


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Parse flags, serve, print the report; returns it."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="basic-s")
    ap.add_argument("--smoke", action="store_true",
                    help="shrink the towers to test size")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--classes", type=int, default=64)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--registry-dir", default=None,
                    help="persist class matrices here (the reference's "
                         "layout); a later launch reads them back")
    ap.add_argument("--tokenizer", default="v1",
                    help="tokenizer artifact version "
                         "(artifacts/tokenizer_<v>.json)")
    ap.add_argument("--max-delay-ms", type=float, default=2.0)
    ap.add_argument("--retrieval", default="fused",
                    choices=("fused", "sharded", "twostage"),
                    help="top-k sweep: the fused kernel on one device, the "
                         "exact sweep sharded over every card, or coarse→"
                         "fine two-stage")
    ap.add_argument("--nprobe", default=None,
                    help="twostage blocks probed per query (int or 'all' "
                         "= exact; default all)")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="arm the serving SLO tracker: per-request latency "
                         "target in ms (windowed p99 + error-budget burn "
                         "under serve/slo_*)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve live /metrics (Prometheus), /healthz (SLO "
                         "readiness) and /snapshot.json on 127.0.0.1:PORT "
                         "(0 = ephemeral) for the whole run")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    nprobe = None if args.nprobe in (None, "all") else int(args.nprobe)

    cfg, params = build(args.arch, smoke=args.smoke, seed=args.seed,
                        device=args.device)
    rep = run(cfg, params, load_tokenizer(args.tokenizer),
              classes=args.classes, batch=args.batch,
              requests=args.requests, k=args.k, seed=args.seed,
              device=args.device, max_delay_ms=args.max_delay_ms,
              registry_dir=args.registry_dir, retrieval=args.retrieval,
              nprobe=nprobe,
              latency_slo_s=args.slo_ms / 1e3 if args.slo_ms else None,
              metrics_port=args.metrics_port)
    print(f"device {rep['device']}: class matrix "
          f"{rep['class_matrix_s']:.3f}s ({rep['class_matrix_source']}), "
          f"first classify "
          f"{rep['first_classify_s']:.3f}s")
    mem = rep["max_memory_allocated"]
    print(f"warm: p50 {rep['p50_s'] * 1e3:.2f}ms  max "
          f"{rep['max_s'] * 1e3:.2f}ms  {rep['img_per_s']:.1f} img/s  "
          f"top1 {rep['top1']:.3f} (untrained chance {rep['chance']:.3f})"
          + (f"  peak memory {mem / 2**30:.2f} GiB" if mem else ""))
    if rep["slo"] is not None:
        s = rep["slo"]
        print(f"slo: p99 {s['p99_s'] * 1e3:.1f}ms vs target "
              f"{s['target_s'] * 1e3:.1f}ms  burn "
              f"{s['error_budget_burn']:.2f}  "
              f"{'READY' if s['healthy'] else 'NOT READY'}")
    print("service stats:", {k: v for k, v in rep["stats"].items()
                             if k != "metrics"})
    return rep


if __name__ == "__main__":
    main()
