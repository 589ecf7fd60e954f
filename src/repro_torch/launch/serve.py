"""LM serving launcher: batched generation with the lockstep ``Engine``, or
a request-queue loop over the ``ContinuousEngine`` (port of
``repro/launch/serve.py``).

  # lockstep batch:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --smoke --device cpu --batch 4 --prompt-len 16 --max-new 32

  # continuous batching: a synthetic request queue
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --smoke --device cpu --engine continuous --slots 4 --requests 16 \
      --arrival 0.05 --prompt-len 16 --max-new 32

  # Mamba-2 (attention-free; --attn has no effect on it)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \
      --smoke --device cpu --engine continuous

  # Mixtral-8x22B (MoE; dense dispatch under --smoke, else capacity)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x22b \
      --smoke --device cpu --engine continuous

  # Jamba-1.5-Large (hybrid: Mamba-2 layers, attention every 8th, MoE
  # every 2nd; dense dispatch under --smoke, else capacity)
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch jamba-1.5-large-398b --smoke --device cpu --engine continuous

  # InternVL2-76B (vlm: served on token prompts, as the reference's
  # engines serve it; HuBERT-XLarge, an encoder, is refused)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-76b \
      --smoke --device cpu --engine continuous

A prompt of a model with Mamba-2 layers (Mamba-2, Jamba) must be at most
the SSD chunk long (256 tokens; 32 for ``--smoke``) or a whole number of
chunks, the reference's rule; other lengths raise ``ValueError``. The
continuous loop's ragged lengths (``--prompt-len`` + {-4, 0, 4, 8})
therefore need ``--prompt-len`` <= 248 (<= 24 with ``--smoke``).

Weights are random, drawn from ``--seed`` on the run's device; prompts are
random token ids. A MoE model's FFNs dispatch densely under ``--smoke``
and by capacity (``moe_ffn``'s defaults) otherwise, as the reference's
launcher sets them; ``run_legacy`` and ``run_continuous`` take those
``moe_args``, which may name an expert share (``experts``: (first,
count), the experts ``build(..., experts=...)`` drew; there is no flag
for it). The continuous loop submits ``--requests`` requests
with Poisson-ish gaps (``--arrival`` mean seconds; 0 = all up front) and
prompt lengths around ``--prompt-len``, as the reference does, and reports
tokens/s, slot occupancy and admission wait from the engine's registry,
and the decode-step median and p90 (host clock around each step, which
ends when the logits are on the host). It runs on the card unless given
``--device cpu`` and raises without a card otherwise. ``--slo-ms`` arms
the continuous engine's SLO tracker (end-to-end request latency against
the target: windowed p99, error-budget burn and readiness under
``decode/slo_*``, and an ``slo:`` report line); ``--metrics-port P``
serves ``/metrics``, ``/healthz`` and ``/snapshot.json`` on 127.0.0.1:P
(0 picks a free port) while the requests run.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import interop
from repro_torch.configs import get_arch, smoke_variant
from repro_torch.device import resolve_device
from repro_torch.serving import ContinuousEngine, Engine


def build(arch: str, *, smoke: bool = False, seed: int = 0, device=None,
          experts=None):
    """(cfg, params): the LM ``arch`` (its smoke variant with ``smoke``),
    weights drawn from ``seed`` by a generator on the run's device; with
    ``experts`` = (first, count) only that share of every MoE layer's
    experts (serve it with ``moe_args`` naming the same share)."""
    dev = resolve_device(device)
    cfg = get_arch(arch)
    if smoke:
        cfg = smoke_variant(cfg)
    params = interop.init_params(
        cfg, torch.Generator(device=dev).manual_seed(seed), dev, experts)
    return cfg, params


def moe_args_for(args):
    """The MoE dispatch the launcher serves with: dense under ``--smoke``,
    else None (``moe_ffn``'s capacity defaults), as in the reference."""
    return {"dispatch": "dense"} if args.smoke else None


def run_legacy(cfg, params, args, moe_args=None) -> dict:
    """One lockstep batch of ``--batch`` prompts; returns the report."""
    eng = Engine(cfg, params, cache_len=args.cache_len,
                 precision=args.precision, attn=args.attn,
                 moe_args=moe_args)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(4, cfg.vocab, (args.batch, args.prompt_len),
                           dtype=np.int32)
    t0 = time.perf_counter()
    out = eng.generate(prompts, args.max_new, temperature=args.temperature,
                       seed=args.seed)
    dt = time.perf_counter() - t0
    print(f"generated {out.size} tokens in {dt:.2f}s "
          f"({out.size / dt:.1f} tok/s, prefill included)")
    for row in out[:4]:
        print(" ", row[:16].tolist(), "...")
    return {"tokens": out, "seconds": dt, "tokens_per_s": out.size / dt}


def run_continuous(cfg, params, args, moe_args=None) -> dict:
    """Drive ``--requests`` synthetic requests through the continuous
    engine; returns the report (timings in seconds; ``slo``, the
    tracker's status, under ``--slo-ms``)."""
    slo_ms = getattr(args, "slo_ms", None)
    eng = ContinuousEngine(cfg, params, cache_len=args.cache_len,
                           num_slots=args.slots, precision=args.precision,
                           attn=args.attn, moe_args=moe_args,
                           temperature=args.temperature, seed=args.seed,
                           latency_slo_s=slo_ms / 1e3 if slo_ms else None)
    server = None
    if getattr(args, "metrics_port", None) is not None:
        server = eng.serve_metrics(port=args.metrics_port)
        print(f"obs: serving /metrics /healthz /snapshot.json on "
              f"{server.url}")
    rng = np.random.default_rng(args.seed)
    # ragged prompts around --prompt-len so admission sees mixed shapes
    lens = np.clip(args.prompt_len + rng.choice([-4, 0, 4, 8], args.requests),
                   1, None)
    arrivals = (np.zeros(args.requests) if args.arrival <= 0
                else rng.exponential(args.arrival, args.requests))
    reqs = [(rng.integers(4, cfg.vocab, (int(pl),), dtype=np.int32),
             args.max_new) for pl in lens]

    t0 = time.time()
    done, submitted = {}, 0
    while submitted < len(reqs) or eng.pending:
        now = time.time() - t0
        while submitted < len(reqs) and arrivals[:submitted + 1].sum() <= now:
            eng.submit(*reqs[submitted])
            submitted += 1
        for fin in eng.step():
            done[fin.request_id] = fin.tokens
        if not eng.pending and submitted < len(reqs):
            time.sleep(min(0.005, args.arrival or 0.005))
    dt = time.time() - t0

    snap = eng.stats()
    reg = eng.registry
    toks = reg.counter("decode/tokens").value
    admit = reg.histogram("decode/admission_wait_s").summary()
    occ = reg.histogram("decode/slot_occupancy_ratio").summary()
    prefill = reg.histogram("decode/prefill_s").summary()
    hist = reg.histogram("decode/step_s").summary()
    occ_mean = occ["sum"] / occ["count"] if occ["count"] else 0.0
    admit_mean = admit["sum"] / admit["count"] if admit["count"] else 0.0
    step_s = np.array([s for s, _ in eng.step_log])
    warm = eng.step_log[1:]
    warm_s = sum(s for s, _ in warm)
    rep = {
        "requests": len(done), "tokens": toks, "seconds": dt,
        "tokens_per_s": snap["derived"]["tokens_per_sec"],
        "decode_steps": len(step_s),
        # the tokens that warm decode steps emitted over their host time
        "decode_tokens_per_s": (sum(n for _, n in warm) / warm_s
                                if warm_s > 0 else 0.0),
        "step_median_s": float(np.median(step_s)) if len(step_s) else 0.0,
        "step_p90_s": (float(np.percentile(step_s, 90)) if len(step_s)
                       else 0.0),
        "step_hist_p50_s": hist["p50"], "step_hist_p90_s": hist["p90"],
        "prefill_mean_s": (prefill["sum"] / prefill["count"]
                           if prefill["count"] else 0.0),
        "occupancy_mean": occ_mean, "admission_wait_mean_s": admit_mean,
        "admission_wait_p99_s": admit["p99"],
        "prefills": reg.counter("decode/admissions").value,
        "results": done,
        "engine": eng,        # for callers that go on driving it
    }
    print(f"served {len(done)} requests / {toks} tokens in {dt:.2f}s "
          f"({rep['tokens_per_s']:.1f} tok/s, prefill included); decode "
          f"{rep['decode_tokens_per_s']:.1f} tok/s over "
          f"{len(warm)} warm steps")
    print(f"slot occupancy: mean {occ_mean:.2f} over {occ['count']} ticks; "
          f"admission wait: mean {admit_mean * 1e3:.1f}ms p99~"
          f"{(admit['p99'] or 0.0) * 1e3:.1f}ms over {admit['count']} "
          f"admissions")
    print(f"decode step: median {rep['step_median_s'] * 1e3:.3f}ms p90 "
          f"{rep['step_p90_s'] * 1e3:.3f}ms over {len(step_s)} steps "
          f"(decode/step_s histogram p50~"
          f"{(hist['p50'] or 0.0) * 1e3:.3f}ms p90~"
          f"{(hist['p90'] or 0.0) * 1e3:.3f}ms); prefill mean "
          f"{rep['prefill_mean_s'] * 1e3:.3f}ms per request")
    if "slo" in snap:
        s = rep["slo"] = snap["slo"]
        print(f"slo: p99 {s['p99_s'] * 1e3:.1f}ms vs target "
              f"{s['target_s'] * 1e3:.1f}ms  burn "
              f"{s['error_budget_burn']:.2f}  "
              f"{'READY' if s['healthy'] else 'NOT READY'}")
    for rid in sorted(done)[:4]:
        print(f"  req {rid}:", done[rid][:16].tolist(), "...")
    if server is not None:
        server.stop()
    return rep


def parse_args(argv: Optional[Sequence[str]] = None):
    """The launcher's flags: the reference's, plus ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--engine", default="legacy",
                    choices=["legacy", "continuous"],
                    help="'legacy' = lockstep fixed batch; 'continuous' = "
                         "slot-based admission queue")
    ap.add_argument("--batch", type=int, default=4,
                    help="[legacy] fixed batch size")
    ap.add_argument("--slots", type=int, default=4,
                    help="[continuous] cache slot capacity")
    ap.add_argument("--requests", type=int, default=16,
                    help="[continuous] number of synthetic requests")
    ap.add_argument("--arrival", type=float, default=0.0,
                    help="[continuous] mean inter-arrival gap in seconds "
                         "(0 = all requests queued up front)")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--precision", default=None,
                    choices=["f32", "bf16", "bf16_pure"],
                    help="precision policy for prefill and decode "
                         "(default f32)")
    ap.add_argument("--attn", default=None,
                    choices=["naive", "chunked", "pallas", "auto"],
                    help="attention backend: prefill through the "
                         "models.attention registry ('pallas' = the flash "
                         "kernel), decode through resolve_decode_backend "
                         "('pallas' = the split-K decode kernel)")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="[continuous] end-to-end request latency SLO "
                         "target in ms (submit to finish, queue wait "
                         "included): windowed p99 + error-budget burn "
                         "under decode/slo_*")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="[continuous] serve live /metrics /healthz "
                         "/snapshot.json on 127.0.0.1:PORT "
                         "(0 = ephemeral)")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Parse ``argv``, build the model, serve, print and return the
    report (with ``device`` and, on the card, ``max_memory_allocated``
    over the whole run, weights included)."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    cfg, params = build(args.arch, smoke=args.smoke, seed=args.seed,
                        device=dev)
    if args.engine == "continuous":
        rep = run_continuous(cfg, params, args, moe_args_for(args))
    else:
        rep = run_legacy(cfg, params, args, moe_args_for(args))
    rep["device"] = str(dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        rep["max_memory_allocated"] = torch.cuda.max_memory_allocated(dev)
        print(f"peak memory {rep['max_memory_allocated'] / 2**30:.3f} GiB")
    return rep


if __name__ == "__main__":
    main()
