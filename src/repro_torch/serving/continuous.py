"""Continuous-batching decode engine (port of
``repro/serving/continuous.py``).

The lockstep ``Engine`` decodes a fixed batch together and retires it when
its slowest request finishes. This engine decouples admission from decode
around a slot-based cache of capacity ``num_slots``:

  prefill(prompt)    one b=1 forward, giving the first token's logits and a
                     single cache row (zeros past the prompt)
  insert(row, slot)  copy that row into the packed (n_layers, num_slots,
                     ...) cache in place, overwriting the slot's previous
                     tenant entirely (KV rows, or SSD state and conv
                     window rows alike, both in one hybrid model's list)
  step()             one decode step advancing every slot by one token at
                     its own position (``transformer.decode_step`` with
                     ``pos`` (S,)): RoPE, cache write and length mask per
                     row in the attention layers (Mamba-2 layers need no
                     position)

Host-side per-slot state (request id, position, emitted tokens, budget)
retires finished slots and refills them from the FIFO queue at the top of
every tick. Greedy tokens of each request equal ``Engine.generate`` run
alone on it: prefill is the same b=1 forward, and a packed step computes
each row on its own (stale entries past a slot's position weigh exactly
0). Sampled decoding draws from a generator per request, seeded by
``(seed, request_id)``.

Telemetry lives in the port's ``obs.Registry`` (injectable) under the
reference's series names: ``decode/slot_occupancy`` (gauge, and a ratio
histogram ``decode/slot_occupancy_ratio``), ``decode/queue_depth``,
``decode/admission_wait_s``, ``decode/prefill_s``, ``decode/step_s``,
``decode/tokens``, ``decode/requests`` and ``decode/admissions``.
``step_log`` keeps every decode tick's (host seconds, active slots) as
well, for exact percentiles and decode throughput.

SLO: ``latency_slo_s`` arms an ``obs.health.SLOTracker`` on the engine's
registry: every request's end-to-end latency (submit to finish, queue
wait included) feeds a windowed p99 against the target, an error-budget
burn and a readiness bit under ``decode/slo_*``; ``serve_metrics()``
serves them live (``/metrics``, ``/healthz``, ``/snapshot.json``).
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import precision as prec_lib
from repro_torch.models import transformer as tf
from repro_torch.obs import export as obs_export
from repro_torch.obs import health as obs_health
from repro_torch.obs.metrics import RATIO_BUCKETS, Registry
from repro_torch.serving.engine import check_decoder, sample_tokens, with_attn


@dataclasses.dataclass
class FinishedRequest:
    """A retired request: its id, prompt length and every generated token
    (EOS included when hit; never padded)."""
    request_id: int
    prompt_len: int
    tokens: np.ndarray           # (n_generated,) int32, n <= max_new_tokens


@dataclasses.dataclass
class _Slot:
    """Host-side state of one cache row."""
    request_id: int = -1
    active: bool = False
    pos: int = 0                 # the next decode position
    next_token: int = 0          # last sampled token, the next step's input
    emitted: Optional[list] = None
    max_new: int = 0
    prompt_len: int = 0
    rng: Optional[np.random.Generator] = None
    t_sub: float = 0.0           # submit time, for the SLO


class ContinuousEngine:
    """Slot-based continuous-batching decode engine.

    ``submit()`` enqueues requests; each ``step()`` admits queued requests
    into free slots (prefill, insert), advances every active slot one
    token with one decode step, and retires the slots whose request hit
    EOS or its budget, returning them as ``FinishedRequest``s. ``run()``
    is the drain loop. The engine runs on the device of ``params``.
    ``moe_args`` (stored as ``moe_args or {}``) go to every prefill and
    decode step; an idle slot feeds token 0 at position 0, as in the
    reference, and under capacity dispatch takes bucket places like a live
    row."""

    def __init__(self, cfg: ArchConfig, params, *, cache_len: int,
                 num_slots: int, dtype=None, precision=None,
                 attn: Optional[str] = None,
                 moe_args: Optional[dict] = None,
                 eos_id: int = 3, temperature: float = 0.0, seed: int = 0,
                 registry: Optional[Registry] = None,
                 latency_slo_s: Optional[float] = None):
        check_decoder(cfg)
        if num_slots < 1:
            raise ValueError(f"num_slots={num_slots} must be >= 1")
        self.device = params["embed"].device
        self.cfg = with_attn(cfg, attn, self.device)
        self.params = params
        self.cache_len = int(cache_len)
        self.num_slots = int(num_slots)
        self.precision = prec_lib.resolve(precision, dtype or torch.float32)
        self.moe_args = moe_args or {}
        self.eos_id = int(eos_id)
        self.temperature = float(temperature)
        self.seed = int(seed)

        self._queue: collections.deque = collections.deque()
        self._slots = [_Slot() for _ in range(self.num_slots)]
        self._caches = None                              # built on 1st insert
        self._next_id = 0
        self._finished: List[FinishedRequest] = []
        self._t0 = None
        self.step_log: List[tuple] = []     # (seconds, active slots)

        self.registry = registry if registry is not None else Registry()
        self._m_occ = self.registry.gauge("decode/slot_occupancy")
        self._m_occ_hist = self.registry.histogram(
            "decode/slot_occupancy_ratio", buckets=RATIO_BUCKETS)
        self._m_queue = self.registry.gauge("decode/queue_depth")
        self._m_admit = self.registry.histogram("decode/admission_wait_s")
        self._m_prefill = self.registry.histogram("decode/prefill_s")
        self._m_step = self.registry.histogram("decode/step_s")
        self._m_tokens = self.registry.counter("decode/tokens")
        self._m_requests = self.registry.counter("decode/requests")
        self._m_admitted = self.registry.counter("decode/admissions")
        self.slo = None
        if latency_slo_s is not None:
            self.slo = obs_health.SLOTracker(
                target_s=float(latency_slo_s), registry=self.registry,
                name="decode")

    # -- device work ---------------------------------------------------------
    def _prefill(self, prompt: np.ndarray):
        """b=1 prompt forward -> (last-position logits (1, vocab), one
        cache row)."""
        tokens = torch.from_numpy(prompt[None, :]).to(self.device)
        logits, row = tf.prefill(self.cfg, self.params, {"tokens": tokens},
                                 precision=self.precision,
                                 moe_args=self.moe_args,
                                 collect_cache_len=self.cache_len)
        return logits[:, 0], row

    def _insert(self, row, slot: int) -> None:
        """Copy a b=1 prefill row into the packed cache at ``slot``, in
        place. Every leaf is (n_layers, batch, ...), so one copy on axis 1
        per leaf; the row overwrites the whole slot."""
        if self._caches is None:
            # the packed cache takes the row's dtypes and shapes (they
            # follow the precision policy), widened to num_slots
            self._caches = [type(c)(*(torch.zeros(
                (x.shape[0], self.num_slots, *x.shape[2:]), dtype=x.dtype,
                device=x.device) for x in c)) for c in row]
        for big, r in zip(self._caches, row):
            for dst, src in zip(big, r):
                dst[:, slot].copy_(src[:, 0])

    # -- admission -----------------------------------------------------------
    def submit(self, prompt: np.ndarray, max_new_tokens: int,
               request_id: Optional[int] = None) -> int:
        """Enqueue one request. ``prompt``: (plen,) int32. Returns its id
        (auto-assigned unless given). Requests are admitted FIFO as slots
        free up."""
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1 or prompt.size < 1 or max_new_tokens < 1:
            raise ValueError(f"need a (plen >= 1,) prompt and "
                             f"max_new_tokens >= 1, got {prompt.shape}, "
                             f"{max_new_tokens}")
        if not (prompt.size + max_new_tokens <= self.cache_len
                or self.cfg.sliding_window is not None):
            raise ValueError(
                f"prompt_len {prompt.size} + max_new_tokens "
                f"{max_new_tokens} exceeds cache_len {self.cache_len}")
        rid = self._next_id if request_id is None else int(request_id)
        self._next_id = max(self._next_id, rid) + 1
        self._queue.append((rid, prompt, int(max_new_tokens), time.time()))
        self._m_queue.set(len(self._queue))
        self._m_requests.inc()
        return rid

    def _admit(self) -> None:
        """Fill free slots from the queue: prefill(prompt), insert(slot). A
        request whose first token already finishes it (max_new_tokens = 1,
        or an immediate EOS) retires here and never occupies a slot."""
        for slot_idx, s in enumerate(self._slots):
            if not self._queue:
                break
            if s.active:
                continue
            rid, prompt, max_new, t_sub = self._queue.popleft()
            t0 = time.time()
            self._m_admit.observe(t0 - t_sub)
            logits, row = self._prefill(prompt)
            rng = np.random.default_rng((self.seed, rid))
            tok = int(sample_tokens(logits, self.temperature, rng)[0])
            self._m_tokens.inc()
            self._m_admitted.inc()
            if tok == self.eos_id or max_new == 1:
                self._finished.append(FinishedRequest(
                    request_id=rid, prompt_len=prompt.size,
                    tokens=np.asarray([tok], np.int32)))
                self._m_prefill.observe(time.time() - t0)
                if self.slo is not None:
                    self.slo.observe(time.time() - t_sub)
                continue
            self._insert(row, slot_idx)
            s.request_id, s.active = rid, True
            s.pos, s.next_token = prompt.size, tok
            s.emitted, s.max_new = [tok], max_new
            s.prompt_len, s.rng = prompt.size, rng
            s.t_sub = t_sub
            self._m_prefill.observe(time.time() - t0)
        self._m_queue.set(len(self._queue))

    # -- decode --------------------------------------------------------------
    def step(self) -> List[FinishedRequest]:
        """One engine tick: admit, advance every active slot one token,
        retire. Returns the requests that finished during this tick."""
        if self._t0 is None:
            self._t0 = time.time()
        with torch.no_grad():
            self._admit()
            active = [i for i, s in enumerate(self._slots) if s.active]
            self._m_occ.set(len(active) / self.num_slots)
            self._m_occ_hist.observe(len(active) / self.num_slots)
            if active:
                self._decode(active)
        out, self._finished = self._finished, []
        return out

    def _decode(self, active: List[int]) -> None:
        t0 = time.time()
        tokens = np.zeros((self.num_slots, 1), np.int32)
        pos = np.zeros((self.num_slots,), np.int64)
        for i in active:
            tokens[i, 0] = self._slots[i].next_token
            pos[i] = self._slots[i].pos
        logits, self._caches = tf.decode_step(
            self.cfg, self.params, torch.from_numpy(tokens).to(self.device),
            torch.from_numpy(pos).to(self.device), self._caches,
            precision=self.precision, moe_args=self.moe_args)
        logits = logits[:, 0].float().cpu().numpy()
        for i in active:
            s = self._slots[i]
            tok = int(sample_tokens(logits[i:i + 1], self.temperature,
                                    s.rng)[0])
            s.emitted.append(tok)
            s.pos += 1
            s.next_token = tok
            self._m_tokens.inc()
            if tok == self.eos_id or len(s.emitted) >= s.max_new:
                self._finished.append(FinishedRequest(
                    request_id=s.request_id, prompt_len=s.prompt_len,
                    tokens=np.asarray(s.emitted, np.int32)))
                s.active = False
                s.emitted, s.rng = None, None
                if self.slo is not None:
                    self.slo.observe(time.time() - s.t_sub)
        dt = time.time() - t0
        self._m_step.observe(dt)
        self.step_log.append((dt, len(active)))

    @property
    def pending(self) -> int:
        """Requests not yet finished: queued + occupying a slot."""
        return len(self._queue) + sum(s.active for s in self._slots)

    def run(self, requests=None, *, max_steps: int = 100_000
            ) -> Dict[int, np.ndarray]:
        """Drain loop: optionally ``submit()`` each ``(prompt, max_new)``
        pair (or ``(prompt, max_new, request_id)`` triple), then ``step()``
        until nothing is pending. Returns {request_id: tokens}."""
        for req in requests or []:
            self.submit(*req)
        done: Dict[int, np.ndarray] = {}
        steps = 0
        while self.pending:
            for fin in self.step():
                done[fin.request_id] = fin.tokens
            steps += 1
            if steps > max_steps:
                raise RuntimeError(f"run() exceeded {max_steps} steps with "
                                   f"{self.pending} requests pending")
        return done

    def stats(self) -> dict:
        """Registry snapshot + derived throughput (tokens/s over the wall
        clock since the first ``step()``)."""
        snap = self.registry.snapshot()
        elapsed = (time.time() - self._t0) if self._t0 else 0.0
        snap["derived"] = {
            "tokens_per_sec": (self._m_tokens.value / elapsed
                               if elapsed > 0 else 0.0),
            "elapsed_s": elapsed,
        }
        if self.slo is not None:
            snap["slo"] = self.slo.status()
        return snap

    def serve_metrics(self, *, port: int = 0, host: str = "127.0.0.1"):
        """Start a live HTTP endpoint over the engine's registry:
        ``/metrics`` (Prometheus), ``/healthz`` (SLO readiness when
        ``latency_slo_s`` was set: 503 while the error budget is
        exhausted), ``/snapshot.json``. Localhost-only by default; the
        caller owns the returned ``MetricsServer`` (``stop()`` it)."""
        return obs_export.MetricsServer(
            self.registry,
            health=self.slo.status if self.slo is not None else None,
            host=host, port=port).start()
