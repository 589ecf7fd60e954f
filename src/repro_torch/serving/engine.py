"""Lockstep serving engine: prefill + decode loop over a fixed batch (port
of ``repro/serving/engine.py``).

``Engine.generate`` prefills the prompt batch once, building the per-layer
decode caches (KV caches, a ring under a sliding window whose length is
the cache's; for Mamba-2 layers the SSD state and conv window; a hybrid
model's list holds both kinds), then
decodes one token for every row per step; the caches are written in
place. Prefill and decode run under one ``models.precision`` policy and
one attention backend: ``attn`` selects the full-sequence backend for
prefill (``models.attention`` registry; ``pallas`` is the flash kernel)
and the decode backend (``resolve_decode_backend``; ``pallas`` is the
split-K decode kernel); it has no effect on an attention-free model,
whose prefill runs the SSD scan kernel (a hybrid model's Mamba-2 layers
run it beside its attention layers). ``moe_args`` (stored as
``moe_args or {}``, as the reference stores them) go to every prefill and
decode step of a MoE model; under capacity dispatch the rows of a step
share the experts' buckets, so a row's tokens depend on its batch-mates,
as in the reference. The engine runs on the device of the parameters it
is given.

Sampling (``sample_tokens``, shared with the continuous engine): greedy is
an fp32 host-side ``np.argmax``, the tie-break both engines share;
temperature sampling draws from a numpy generator over a softmax computed
in numpy. Per-row EOS stops are tracked on the host; finished rows keep
decoding and their tokens are masked to 0 in the result. Unlike the
reference, no decode step runs after the last token is sampled.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import precision as prec_lib
from repro_torch.models import transformer as tf


def sample_tokens(logits, temperature: float, rng) -> np.ndarray:
    """One token per row from (b, vocab) logits (numpy or a tensor).
    Greedy for ``temperature <= 0``: an fp32 host-side argmax, the
    tie-break every engine shares; else a draw from ``rng`` over the fp32
    softmax of ``logits / temperature``."""
    if torch.is_tensor(logits):
        logits = logits.float().cpu().numpy()
    logits = np.asarray(logits, np.float32)
    if temperature <= 0:
        return np.argmax(logits, axis=-1).astype(np.int32)
    z = logits / np.float32(temperature)
    p = np.exp(z - z.max(axis=-1, keepdims=True))
    p = p / p.sum(axis=-1, keepdims=True)
    return np.array([rng.choice(p.shape[-1], p=pi / pi.sum()) for pi in p],
                    np.int32)


def with_attn(cfg: ArchConfig, attn: Optional[str], device) -> ArchConfig:
    """``cfg`` with ``attn_impl`` set to ``attn`` (None keeps it), checked
    against both the prefill and the decode backend registries: a typo
    raises ``KeyError`` here, at construction."""
    if attn is None:
        return cfg
    attn_lib.resolve_backend(attn, device)
    attn_lib.resolve_decode_backend(attn, device)
    return dataclasses.replace(cfg, attn_impl=attn)


def check_decoder(cfg: ArchConfig) -> None:
    """Raise unless ``cfg`` is a causal decoder (an encoder has no decode
    step)."""
    if not cfg.causal:
        raise ValueError(f"{cfg.name} is encoder-only; it has no decode "
                         f"step")


class Engine:
    """Lockstep fixed-batch decode engine: one prefill, then every row
    advances together until the slowest finishes. The continuous engine's
    parity oracle."""

    def __init__(self, cfg: ArchConfig, params, *, cache_len: int,
                 dtype=None, precision=None, attn: Optional[str] = None,
                 moe_args: Optional[dict] = None, eos_id: int = 3):
        check_decoder(cfg)
        self.device = params["embed"].device
        self.cfg = with_attn(cfg, attn, self.device)
        self.params = params
        self.cache_len = int(cache_len)
        # an explicit policy wins, a legacy bare dtype maps onto one,
        # default f32 (the engine's historical dtype)
        self.precision = prec_lib.resolve(precision, dtype or torch.float32)
        self.moe_args = moe_args or {}
        self.eos_id = int(eos_id)

    def generate(self, prompts: np.ndarray, max_new_tokens: int, *,
                 temperature: float = 0.0, seed: int = 0) -> np.ndarray:
        """prompts: (b, prompt_len) int32, no padding. Returns (b,
        max_new_tokens) int32, 0 after a row's EOS."""
        prompts = np.asarray(prompts, np.int32)
        b, plen = prompts.shape
        if not (plen + max_new_tokens <= self.cache_len
                or self.cfg.sliding_window is not None):
            raise ValueError(f"prompt_len {plen} + max_new_tokens "
                             f"{max_new_tokens} exceeds cache_len "
                             f"{self.cache_len}")
        rng = np.random.default_rng(seed)
        out = np.zeros((b, max_new_tokens), np.int32)
        done = np.zeros((b,), bool)
        with torch.no_grad():
            logits, caches = tf.prefill(
                self.cfg, self.params,
                {"tokens": torch.from_numpy(prompts).to(self.device)},
                precision=self.precision, moe_args=self.moe_args,
                collect_cache_len=self.cache_len)
            tok = sample_tokens(logits[:, 0], temperature, rng)
            for i in range(max_new_tokens):
                out[:, i] = np.where(done, 0, tok)
                done |= tok == self.eos_id
                if done.all() or i + 1 == max_new_tokens:
                    break
                logits, caches = tf.decode_step(
                    self.cfg, self.params,
                    torch.from_numpy(tok[:, None]).to(self.device),
                    plen + i, caches, precision=self.precision,
                    moe_args=self.moe_args)
                tok = sample_tokens(logits[:, 0], temperature, rng)
        return out
