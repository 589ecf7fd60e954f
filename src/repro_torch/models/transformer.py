"""Model assembly for the encoder towers (BASIC's and the audio encoder
HuBERT), the dense decoder LMs, the attention-free SSM LMs, the MoE LMs,
the hybrid LMs and the vlm (port of ``repro/models/transformer.py``, every
family of the reference).

Parameters keep the reference's layout: ``params["blocks"]`` is a list
with one entry per position of the layer period (the lcm of the hybrid
family's attention interleave and the MoE interleave: 8 for Jamba, 1 or
2 for the others), each a dict whose leaves stack that position's layers
on a leading axis (n_layers // period), so a reference checkpoint maps
onto the port leaf for leaf. Layer i is position i % period, entry
i // period. A block is ``ln1`` + its mixer (``attn``, or ``mamba`` where
``cfg.layer_kinds()`` says so) + ``ln2`` + ``ffn``, or + ``moe``
(``models.moe``) where the config's MoE mask says so; a block of the SSM
family (Mamba-2) is ``ln1`` + ``mamba`` alone. Decode caches keep the
same stacking: ``caches`` is a list with one entry per period position, a
``KVCache`` for an attention position, whose k/v are (n_layers // period,
batch, kv_heads, cache_len, head_dim), or an ``SSMCache`` for a Mamba
position, whose ssm is (n_layers // period, batch, heads, head_dim,
state) fp32 and conv (n_layers // period, batch, conv_width - 1, d_conv);
a hybrid model's list holds both kinds. ``forward`` runs a Python loop
over the layers where the reference runs ``lax.scan`` over the periods.

Entry points:
  init_params(cfg, generator, device, experts)   -> params dict
  lm_loss(cfg, params, batch, moe_args)          -> (loss, metrics)
  encode(cfg, params, batch)                     -> pooled (b, d_model)
  prefill(cfg, params, batch, moe_args, collect_cache_len, layout,
          seq_axis)                              -> logits [, caches]
  decode_step(cfg, params, token, pos, caches, moe_args, layout, seq_axis)
                                                 -> (logits, caches)
  init_caches(cfg, batch, seq_len, device=..., layout=..., seq_axis=...)
                                                 -> zeroed caches

``forward`` and ``encode`` take a ``remat_policy`` (``core.remat``) that
wraps each block in a checkpoint, as the reference wraps each period step
(``repro/models/transformer.py:168-169``). ``forward``, ``encode``,
``lm_loss``, ``prefill`` and ``decode_step`` take a ``layout``
(``core.weight_sharding``) when the params are this rank's parts of
weights split over the model axis (paper §5.1): each block gathers its
layer's weights inside the function remat wraps, and the embedding, the
LM head and the vision frontend are gathered where they are used; under
a 'tp' layout each block computes with its parts
(``core.tensor_parallel``), and a serving step holds the rank's caches
and returns the whole logits on every rank. A serving step's
``seq_axis`` (``launch.steps.cache_seq_axis``) names the ranks its KV
caches' sequence is split over: each rank holds its slice of every KV
cache, and decode merges the ranks' partial attentions
(``attention.merge_partials``). ``decode_step`` writes each
layer's new k/v (or SSD state and conv window) into the caches in place
and returns the same objects. ``moe_args`` (``dispatch``, ``group``,
``capacity_factor`` and the expert share ``experts``) go to every MoE
FFN; ``lm_loss`` adds the MoE load-balance terms of all layers.
``init_params(..., experts=(first, count))`` draws only those experts of
every MoE layer (``models.moe``: the share one card of an
expert-parallel deployment holds). A vlm (InternVL2) puts its vision
frontend's patches before the token embeddings and trains on the text
tail; an audio encoder (HuBERT) takes precomputed frame embeddings and
trains on the masked-frame cross-entropy (``lm_loss``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import remat as remat_lib
from repro_torch.core import tensor_parallel as tp
from repro_torch.core import weight_sharding as ws
from repro_torch.models import attention as attn_lib
from repro_torch.models import frontends as fe
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models import precision as prec_lib
from repro_torch.models import ssm as ssm_lib


def period_of(cfg: ArchConfig) -> int:
    """Layer-stack period (the reference's scan unit): the lcm of the
    hybrid family's attention interleave (``attn_every``) and the MoE
    interleave (``moe.every``); 1 for a model with neither."""
    p = cfg.attn_every if cfg.family == "hybrid" else 1
    if cfg.moe is not None:
        p = math.lcm(p, cfg.moe.every)
    if cfg.n_layers % p:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not a "
                         f"whole number of periods of {p}")
    return p


def _init_block(cfg: ArchConfig, generator: torch.Generator, kind: str,
                use_moe: bool, extra, device, experts=None) -> dict:
    d = cfg.d_model
    p = {"ln1": torch.ones((*extra, d), device=device)}
    if kind == "attn":
        p["attn"] = attn_lib.init_attn_params(cfg, generator, extra, device)
    else:
        p["mamba"] = ssm_lib.init_ssm_params(cfg, generator, extra, device)
    if cfg.family == "ssm":         # Mamba-2 blocks have no separate FFN
        return p
    p["ln2"] = torch.ones((*extra, d), device=device)
    if use_moe:
        p["moe"] = moe_lib.init_moe_params(cfg, generator, extra, device,
                                           experts=experts)
    else:
        p["ffn"] = {
            "wi": L.dense_init(generator, d, cfg.d_ff, extra, device),
            "wg": L.dense_init(generator, d, cfg.d_ff, extra, device),
            "wo": L.dense_init(generator, cfg.d_ff, d, extra, device),
        }
    return p


def init_params(cfg: ArchConfig, generator: torch.Generator,
                device, experts=None) -> dict:
    """Tower params: the stacked block list, final norm, the vision
    frontend and, for a model with a vocabulary, the embedding table
    (not for an audio encoder, which takes frame embeddings) and the
    untied LM head (the reference's leaves, drawn with its init law).
    ``experts`` = (first, count) draws only those experts of every MoE
    layer (None: all)."""
    period = period_of(cfg)
    kinds = cfg.layer_kinds()[:period]
    moe_mask = cfg.moe_layer_mask()[:period]
    params = {
        "blocks": [_init_block(cfg, generator, kinds[i], moe_mask[i],
                               (cfg.n_layers // period,), device, experts)
                   for i in range(period)],
        "final_norm": torch.ones((cfg.d_model,), device=device),
    }
    if cfg.frontend == "vision":
        params["frontend"] = fe.init_vision_frontend(cfg, generator, device)
    if cfg.vocab > 0 and cfg.frontend != "audio":
        params["embed"] = L.trunc_normal(generator, (cfg.vocab, cfg.d_model),
                                         cfg.d_model ** -0.5, device)
    if cfg.vocab > 0 and not cfg.tie_embeddings:
        params["lm_head"] = L.dense_init(generator, cfg.d_model, cfg.vocab,
                                         device=device)
    return params


def _layer(tree, i: int):
    """Layer ``i`` of a dict of stacked leaves."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _apply_block(cfg: ArchConfig, p, h, positions, key_mask=None,
                 cache=None, decode=False, collect_cache_len=None,
                 moe_args=None, axis=None, seq_axis=None):
    """Pre-norm block: attention or the Mamba-2 mixer (by the block's
    leaves), then, outside the SSM family, a pre-norm SwiGLU or MoE FFN.
    ``axis``: the model axis when ``p`` holds this rank's Megatron parts
    (``core.tensor_parallel.block_params``); a cache is then the rank's
    (its kv heads, or its SSD heads and conv channels). ``seq_axis``: the
    ranks a KV cache's sequence is split over (``attention``'s
    ``_slice_of``), an SSM cache being whole along it. Returns (h, the
    layer's cache: the one given, written in place, when decoding; one
    built from the prompt with ``collect_cache_len``; else None, the MoE
    load-balance term or None)."""
    hn = L.rms_norm(h, p["ln1"], cfg.norm_eps)
    new_cache = None
    if "mamba" in p:
        if decode:
            mix, new_cache = ssm_lib.mamba_decode(p["mamba"], cfg, hn, cache,
                                                  axis=axis)
        else:
            mix, new_cache = ssm_lib.mamba_mixer(p["mamba"], cfg, hn,
                                                 axis=axis)
            if collect_cache_len is None:
                new_cache = None
    elif decode:
        mix, new_cache = attn_lib.decode_attention(p["attn"], cfg, hn, cache,
                                                   positions, axis=axis,
                                                   seq_axis=seq_axis)
    elif collect_cache_len is not None:
        mix, (k, v) = attn_lib.attention(p["attn"], cfg, hn, positions,
                                         return_kv=True, key_mask=key_mask,
                                         axis=axis)
        new_cache = attn_lib.cache_from_prefill(cfg, k, v, collect_cache_len,
                                                seq_axis=seq_axis)
    else:
        mix = attn_lib.attention(p["attn"], cfg, hn, positions,
                                 key_mask=key_mask, axis=axis)
    h = h + mix
    if cfg.family == "ssm":         # Mamba-2 blocks have no separate FFN
        return h, new_cache, None
    hn = L.rms_norm(h, p["ln2"], cfg.norm_eps)
    if "moe" in p:
        out, aux = moe_lib.moe_ffn(p["moe"], cfg, hn, **(moe_args or {}),
                                   axis=axis)
        return h + out, new_cache, aux
    return h + L.swiglu(hn, p["ffn"]["wi"], p["ffn"]["wg"],
                        p["ffn"]["wo"], axis), new_cache, None


def _megatron_block(cfg: ArchConfig, p, lay, moe_args):
    """(params, moe_args, axis) of one layer under a 'tp' layout ``lay``:
    the leaves Megatron consumes split kept as parts, the rest made whole
    (``tensor_parallel.block_params``: a mixer's B, C and conv weights by
    the gather whose backward sums the ranks' parts),
    and a MoE layer's expert share when the rule splits the expert axis;
    under any other layout the layer's leaves gathered whole."""
    if not tp.active(lay):
        return tp.resolve(p, lay), moe_args, None
    if "moe" in p:
        moe_args = dict(moe_args or {},
                        experts=tp.expert_share(cfg, lay["moe"]))
    return tp.block_params(p, lay), moe_args, lay.axis


def _layers(cfg: ArchConfig, params):
    """(period position, entry, that layer's params) for every layer in
    order: layer i is entry i // period of position i % period."""
    period = period_of(cfg)
    for i in range(cfg.n_layers):
        r, j = i % period, i // period
        yield r, j, _layer(params["blocks"][r], j)


def forward(cfg: ArchConfig, params, h, positions, key_mask=None,
            remat_policy=None, caches=None, decode=False,
            collect_cache_len=None, moe_args=None, layout=None,
            seq_axis=None):
    """Run the block stack. h: (b, s, d); key_mask: optional (b, s) bool
    padding mask threaded into attention; remat_policy: optional
    ``core.remat`` policy applied per block (not while decoding or
    building caches). ``decode``: one token per row against ``caches``
    at ``positions`` (an int or a (b,) tensor). ``collect_cache_len``:
    build decode caches of that length from the prompt. ``moe_args`` go
    to every MoE FFN. ``layout``: the ``core.weight_sharding`` layout of
    ``params`` when its block leaves are parts; each layer's leaves are
    gathered whole inside the block (within the remat wrapper, so a
    recomputed block gathers them again), or, under a 'tp' layout, the
    block computes with its parts (``core.tensor_parallel``) and its
    all-reduces run inside the remat wrapper, so a recomputed block
    issues them again in the same order on every rank of the group. The
    decode and cache-building passes run each layer the same way: under
    'tp' on its parts, with the rank's caches (``init_caches(...,
    layout=)``), under any other layout on its leaves gathered whole for
    that layer alone; with ``seq_axis`` on the rank's slice of every KV
    cache's sequence (``_apply_block``).

    Returns (h, caches, aux): the caches given (written in place), the
    ones built, or None; aux the sum of the MoE load-balance terms (an
    fp32 scalar, 0 without MoE layers)."""
    terms = []
    lays = [ws.layer(ws.sub(layout, "blocks", r))
            for r in range(len(params["blocks"]))]
    if decode:
        for r, j, p in _layers(cfg, params):
            c = caches[r]
            p, margs, axis = _megatron_block(cfg, p, lays[r], moe_args)
            h, _, aux = _apply_block(cfg, p, h, positions,
                                     cache=type(c)(*(x[j] for x in c)),
                                     decode=True, moe_args=margs, axis=axis,
                                     seq_axis=seq_axis)
            terms.append(aux)
        out_caches = caches
    elif collect_cache_len is not None:
        built = [[] for _ in params["blocks"]]
        for r, _, p in _layers(cfg, params):
            p, margs, axis = _megatron_block(cfg, p, lays[r], moe_args)
            h, c, aux = _apply_block(cfg, p, h, positions, key_mask=key_mask,
                                     collect_cache_len=collect_cache_len,
                                     moe_args=margs, axis=axis,
                                     seq_axis=seq_axis)
            built[r].append(c)
            terms.append(aux)
        out_caches = [type(b[0])(*(torch.stack(leaf) for leaf in zip(*b)))
                      for b in built]
    else:
        def block(lay, p, h, positions, key_mask):
            p, margs, axis = _megatron_block(cfg, p, lay, moe_args)
            h, _, aux = _apply_block(cfg, p, h, positions, key_mask,
                                     moe_args=margs, axis=axis)
            return h, aux

        for r, _, p in _layers(cfg, params):
            h, aux = remat_lib.apply(remat_policy, block, lays[r], p, h,
                                     positions, key_mask)
            terms.append(aux)
        out_caches = None
    terms = [t for t in terms if t is not None]
    aux = (torch.stack(terms).sum() if terms
           else torch.zeros((), dtype=torch.float32, device=h.device))
    return h, out_caches, aux


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device).expand(b, s)


def embed_inputs(cfg: ArchConfig, params, batch, dtype, layout=None):
    """Returns (h (b, s, d), positions (b, s), text_mask (b, s) or None).

    Vision towers consume raw ``batch['image']`` (b, H, W, C) through the
    linear-patchify frontend; with ``batch['tokens']`` too (a vlm), token
    embeddings follow the patches and ``text_mask`` marks them; a vlm's
    token-only batch (serving) embeds its tokens alone. Audio encoders
    take the precomputed frame embeddings ``batch['embeddings']`` (b, s,
    d), cast to ``dtype``. Token towers embed ``batch['tokens']``.
    ``layout``: the frontend and the embedding are gathered on use
    (``forward``); under a 'tp' layout a vocab-split embedding is looked
    up vocab-parallel (each rank its own rows, summed over the group) and
    the frontend is made whole."""
    if cfg.frontend == "audio":
        h = batch["embeddings"].to(dtype)
        b, s = h.shape[:2]
        return h, _positions(b, s, h.device), None
    if cfg.frontend == "vision" and "image" in batch:
        patches = fe.patch_embed(
            tp.resolve(params["frontend"], ws.sub(layout, "frontend")), cfg,
            batch["image"], dtype)
        b, p = patches.shape[:2]
        if cfg.vocab > 0 and "tokens" in batch:
            tok = batch["tokens"]
            emb = tp.vocab_embed(params["embed"], ws.sub(layout, "embed"),
                                 tok, dtype)
            h = torch.cat([patches, emb], dim=1)
            text_mask = torch.cat(
                [torch.zeros((b, p), dtype=torch.bool, device=h.device),
                 torch.ones(tok.shape, dtype=torch.bool, device=h.device)],
                dim=1)
            return h, _positions(b, h.shape[1], h.device), text_mask
        return patches, _positions(b, p, patches.device), None
    tok = batch["tokens"]
    emb = tp.vocab_embed(params["embed"], ws.sub(layout, "embed"), tok,
                         dtype)
    b, s = tok.shape
    return emb, _positions(b, s, emb.device), None


def encode(cfg: ArchConfig, params, batch, *, precision=None,
           remat_policy=None, layout=None):
    """Pooled representation of a dual-encoder tower: (b, d_model) in the
    policy's projection dtype (fp32 under the default policies).

    ``batch['attn_mask']`` (b, s) masks padded text positions both inside
    attention and in the mean pooling; pooling accumulates in fp32.
    ``remat_policy`` wraps each block and ``layout`` gathers split
    weights on use (``forward``)."""
    pol = prec_lib.resolve(precision)
    h, pos, _ = embed_inputs(cfg, params, batch, pol.compute_dtype, layout)
    mask = batch.get("attn_mask")
    h, _, _ = forward(cfg, params, h, pos, key_mask=mask,
                      remat_policy=remat_policy, layout=layout)
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    h = pol.accum(h)
    if mask is not None:
        m = mask.to(h.dtype)[..., None]
        pooled = torch.sum(h * m, dim=1) / torch.clamp(torch.sum(m, dim=1),
                                                       min=1.0)
    else:
        pooled = torch.mean(h, dim=1)
    return pol.project(pooled)


# ---------------------------------------------------------------------------
# Decoder LMs: logits, the training loss, caches, prefill and decode
# ---------------------------------------------------------------------------


def vocab_axis(cfg: ArchConfig, layout):
    """The model axis when a 'tp' layout splits the head over the vocab
    (``lm_head``'s columns, or the tied ``embed``'s rows), else None."""
    tied = cfg.tie_embeddings
    return tp.split_axis(ws.sub(layout, "embed" if tied else "lm_head"),
                         0 if tied else 1)


def logits_from_h(cfg: ArchConfig, params, h,
                  pol: prec_lib.Precision = None, layout=None):
    """Vocabulary logits from hidden states (b, s, d): the tied head
    h @ embedᵀ, or ``lm_head``, in the policy's projection dtype (fp32
    under the default policies); ``layout`` gathers the head on use.
    Where ``vocab_axis`` names an axis the result is this rank's vocab
    slice (b, s, V/M), slices in rank order; a head the rule splits over
    d is made whole."""
    if pol is not None:
        h = pol.project(h)
    key = "embed" if cfg.tie_embeddings else "lm_head"
    axis = vocab_axis(cfg, layout)
    if axis is not None:
        h = tp.copy_to_model(h, axis)
        w = params[key]
    else:
        w = tp.resolve(params[key], ws.sub(layout, key))
    if cfg.tie_embeddings:
        return torch.matmul(h, w.to(h.dtype).T)
    return L.dense(h, w)


def lm_loss(cfg: ArchConfig, params, batch, *, dtype=torch.float32,
            precision=None, remat_policy=None, moe_args=None, layout=None):
    """Training loss: for a decoder LM the next-token cross-entropy over
    ``batch['tokens']`` (b, s), averaged over the (b, s - 1) predicted
    positions, or over those ``batch['loss_mask'][:, 1:]`` keeps; for a
    vlm the same over the text tail (the logits past the
    ``cfg.frontend_len`` patches); for the encoder family (HuBERT) the
    masked-frame cross-entropy of ``batch['targets']`` (b, s) where
    ``batch['mask']`` is set, divided by max(mask count, 1). The
    logits and the cross-entropy are fp32 whatever the compute dtype.
    ``precision`` (a policy or its name) wins over the legacy ``dtype``
    (default f32, as in the reference); ``remat_policy`` wraps each block;
    ``moe_args`` go to every MoE FFN; ``layout`` gathers split weights on
    use (``forward``), or under 'tp' computes with the parts, the
    cross-entropy vocab-parallel where the head is split on the vocab
    (the whole (b, s, V) logits are never formed).

    Returns (loss + aux, {'xent': loss, 'aux': aux}); aux is the sum of
    the MoE load-balance terms over the layers (0 without MoE layers)."""
    pol = prec_lib.resolve(precision, dtype)
    h, pos, text_mask = embed_inputs(cfg, params, batch, pol.compute_dtype,
                                     layout)
    h, _, aux = forward(cfg, params, h, pos, remat_policy=remat_policy,
                        moe_args=moe_args, layout=layout)
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = logits_from_h(cfg, params, h, pol, layout).float()
    if cfg.family == "encoder":
        tgt, mask = batch["targets"].long(), batch["mask"]
    else:
        if text_mask is not None:               # vlm: the text tail only
            logits = logits[:, cfg.frontend_len:]
        logits = logits[:, :-1]
        tgt, mask = batch["tokens"][:, 1:].long(), batch.get("loss_mask")
        if mask is not None:
            mask = mask[:, 1:]
    axis = vocab_axis(cfg, layout)
    if axis is not None:
        nll = tp.vocab_xent(logits, tgt, axis)
    else:
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
    if mask is not None:
        m = mask.float()
        loss = torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)
    else:
        loss = torch.mean(nll)
    return loss + aux, {"xent": loss, "aux": aux}


def init_caches(cfg: ArchConfig, batch: int, seq_len: int,
                dtype=torch.bfloat16, *, device, layout=None,
                seq_axis=None) -> list:
    """Zeroed decode caches on ``device`` (required), stacked over the
    layers: a list with one entry per period position, by its layers'
    kind: a ``KVCache`` of (n_layers // period, batch, kv_heads,
    cache_len, head_dim), ring-sized when the window fits in ``seq_len``,
    or an ``SSMCache`` of (n_layers // period, batch, ...), whatever
    ``seq_len``. Under a 'tp' ``layout`` of M model ranks they are one
    rank's: KV/M kv heads, and the state of H/M SSD heads with the conv
    window of their x channels (``ssm.init_ssm_cache``); under any other
    layout whole in heads. With ``seq_axis`` (the placement
    ``launch.steps.cache_seq_axis`` gives, as the reference's
    ``cache_specs`` places a cache's sequence) a KV cache holds the rank's
    cache_len / P of the slots; an SSM cache is whole along it."""
    period = period_of(cfg)
    n = cfg.n_layers // period
    m = layout.axis.size if tp.active(layout) else 1
    caches = []
    for kind in cfg.layer_kinds()[:period]:
        if kind == "attn":
            one = attn_lib.init_kv_cache(
                cfg if m == 1 else tp.local_heads(cfg, m), batch, seq_len,
                dtype, device=device, seq_axis=seq_axis)
        else:
            one = ssm_lib.init_ssm_cache(cfg, batch, dtype, device=device,
                                         model=m)
        caches.append(type(one)(*(x[None].expand(n, *x.shape).contiguous()
                                  for x in one)))
    return caches


def _served_logits(cfg: ArchConfig, params, h, pol, layout):
    """``logits_from_h`` with the whole vocab on every rank: where a 'tp'
    layout splits the head on the vocab, the ranks' slices are joined
    (``tensor_parallel.gather_from_model``)."""
    logits = logits_from_h(cfg, params, h, pol, layout)
    axis = vocab_axis(cfg, layout)
    return logits if axis is None else tp.gather_from_model(logits, axis)


def prefill(cfg: ArchConfig, params, batch, *, dtype=torch.bfloat16,
            precision=None, moe_args=None, collect_cache_len=None,
            layout=None, seq_axis=None):
    """Forward over ``batch['tokens']`` (b, s) emitting the last position's
    logits (b, 1, vocab); with ``collect_cache_len`` also builds the decode
    caches (serving prefill) and returns (logits, caches). ``precision``
    (a policy or its name) wins over the legacy ``dtype``, whose default
    is bf16, as in the reference; ``moe_args`` go to every MoE FFN.
    ``layout``: the params are this rank's parts (``forward``); the
    caches built are then the rank's (``init_caches``' shapes) and the
    logits are the whole vocab on every rank. ``seq_axis``: the KV caches
    built are the rank's slice of the sequence, the whole cache never
    allocated (``attention.cache_from_prefill``)."""
    pol = prec_lib.resolve(precision, dtype)
    h, pos, _ = embed_inputs(cfg, params, batch, pol.compute_dtype, layout)
    h, caches, _ = forward(cfg, params, h, pos, moe_args=moe_args,
                           collect_cache_len=collect_cache_len,
                           layout=layout, seq_axis=seq_axis)
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = _served_logits(cfg, params, h[:, -1:, :], pol, layout)
    if collect_cache_len is not None:
        return logits, caches
    return logits


def decode_step(cfg: ArchConfig, params, token, pos, caches, *,
                dtype=torch.bfloat16, precision=None, moe_args=None,
                layout=None, seq_axis=None):
    """One decode step. token: (b, 1) integer tensor; pos: an int (every
    row at one position, the lockstep engine) or a (b,) integer tensor of
    per-slot positions (the continuous engine; Mamba layers ignore it).
    Writes each layer's new k/v, or SSD state and conv window, into
    ``caches`` in place; returns (logits (b, 1, vocab), caches).
    ``moe_args`` go to every MoE FFN: under capacity dispatch the b rows
    are one group, so a row's tokens depend on its batch-mates (the
    reference's behaviour). ``layout``: the params are this rank's parts
    and ``caches`` the rank's (``init_caches(..., layout=)``); the token
    is embedded vocab-parallel under 'tp' (``tensor_parallel.vocab_embed``)
    and the logits are the whole vocab on every rank. ``seq_axis``: the KV
    caches are the rank's slices of the sequence (``init_caches(...,
    seq_axis=)``), each layer's partial attentions merged over it."""
    pol = prec_lib.resolve(precision, dtype)
    h = tp.vocab_embed(params["embed"], ws.sub(layout, "embed"), token,
                       pol.compute_dtype)
    h, caches, _ = forward(cfg, params, h, pos, caches=caches, decode=True,
                           moe_args=moe_args, layout=layout,
                           seq_axis=seq_axis)
    h = L.rms_norm(h, params["final_norm"], cfg.norm_eps)
    return _served_logits(cfg, params, h, pol, layout), caches
