"""Port parity: full-sequence attention backends and the flash-attention
forward's plain version against the JAX reference on the CPU.

The port's ``naive``, ``chunked`` and ``flash`` backends (``flash`` runs
its plain PyTorch version on a CPU tensor) are held against the
reference's ``naive`` and ``pallas`` (Pallas in interpret mode) on the
BASIC towers' masks: bidirectional with a key-padding mask, head dim 64,
an aligned and a ragged sequence. Tolerance: fp32, 2e-5 abs and rel, the
reference's own cross-backend tolerance (tests/test_attention_backends.py);
bf16, 2e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JaxArchConfig
from repro.kernels.flash_attention.kernel import flash_fwd_bh
from repro.models import attention as jattn
from repro_torch import interop
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import flash_fwd_ref
from repro_torch.models import attention as tattn

torch.set_num_threads(1)

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _fields(heads, kv, causal=False, window=None):
    return dict(name="t", family="encoder", n_layers=1, d_model=64 * heads,
                n_heads=heads, n_kv_heads=kv, d_ff=128, vocab=64,
                head_dim=64, causal=causal, sliding_window=window,
                attn_block=8, rope_theta=1e4)


def _inputs(heads, kv, s, masked, seed):
    rng = np.random.default_rng(seed)
    jcfg = JaxArchConfig(**_fields(heads, kv))
    p = jax.device_get(jattn.init_attn_params(jax.random.key(seed), jcfg))
    x = rng.standard_normal((3, s, 64 * heads)).astype(np.float32)
    mask = None
    if masked:
        mask = np.arange(s)[None, :] < np.array([[s], [5], [s // 2 + 1]])
    return p, x, mask


def _jax_attn(p, x, mask, fields, impl, dtype):
    cfg = JaxArchConfig(**fields)
    b, s, _ = x.shape
    pos = jnp.broadcast_to(jnp.arange(s), (b, s))
    out = jattn.attention(jax.tree.map(jnp.asarray, p), cfg,
                          jnp.asarray(x, dtype), pos, impl=impl,
                          key_mask=None if mask is None
                          else jnp.asarray(mask))
    return np.asarray(out.astype(jnp.float32))


def _torch_attn(p, x, mask, fields, impl, dtype):
    cfg = ArchConfig(**fields)
    b, s, _ = x.shape
    pos = torch.arange(s).expand(b, s)
    out = tattn.attention(interop.from_numpy(p, "cpu"), cfg,
                          torch.tensor(x).to(getattr(torch, dtype)), pos,
                          impl=impl, key_mask=None if mask is None
                          else torch.tensor(mask))
    return out.float().numpy()


@pytest.mark.parametrize("port_impl", ["naive", "chunked", "flash"])
@pytest.mark.parametrize("s", [16, 49])
@pytest.mark.parametrize("heads,kv", [(4, 4), (4, 2)])
def test_backends_match_reference(port_impl, s, heads, kv):
    p, x, mask = _inputs(heads, kv, s, True, seed=s + heads + kv)
    fields = _fields(heads, kv)
    out_t = _torch_attn(p, x, mask, fields, port_impl, "float32")
    for jax_impl in ("naive", "pallas"):
        out_j = _jax_attn(p, x, mask, fields, jax_impl, jnp.float32)
        np.testing.assert_allclose(out_t, out_j, **TOL["float32"],
                                   err_msg=f"{port_impl} vs {jax_impl}")


@pytest.mark.parametrize("port_impl", ["naive", "flash"])
def test_bf16_backends_match_reference(port_impl):
    p, x, mask = _inputs(4, 4, 49, True, seed=7)
    fields = _fields(4, 4)
    out_t = _torch_attn(p, x, mask, fields, port_impl, "bfloat16")
    out_j = _jax_attn(p, x, mask, fields, "pallas", jnp.bfloat16)
    np.testing.assert_allclose(out_t, out_j, **TOL["bfloat16"])


@pytest.mark.parametrize("causal,window", [(True, None), (True, 16),
                                           (False, None)])
def test_masked_variants_match_reference(causal, window):
    p, x, _ = _inputs(4, 2, 49, False, seed=11)
    fields = _fields(4, 2, causal=causal, window=window)
    out_j = _jax_attn(p, x, None, fields, "naive", jnp.float32)
    for impl in ("naive", "chunked", "flash"):
        np.testing.assert_allclose(
            _torch_attn(p, x, None, fields, impl, "float32"), out_j,
            **TOL["float32"], err_msg=impl)


def _bh_inputs(bh, s, d, seed, dtype):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((bh, s, d)).astype(np.float32)
               for _ in range(3))
    lens = rng.integers(1, s + 1, bh)
    bias = np.where(np.arange(s)[None, :] < lens[:, None], 0.0,
                    fa_ops.NEG_INF).astype(np.float32)
    j = [jnp.asarray(a, dtype) for a in (q, k, v)]
    t = [torch.tensor(a).to(getattr(torch, jnp.dtype(dtype).name))
         for a in (q, k, v)]
    return j, t, bias


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("s,causal,window,biased", [
    (16, False, None, True),     # text tower: padding bias
    (49, False, None, False),    # ragged image-like sequence
    (49, True, None, True),      # key 0 stays valid for every row
    (48, True, 16, False),
])
def test_flash_plain_matches_flash_fwd_bh(s, causal, window, biased, dtype):
    (qj, kj, vj), (qt, kt, vt), bias = _bh_inputs(6, s, 64, s, dtype)
    out_j, lse_j = flash_fwd_bh(qj, kj, vj,
                                jnp.asarray(bias) if biased else None,
                                causal=causal, window=window,
                                block_q=s if s % 8 else 16,
                                block_k=s if s % 8 else 16, interpret=True)
    out_t, lse_t = fa_ops.flash_fwd(qt, kt, vt,
                                    torch.tensor(bias) if biased else None,
                                    causal=causal, window=window)
    name = jnp.dtype(dtype).name
    assert out_t.dtype == qt.dtype and lse_t.dtype == torch.float32
    np.testing.assert_allclose(out_t.float().numpy(),
                               np.asarray(out_j.astype(jnp.float32)),
                               **TOL[name])
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j),
                               **TOL["float32"])


def test_flash_grouped_heads_and_bias_rows():
    """kv row i // group and bias row i // heads, as the kernel maps them,
    equal the reference's explicit repeat."""
    rng = np.random.default_rng(5)
    b, h, kv, s, d = 2, 4, 2, 12, 64
    q = torch.tensor(rng.standard_normal((b * h, s, d)).astype(np.float32))
    k, v = (torch.tensor(rng.standard_normal((b * kv, s, d))
                         .astype(np.float32)) for _ in range(2))
    bias = torch.zeros((b, s))
    bias[1, 7:] = fa_ops.NEG_INF
    out, lse = flash_fwd_ref(q, k, v, bias, causal=False)
    out_r, lse_r = flash_fwd_ref(q, k.repeat_interleave(h // kv, 0),
                                 v.repeat_interleave(h // kv, 0),
                                 bias.repeat_interleave(h, 0), causal=False)
    torch.testing.assert_close(out, out_r)
    torch.testing.assert_close(lse, lse_r)


def test_padded_keys_do_not_leak():
    p, x, mask = _inputs(4, 4, 16, True, seed=3)
    fields = _fields(4, 4)
    x2 = x.copy()
    x2[1, 5:] = 100.0            # garbage in example 1's padded positions
    a = _torch_attn(p, x, mask, fields, "flash", "float32")
    b = _torch_attn(p, x2, mask, fields, "flash", "float32")
    np.testing.assert_allclose(a[1, :5], b[1, :5], rtol=1e-6, atol=1e-6)


def test_resolve_backend():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert tattn.resolve_backend("pallas", cpu) == "flash"
    assert tattn.resolve_backend("pallas", cuda) == "flash"
    assert tattn.resolve_backend("auto", cpu) == "chunked"
    assert tattn.resolve_backend(None, cuda) == "flash"
    assert tattn.resolve_backend("naive", cuda) == "naive"
    # no TPU tiling rule: head_dim 64 and seq 196 stay on the kernel
    assert set(tattn.available_backends()) == {"naive", "chunked", "flash"}
    with pytest.raises(KeyError):
        tattn.resolve_backend("nope", cpu)


def test_flash_wrapper_validates():
    q = torch.zeros((4, 8, 64))
    with pytest.raises(ValueError):
        fa_ops.flash_fwd(q, torch.zeros((3, 8, 64)), torch.zeros((3, 8, 64)))
    with pytest.raises(ValueError):
        fa_ops.flash_fwd(q, q, q, torch.zeros((4, 9)))
    with pytest.raises(ValueError):
        fa_ops.flash_fwd(q, q, q, window=0)
    # a meta tensor launches nothing: the outputs' shapes and dtypes (the
    # dry run's branch), after the same checks
    meta = torch.zeros((4, 8, 64), device="meta")
    out, lse = fa_ops.flash_fwd(meta, meta, meta)
    assert out.is_meta and out.shape == (4, 8, 64) and lse.shape == (4, 8)
    assert lse.dtype == torch.float32
    with pytest.raises(ValueError):
        fa_ops.flash_fwd(meta, meta, meta, window=0)


def test_encode_tower_backends_agree():
    """Whole-tower check through transformer.encode on a smoke text tower
    with padding: naive, chunked and flash agree."""
    from repro_torch.configs import get_arch, smoke_variant
    from repro_torch.models import transformer as tf
    base = smoke_variant(get_arch("basic-s").text_tower)
    params = tf.init_params(base, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.tensor(rng.integers(1, base.vocab, (3, 24))),
             "attn_mask": torch.tensor(np.arange(24)[None, :]
                                       < np.array([[24], [9], [16]]))}
    outs = {impl: tf.encode(dataclasses.replace(base, attn_impl=impl),
                            params, batch)
            for impl in ("naive", "chunked", "flash")}
    for impl in ("chunked", "flash"):
        torch.testing.assert_close(outs[impl], outs["naive"], rtol=2e-5,
                                   atol=2e-5)
