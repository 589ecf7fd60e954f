"""The error argument of the split 3×TF32 products, emulated in numpy.

The f32 flash-attention kernels (``flash_attention/csrc/flash_fwd.cu``,
``flash_bwd.cu``) run every product on the tensor cores as split 3×TF32:
each fp32 operand x becomes hi = rna(x) and lo = rna(x − hi), both tf32
(10 explicit mantissa bits, rounded to nearest with ties away), and a·b is
ah·bl + al·bh + ah·bh summed into an fp32 accumulator, the small products
first, one 8-deep k-step of the mma at a time. Here that arithmetic is
emulated exactly (tf32 products are exact in fp64; each k-step's three
partial sums round into the fp32 accumulator) at the towers' shapes:

- the split reconstructs x to 2^-22 of |x|, and hi, lo are tf32 values;
- each of the seven products (q·kᵀ, p·v; kᵀ·q... the backward's sᵀ, dpᵀ,
  dv, dk, dq) stays within the bound 3·2^-22 per term plus the fp32
  accumulator's rounding, (3·n/8 + 1)·2^-24, of |A|·|B|, where plain TF32
  (one product of the rounded operands) does not;
- the forward and backward built from those products keep out and lse
  within 5e-5 and dq, dk, dv within 2e-4 of the fp64 result, the limits the
  kernels are held to on the card (``chip_smoke.py``'s FLASH_TOL and
  FLASH_BWD_TOL), and plain TF32 breaks them.
"""
import numpy as np
import pytest

NEG_INF = -1e30


def rna_tf32(x):
    """fp32 -> tf32, to nearest with ties away from zero (cvt.rna)."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    """(hi, lo) tf32 halves of fp32 ``x``."""
    x = np.asarray(x, dtype=np.float32)
    hi = rna_tf32(x)
    return hi, rna_tf32(x - hi)


def mm_3xtf32(a, b):
    """a (..., m, n) · b (..., n, p) as the kernels' mma chain computes it:
    per 8-deep k-step, ah·bl, then al·bh, then ah·bh, each summed exactly
    and rounded into the fp32 accumulator."""
    (ah, al), (bh, bl) = split(a), split(b)
    n = a.shape[-1]
    c = np.zeros(a.shape[:-1] + b.shape[-1:], dtype=np.float32)
    for k0 in range(0, n, 8):
        ks = slice(k0, k0 + 8)
        for x, y in ((ah, bl), (al, bh), (ah, bh)):
            part = np.matmul(x[..., ks].astype(np.float64),
                             y[..., ks, :].astype(np.float64))
            c = (c.astype(np.float64) + part).astype(np.float32)
    return c


def mm_tf32(a, b):
    """Plain TF32: one product of the rounded operands, fp32 accumulator."""
    a, b = rna_tf32(a), rna_tf32(b)
    n = a.shape[-1]
    c = np.zeros(a.shape[:-1] + b.shape[-1:], dtype=np.float32)
    for k0 in range(0, n, 8):
        ks = slice(k0, k0 + 8)
        part = np.matmul(a[..., ks].astype(np.float64),
                         b[..., ks, :].astype(np.float64))
        c = (c.astype(np.float64) + part).astype(np.float32)
    return c


def mm_exact(a, b):
    return np.matmul(np.asarray(a, np.float64), np.asarray(b, np.float64))


def attention(q, k, v, bias, dout, mm):
    """out, lse, dq, dk, dv of flash attention (no causal mask) with every
    product taken by ``mm``; the rest in the dtype of ``mm``'s result."""
    d = q.shape[-1]
    scale = d ** -0.5
    ft = np.float64 if mm is mm_exact else np.float32
    s = mm(q, np.swapaxes(k, -1, -2)).astype(ft) * ft(scale) + bias
    m = s.max(-1, keepdims=True)
    e = np.exp(s - m)
    lse = (m + np.log(e.sum(-1, keepdims=True)))[..., 0]
    p = np.exp(s - lse[..., None]).astype(ft)
    out = mm(p, v).astype(ft)
    delta = (dout.astype(ft) * out).sum(-1)
    # the backward's sᵀ = k·qᵀ and dpᵀ = v·doutᵀ, transposed back
    st = mm(k, np.swapaxes(q, -1, -2)).astype(ft) * ft(scale)
    pt = np.exp(st + np.swapaxes(bias, -1, -2) - lse[..., None, :])
    dpt = mm(v, np.swapaxes(dout, -1, -2)).astype(ft)
    dst = (pt * (dpt - delta[..., None, :])).astype(ft)
    dv = mm(pt.astype(ft), dout).astype(ft)
    dk = mm(dst, q).astype(ft) * ft(scale)
    dq = mm(np.swapaxes(dst, -1, -2), k).astype(ft) * ft(scale)
    return {"out": out, "lse": lse, "dq": dq, "dk": dk, "dv": dv}


# (label, heads, s = t, d, key lengths or None): the towers' shapes
SHAPES = [("image", 2, 196, 64, None), ("text", 8, 16, 64, [1, 5, 16, 9])]
LIMITS = {"out": 5e-5, "lse": 5e-5, "dq": 2e-4, "dk": 2e-4, "dv": 2e-4}


def _inputs(heads, s, d, lens, seed):
    rng = np.random.default_rng(seed)
    q, k, v, dout = (rng.standard_normal((heads, s, d)).astype(np.float32)
                     for _ in range(4))
    bias = np.zeros((heads, 1, s), np.float32)
    if lens is not None:   # key padding, one length per head
        for h in range(heads):
            bias[h, 0, lens[h % len(lens)]:] = NEG_INF
    return q, k, v, bias, dout


@pytest.mark.parametrize("scale", [1.0, 1e-3, 3e4])
def test_split_reconstructs_fp32(scale):
    x = (np.random.default_rng(0).standard_normal(4096) * scale
         ).astype(np.float32)
    hi, lo = split(x)
    for part in (hi, lo):
        assert not (part.view(np.uint32) & np.uint32(0x1FFF)).any()
    err = np.abs(hi.astype(np.float64) + lo - x.astype(np.float64))
    assert (err <= 2.0 ** -22 * np.abs(x)).all()
    # plain TF32 keeps only hi: about 2^-12 of |x|
    assert np.abs(hi.astype(np.float64) - x).max() > 2.0 ** -16 * np.abs(
        x).max()


@pytest.mark.parametrize("label,heads,s,d,lens", SHAPES)
@pytest.mark.parametrize("product", ["q·kᵀ", "p·v", "k·qᵀ", "v·doutᵀ",
                                     "pᵀ·dout", "dsᵀ·q", "ds·k"])
def test_products_stay_within_the_split_bound(product, label, heads, s, d,
                                              lens):
    q, k, v, bias, dout = _inputs(heads, s, d, lens, 1)
    ref = attention(q, k, v, bias, dout, mm_exact)
    p = np.exp(mm_exact(q, np.swapaxes(k, -1, -2)) * d ** -0.5 + bias
               - ref["lse"][..., None]).astype(np.float32)
    ds = (p * (mm_exact(dout, np.swapaxes(v, -1, -2))
               - (dout * ref["out"]).sum(-1)[..., None])).astype(np.float32)
    a, b = {"q·kᵀ": (q, np.swapaxes(k, -1, -2)), "p·v": (p, v),
            "k·qᵀ": (k, np.swapaxes(q, -1, -2)),
            "v·doutᵀ": (v, np.swapaxes(dout, -1, -2)),
            "pᵀ·dout": (np.swapaxes(p, -1, -2), dout),
            "dsᵀ·q": (np.swapaxes(ds, -1, -2), q),
            "ds·k": (ds, k)}[product]
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    n = a.shape[-1]
    size = mm_exact(np.abs(a), np.abs(b))
    bound = (3 * 2.0 ** -22 + (3 * n / 8 + 1) * 2.0 ** -24) * size
    exact = mm_exact(a, b)
    assert (np.abs(mm_3xtf32(a, b) - exact) <= bound).all()
    assert (np.abs(mm_tf32(a, b) - exact) > bound).any()


@pytest.mark.parametrize("label,heads,s,d,lens", SHAPES)
def test_attention_holds_the_f32_limits_only_with_the_split(label, heads, s,
                                                            d, lens):
    q, k, v, bias, dout = _inputs(heads, s, d, lens, 2)
    ref = attention(q, k, v, bias, dout, mm_exact)
    split_out = attention(q, k, v, bias, dout, mm_3xtf32)
    plain_out = attention(q, k, v, bias, dout, mm_tf32)
    worst = 0.0
    for name, limit in LIMITS.items():
        err = np.abs(split_out[name] - ref[name]).max()
        assert err <= limit, f"{name}: {err:.3g} > {limit}"
        worst = max(worst, np.abs(plain_out[name] - ref[name]).max() / limit)
    assert worst > 1.0
