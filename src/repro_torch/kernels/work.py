"""The hand-written kernels' least work: (bytes, FLOP) of one call, each
input read once and each output written once.

The kernel wrappers record it for ``launch.memstats``
(``kernels.build.record_work``), so that a traced step counts a kernel's
work, not its plain version's; ``launch.roofline`` re-exports it, and
``chip_smoke.py``'s bounds divide it by the card's peaks there.
"""
from __future__ import annotations

import math
from typing import Optional


def attended_pairs(s: int, causal: bool, window: Optional[int] = None,
                   t: Optional[int] = None) -> int:
    """(query, key) pairs one head attends with s queries over t keys (t
    = s by default), under the flash kernels' masks: every pair without a
    mask; causal, key j <= query i (and within ``window`` keys of it)."""
    t = s if t is None else t
    if not causal:
        if window is None:
            return s * t
        return sum(max(0, t - max(0, i - window + 1)) for i in range(s))
    # row i keeps keys max(0, i - w + 1) .. min(i, t - 1): none from
    # i = t + w - 1 on; summed in closed form over the rows before
    n = s if window is None else min(s, t + window - 1)
    m = min(n, t)
    k = 0 if window is None else max(0, n - window + 1)
    return m * (m - 1) // 2 + (n - m) * (t - 1) - k * (k - 1) // 2 + n


def flash_fwd_work(bh: int, bkv: int, s: int, t: int, d: int, item: int, *,
                   causal: bool, window: Optional[int] = None,
                   bias_rows: int = 0):
    """(bytes, FLOP) of ``flash_fwd``: q and out (bh, s, d), k and v (bkv,
    t, d) in ``item``-byte elements, the fp32 lse and key bias; 4·d FLOP an
    attended pair (q·kᵀ and p·v)."""
    nbytes = (2 * bh * s + 2 * bkv * t) * d * item + bh * s * 4 \
        + bias_rows * t * 4
    return nbytes, 4.0 * bh * d * attended_pairs(s, causal, window, t)


def flash_bwd_work(bh: int, bkv: int, s: int, t: int, d: int, item: int, *,
                   causal: bool, window: Optional[int] = None,
                   bias_rows: int = 0):
    """(bytes, FLOP) of ``flash_bwd``: q, out, dout, dq and k, v, dk, dv,
    the lse and the bias; five products of 2·d an attended pair (the q·kᵀ
    recompute, dout·vᵀ, ds·k, dsᵀ·q, pᵀ·dout)."""
    nbytes = (4 * bh * s + 4 * bkv * t) * d * item + bh * s * 4 \
        + bias_rows * t * 4
    return nbytes, 5 * 2.0 * bh * d * attended_pairs(s, causal, window, t)


def contrastive_fwd_work(bx: int, by: int, d: int, item: int):
    """(bytes, FLOP) of the row and column LSE of X·Yᵀ (``fwd_fused``,
    ``row_col_lse``, a chunk): x (bx, d), y (by, d) read, two fp32 LSE
    vectors written; one product, 2·bx·by·d."""
    return (bx + by) * d * item + (bx + by) * 4, 2.0 * bx * by * d


def contrastive_bwd_work(bx: int, by: int, d: int, item: int):
    """(bytes, FLOP) of dX, dY and dlog τ (``bwd_fused``, ``grads``, a
    chunk): x, y and the LSEs read, fp32 dX, dY and dlog τ written; three
    products (the recompute, ds·Y, dsᵀ·X)."""
    return ((bx + by) * d * item + (bx + by) * 4 + (bx + by) * d * 4 + 4,
            3 * 2.0 * bx * by * d)


def decode_work(b: int, h: int, kv: int, t: int, d: int, item: int,
                n_valid: Optional[int] = None, lse: bool = False):
    """(bytes, FLOP) of ``decode_attention``: q and out (b, h, d), the
    bool mask (b, t), and the k and v rows of the ``n_valid`` valid cache
    entries (all b·t by default); 4·d FLOP a query head an entry. With
    ``lse`` the (b, h) fp32 log-sum-exps written too."""
    n_valid = b * t if n_valid is None else n_valid
    fixed = 2 * b * h * d * item + b * t + (4 * b * h if lse else 0)
    return (fixed + 2 * kv * d * item * n_valid,
            4.0 * (h // kv) * d * kv * n_valid)


def topk_work(b: int, n: int, d: int, k: int, item: int = 4,
              n_valid: Optional[int] = None):
    """(bytes, FLOP) of ``similarity_topk``: the b query rows and the
    ``n_valid`` valid class rows read, (b, k) values and ids written;
    2·b·n_valid·d for the scores."""
    nv = n if n_valid is None else n_valid
    return (b + nv) * d * item + b * k * 8, 2.0 * b * nv * d


def ssd_least_flops(b: int, l: int, h: int, p: int, n: int) -> float:
    """The SSD scan's least FLOP count over its chunked forms. At a chunk
    of c tokens, per token and (b, h): the causal half of C·Bᵀ and of its
    product with dt·x, c·(n + p); y's read of the carried state and the
    state's update, 2·n·p each; the state's decay once a chunk, n·p / c.
    c = 1 is the sequential recurrence (``ssd_ref``, ~5·n·p); the least is
    near c = sqrt(n·p / (n + p)), ~4.3·n·p at n 128, p 64."""
    # c·(n + p) + n·p / c is convex in c: its least over 1..l is at one
    # of the two whole chunks beside sqrt(n·p / (n + p))
    best = math.sqrt(n * p / (n + p))
    chunks = {min(l, max(1, c)) for c in (math.floor(best), math.ceil(best))}
    return b * h * l * min(c * (n + p) + 4.0 * n * p + n * p / c
                           for c in chunks)


def ssd_scan_work(b: int, l: int, h: int, p: int, n: int, item: int,
                  init: bool = False):
    """(bytes, FLOP) of ``ssd_scan``: x, B, C in ``item``-byte elements,
    dt, y, A, D and the states in fp32 (the final state, and the initial
    one when given); ``ssd_least_flops``."""
    states = (2 if init else 1) * b * h * p * n * 4
    nbytes = (b * l * h * p * item + b * l * h * 4 + 2 * b * l * n * item
              + b * l * h * p * 4 + states + 2 * h * 4)
    return nbytes, ssd_least_flops(b, l, h, p, n)


def ssd_bwd_work(b: int, l: int, h: int, p: int, n: int, item: int,
                 init: bool = False, dfinal: bool = False):
    """(bytes, FLOP) of ``ssd_scan_bwd``: x, B, C (``item`` bytes), dt,
    dy, the saved states (one per 64-token sub-chunk), the final state
    (and dfinal) read; dx, dB, dC (``item``), ddt, dA, dD (and d_init)
    written; each once. Twice the forward's least work: each product of
    the chunked form has two gradient products."""
    states = b * h * (-(-l // 64) + 1 + (1 if dfinal else 0)) * p * n * 4
    inputs = (b * l * h * p + 2 * b * l * n) * item + b * l * h * 4
    grads = (b * l * h * p + 2 * b * l * n) * item + b * l * h * 4 + 2 * h * 4
    nbytes = (inputs + b * l * h * p * 4 + states + grads
              + (b * h * p * n * 4 * 2 if init else 0) + 2 * h * 4)
    return nbytes, 2 * ssd_least_flops(b, l, h, p, n)
