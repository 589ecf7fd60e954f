"""Paper §4.2: accumulate microbatch gradients straight into the optimizer's
moment slots, so the averaged gradient ḡ is never allocated (port of
``repro/core/moment_accum.py``).

First moment (exact): v1 ← β1·v1 + (1-β1)·ḡ is decomposed into K
sequential updates v1 ← k_i·v1 + ((1-β1)/K)·c_i with k_1 = β1 and k_i = 1
otherwise. (The paper's displayed k_i has a typo: "1/K" as the carry factor
would shrink the history geometrically; the decomposition scales the
increment by 1/K.)

Second moment (approximate): only Σc_i²/K = E[c²] can be accumulated, but
Adam wants ḡ² = E[c]². The gap is Var[c] (paper Eq. 4), estimated from the
per-replica gradients d_1..d_R of each microbatch: Var[c] = Var[d]/R. So

    v2 ← β2·v2 + (1-β2)·(E[c²] − VarHat[c])

The functions take slot trees and a stream of microbatch gradients (leaves
(K, ...)) and return fresh trees; ``optim/adafactorw.py`` wires them into
AdaFactorW.
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_map


def accumulate_first_moment(v1, c_stream, beta1: float):
    """v1 slots + stacked microbatch grads c_stream (K, ...) -> new v1,
    equal to beta1·v1 + (1-beta1)·mean_K(c)."""
    k = tree_leaves(c_stream)[0].shape[0]
    for i in range(k):
        carry = beta1 if i == 0 else 1.0
        v1 = tree_map(lambda v, c, i=i, carry=carry:
                      carry * v + ((1 - beta1) / k) * c[i], v1, c_stream)
    return v1


def accumulate_second_moment(v2, c_stream, beta2: float, var_hat=None):
    """v2 slots + c_stream (K, ...) -> new v2 with the paper's estimator:
    beta2·v2 + (1-beta2)·(mean_K(c²) − var_hat). ``var_hat`` defaults to
    none (uncorrected); pass ``replica_variance``'s output for the
    corrected form."""
    k = tree_leaves(c_stream)[0].shape[0]
    e_c2 = tree_map(torch.zeros_like, v2)
    for i in range(k):
        e_c2 = tree_map(lambda e, c, i=i: e + (c[i] * c[i]) / k, e_c2,
                        c_stream)
    if var_hat is not None:
        e_c2 = tree_map(lambda a, b: torch.clamp(a - b, min=0.0), e_c2,
                        var_hat)
    return tree_map(lambda v, e: beta2 * v + (1 - beta2) * e, v2, e_c2)


def replica_variance(d_stream, R: int):
    """Per-replica gradients d_stream with leaves (K, R, ...) -> VarHat[c]
    = Var[d]/R (paper Eq. 4), averaged over the K microbatches."""
    def per_leaf(d):
        c = torch.mean(d, dim=1, keepdim=True)            # (K, 1, ...)
        var_d = torch.mean((d - c) ** 2, dim=1)           # (K, ...)
        return torch.mean(var_d, dim=0) / R
    return tree_map(per_leaf, d_stream)


def exact_second_moment(v2, c_stream, beta2: float):
    """The ground truth, which allocates ḡ: beta2·v2 +
    (1-beta2)·mean_K(c)²."""
    gbar = tree_map(lambda c: torch.mean(c, dim=0), c_stream)
    return tree_map(lambda v, g: beta2 * v + (1 - beta2) * g * g, v2, gbar)
