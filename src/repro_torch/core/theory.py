"""Paper §6 / Theorems 1-2: the generalisation-gap bound and its terms
(port of ``repro/core/theory.py``).

The bound (Thm 1, deep-net case):

    E[ell_M] - Ê_S[ell_B]  ≤  Q1/√m + Q2/√(2B) + c2·√(ln(2/δ)/2m)

``bound_terms`` evaluates the terms from a trained dual encoder's weights
(Frobenius-norm products over tower weights stand in for the M_l);
``empirical_gap`` measures the normalised-loss gap on held-out data.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.contrastive import normalized_train_loss
from repro_torch.tree import tree_leaves


def _weight_matrices(tower_params):
    """All >= 2-D leaves of a tower as fp32 numpy matrices, stacked layer
    leaves taken apart."""
    mats = []
    for x in tree_leaves(tower_params):
        x = np.asarray(x.detach().cpu().float())
        if x.ndim == 2:
            mats.append(x)
        elif x.ndim > 2:
            mats.extend(x.reshape(-1, *x.shape[-2:]))
    return mats


def norm_product(tower_params) -> dict:
    """log of prod_l ||W_l||_F (summed in log space) and the number of
    matrices: ``{'log_prod', 'depth'}``."""
    mats = _weight_matrices(tower_params)
    logs = [float(np.log(np.linalg.norm(m) + 1e-12)) for m in mats]
    return {"log_prod": float(np.sum(logs)), "depth": len(mats)}


def bound_terms(cfg, image_params_and_proj, text_params_and_proj,
                *, m: int, B: int, delta: float = 0.05,
                c_consts: dict = None) -> dict:
    """Thm 1's three terms. The norm products are astronomically loose in
    absolute value (as Rademacher bounds are); the informative output is
    the B- and m-dependence, returned as ``gap_shape`` = 1/√m + 1/√(2B)."""
    c = {"c1": math.e, "c2": 10.0, "c3": 1.0, "c7": 1.0, "c8": 1.0,
         "c9": 1.0, "kappa": 64}
    if c_consts:
        c.update(c_consts)
    img = norm_product(image_params_and_proj)
    txt = norm_product(text_params_and_proj)

    L, Lp = txt["depth"], img["depth"]
    log_q11 = math.log(c["c7"] * (math.sqrt(2 * math.log(2) * L) + 1)) \
        + txt["log_prod"]
    log_q12 = math.log(c["c8"] * (math.sqrt(2 * math.log(2) * Lp) + 1)) \
        + img["log_prod"]
    q21 = 2 * math.sqrt(2) * c["c8"] * c["c9"] + c["c1"] * math.sqrt(
        c["kappa"] * math.log(math.sqrt(c["kappa"] * B) / delta))
    term_m = math.exp(min(log_q11, 700)) + math.exp(min(log_q12, 700))
    term_b = q21  # the norm part of Q2 shares the same product structure

    return {
        "term_1_over_sqrt_m": term_m / math.sqrt(m),
        "term_1_over_sqrt_2B": term_b / math.sqrt(2 * B),
        "term_conf": c["c2"] * math.sqrt(math.log(2 / delta) / (2 * m)),
        "gap_shape": 1 / math.sqrt(m) + 1 / math.sqrt(2 * B),
        "log_norm_product_text": txt["log_prod"],
        "log_norm_product_image": img["log_prod"],
    }


def empirical_gap(x_train, y_train, x_test, y_test) -> float:
    """Empirical E[ell_M] - Ê_S[ell_B] with the paper's normalised losses.

    x/y_*: (N, D) unit-norm embeddings (tensors). The test expectation
    E_y[exp(...)] is estimated over the whole test set (the M→∞
    surrogate)."""
    train = float(torch.mean(normalized_train_loss(x_train, y_train)))
    s = torch.einsum("id,jd->ij", x_test, y_test)
    num = torch.exp(torch.diagonal(s))
    den = torch.mean(torch.exp(s), dim=1)
    test = float(torch.mean(-num / den))
    return test - train
