"""The port's cross-shard global-batch loss against the reference.

The same seeded numpy embeddings go through the reference's single-device
fused loss (Pallas in interpret mode, ``jax.value_and_grad``) and through
the port's ``allgather`` and ``chunked`` losses on 2 and 4 spawned gloo
ranks (``tests/torch_spawn.py``), each rank holding its rows. The ranks'
dX / dY blocks concatenate to the global gradients and their dlog_tau
partials sum to the whole (``core/distributed_loss.py``'s convention).
Limits: f32 loss rtol 2e-6, gradients rtol 1e-5 / atol 1e-6 (the
reference's own, ``tests/distributed_checks.py:79-83``, ``:99-103``); bf16
loss 1e-3, dX and dY 2e-2 and within 2^-6 of their max |ref| (one bf16
rounding of the largest entry is 2^-8 of it). One world per rank count
serves every case.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.contrastive_loss import ops as jops
from repro_torch.core import distributed_loss as dl
from repro_torch.core.contrastive import fused_kernel_loss
from repro_torch.kernels.contrastive_loss import ops as tops
from repro_torch.launch.mesh import Mesh, make_local_mesh
from repro_torch.launch.spawn import run_world

sys.path.insert(0, os.path.dirname(__file__))

from torch_spawn import worker_losses  # noqa: E402

B, D, LOG_TAU = 32, 16, -1.2
METHODS = ("allgather", "chunked")
DTYPES = ("float32", "bfloat16")


def _unit(rng, b, d):
    x = rng.standard_normal((b, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    return _unit(rng, B, D), _unit(rng, B, D)


def _reference(x, y, dtype):
    """The reference's single-device fused loss and its gradients, as
    float32 numpy."""
    dt = jnp.dtype(dtype)
    loss, grads = jax.value_and_grad(
        lambda a, b, t: jops.fused_contrastive_loss(a, b, t, True),
        argnums=(0, 1, 2))(jnp.asarray(x, dt), jnp.asarray(y, dt),
                           jnp.asarray(LOG_TAU, jnp.float32))
    return (np.float32(loss),) + tuple(np.asarray(g, np.float32)
                                       for g in grads)


@pytest.fixture(scope="module")
def worlds(data, tmp_path_factory):
    """{R: the ranks' results} for R = 2 and 4, every case in one world."""
    x, y = data
    cases = {(m, d): (m, d, x, y, LOG_TAU) for m in METHODS for d in DTYPES}
    tmp = str(tmp_path_factory.mktemp("worlds"))
    return {r: run_world(worker_losses, r, tmp, cases, timeout=240)
            for r in (2, 4)}


def _check(got, want, dtype):
    loss, dx, dy, dtau = got
    w_loss, w_dx, w_dy, w_dtau = want
    if dtype == "float32":
        np.testing.assert_allclose(loss, w_loss, rtol=2e-6)
        for g, w in ((dx, w_dx), (dy, w_dy), (dtau, w_dtau)):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(loss, w_loss, rtol=1e-3)
        for g, w in ((dx, w_dx), (dy, w_dy)):
            np.testing.assert_allclose(g, w, atol=2e-2)
            assert np.abs(g - w).max() <= 2.0 ** -6 * np.abs(w).max()
        np.testing.assert_allclose(dtau, w_dtau, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("ranks", [2, 4])
def test_cross_shard_loss_matches_the_reference(worlds, data, ranks, method,
                                                dtype):
    res = [r[(method, dtype)] for r in worlds[ranks]]
    losses = [float(r[0]) for r in res]
    assert len(set(losses)) == 1, losses          # one loss on every rank
    got = (res[0][0], np.concatenate([r[1] for r in res]),
           np.concatenate([r[2] for r in res]), sum(r[3] for r in res))
    _check(got, _reference(*data, dtype), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_one_rank_falls_back_to_the_fused_loss(data, dtype):
    """At a data extent of 1 the factory returns the single-device fused
    loss; its value and gradients match the reference's."""
    mesh = make_local_mesh()
    assert mesh.data_size == 1 and not mesh.distributed
    for method in METHODS:
        assert dl.make_global_loss_fn(mesh, method) is fused_kernel_loss
    dt = getattr(torch, dtype)
    x, y = (torch.from_numpy(a).to(dt).requires_grad_() for a in data)
    lt = torch.tensor(LOG_TAU, requires_grad=True)
    loss, metrics = dl.make_global_loss_fn(mesh)(x, y, torch.exp(lt))
    grads = torch.autograd.grad(loss, (x, y, lt))
    assert set(metrics) == {"row_loss", "col_loss", "i2t_top1"}
    _check((loss.item(),) + tuple(g.float().numpy() for g in grads),
           _reference(*data, dtype), dtype)


def test_factory_rejects_unknown_methods_and_rankless_meshes():
    with pytest.raises(ValueError, match="method"):
        dl.make_global_loss_fn(make_local_mesh(), "ring")
    with pytest.raises(ValueError, match="no ranks"):
        dl.make_global_loss_fn(Mesh({"data": 16, "model": 16}), "chunked")
    assert dl.emb_sharding(Mesh({"pod": 2, "data": 16, "model": 16})) == \
        (("pod", "data"), None)


@pytest.mark.parametrize("with_diag", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_chunk_ops_match_the_reference(with_diag, dtype):
    """``chunk_row_col_lse`` / ``chunk_grads`` of one remote chunk (global
    LSE vectors, ``b_norm`` the global batch) against the reference's
    ``chunk_row_col_lse`` / ``chunk_grads`` in interpret mode."""
    rng = np.random.default_rng(11)
    b_l, d, b_g = 16, 8, 64
    x, y = _unit(rng, b_l, d), _unit(rng, b_l, d)
    inv_tau = 2.0
    a = (x @ y.T) * inv_tau
    row_lse = np.log(np.exp(a).sum(1)).astype(np.float32) + 0.3
    col_lse = np.log(np.exp(a).sum(0)).astype(np.float32) + 0.1
    jdt = jnp.dtype(dtype)
    jx, jy = jnp.asarray(x, jdt), jnp.asarray(y, jdt)
    tx, ty = (torch.from_numpy(v).to(getattr(torch, dtype)) for v in (x, y))
    want_lse = jops.chunk_row_col_lse(jx, jy, jnp.asarray(inv_tau),
                                      interpret=True)
    got_lse = tops.chunk_row_col_lse(tx, ty, inv_tau)
    for g, w in zip(got_lse, want_lse):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)
    want = jops.chunk_grads(jx, jy, jnp.asarray(inv_tau),
                            jnp.asarray(row_lse), jnp.asarray(col_lse),
                            b_norm=b_g, with_diag=with_diag, interpret=True)
    got = tops.chunk_grads(tx, ty, inv_tau, torch.from_numpy(row_lse),
                           torch.from_numpy(col_lse), b_norm=b_g,
                           with_diag=with_diag)
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == "float32" else \
        dict(rtol=2e-2, atol=2e-3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w, np.float32),
                                   **tol)
