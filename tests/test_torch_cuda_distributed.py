"""The cross-shard loss's chunk kernels on the card, against their plain
PyTorch versions, and the cross-shard loss on two gloo ranks sharing the
card. Every test here needs a CUDA card and the CUDA toolkit; on a host
without a card they skip (the card is looked for inside a fixture, never
at import). Run them on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_distributed.py

``chunk_row_col_lse`` is one ``fwd_fused`` launch on a (B_local, D) chunk
and ``chunk_grads`` one ``bwd_fused`` launch with ``b_norm`` the global
batch and ``with_diag`` only on the rank's own chunk. Limits as the fused
pair's card tests (tests/test_torch_cuda_train.py): LSE 5e-5 abs; dlog_tau
1e-4 rel in f32, 2e-2 in bf16. dX / dY are held to a share of the
tensor's max |ref|: 1e-5 in f32 (a chunk's gradients at a global
``b_norm`` without the diagonal are a few 1e-6, so the fused pair's 1e-6
absolute limit would be the size of the values), 2^-6 in bf16. The
two-rank loss (gloo stages its collectives through the host) is held
against the single-device fused loss on the card at the reference's
limits (f32 loss rtol 2e-6, gradients rtol 1e-5 / atol 1e-6; bf16 loss
1e-3, dX 2e-2) and, for dX / dY, also within the same share of max |ref|;
each rank launches one forward and one backward kernel for ``allgather``
and one of each per chunk, R, for ``chunked``.
"""
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.kernels.contrastive_loss import ops as cl_ops
from repro_torch.kernels.contrastive_loss.ref import (bwd_fused_ref,
                                                      fwd_fused_ref)
from repro_torch.launch.spawn import run_world

sys.path.insert(0, os.path.dirname(__file__))

from torch_spawn import worker_losses  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch.device import resolve_device
    resolve_device("cuda")
    return torch.Generator(device="cuda").manual_seed(0)


def _unit(n, d, gen, dtype):
    x = torch.randn((n, d), generator=gen, device="cuda")
    return (x / x.norm(dim=1, keepdim=True)).to(dtype)


def _grad_tol(ref, dtype):
    share = 1e-5 if dtype in (torch.float32, "float32") else 2.0 ** -6
    return share * float(abs(ref).max()) + 1e-12


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b_local", [1024, 2048])
def test_chunk_row_col_lse_matches_plain(gen, b_local, dtype):
    x, y = _unit(b_local, 512, gen, dtype), _unit(b_local, 512, gen, dtype)
    inv_tau = torch.tensor(1 / 0.07, device="cuda")
    before = cl_ops.FWD_COUNTER.count
    got = cl_ops.chunk_row_col_lse(x, y, inv_tau)
    assert cl_ops.FWD_COUNTER.count == before + 1
    for g, w in zip(got, fwd_fused_ref(x, y, inv_tau)):
        assert float((g - w).abs().max()) <= 5e-5


@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("with_diag", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b_local", [1024, 2048])
def test_chunk_grads_matches_plain(gen, b_local, dtype, with_diag, ranks):
    x, y = _unit(b_local, 512, gen, dtype), _unit(b_local, 512, gen, dtype)
    inv_tau = torch.tensor(1 / 0.07, device="cuda")
    # global LSEs exceed the chunk's own by the other chunks' mass
    row, col = (v + 0.5 for v in fwd_fused_ref(x, y, inv_tau))
    before = cl_ops.BWD_COUNTER.count
    got = cl_ops.chunk_grads(x, y, inv_tau, row, col, b_norm=ranks * b_local,
                             with_diag=with_diag)
    assert cl_ops.BWD_COUNTER.count == before + 1
    want = bwd_fused_ref(x, y, inv_tau, row, col, b_norm=ranks * b_local,
                         with_diag=with_diag)
    for g, w in zip(got[:2], want[:2]):
        assert float((g - w).abs().max()) <= _grad_tol(w, dtype)
    rel = 1e-4 if dtype == torch.float32 else 2e-2
    assert abs(float(got[2] - want[2])) <= rel * abs(float(want[2]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_shard_loss_on_two_gloo_ranks(gen, dtype, tmp_path):
    rng = np.random.default_rng(3)
    x, y = (rng.standard_normal((512, 512)).astype(np.float32)
            for _ in range(2))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    y /= np.linalg.norm(y, axis=1, keepdims=True)
    dt = getattr(torch, dtype)
    xt, yt = (torch.from_numpy(a).to("cuda", dt).requires_grad_()
              for a in (x, y))
    lt = torch.tensor(-1.2, device="cuda", requires_grad=True)
    loss = cl_ops.fused_contrastive_loss(xt, yt, lt)   # builds the kernels
    want = (float(loss),) + tuple(g.float().cpu().numpy() for g in
                                  torch.autograd.grad(loss, (xt, yt, lt)))
    cases = {m: (m, dtype, x, y, -1.2) for m in ("allgather", "chunked")}
    ranks = run_world(worker_losses, 2, str(tmp_path), cases, "cuda",
                      timeout=300)
    per_method = {"allgather": 1, "chunked": 2}
    for r in ranks:
        for m, n in per_method.items():
            assert r["launches"][m] == {"contrastive_fwd": n,
                                        "contrastive_bwd": n}, r["launches"]
    for m in cases:
        res = [r[m] for r in ranks]
        got = (float(res[0][0]), np.concatenate([r[1] for r in res]),
               np.concatenate([r[2] for r in res]), sum(r[3] for r in res))
        if dtype == "float32":
            np.testing.assert_allclose(got[0], want[0], rtol=2e-6)
            for g, w in zip(got[1:], want[1:]):
                np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_allclose(got[0], want[0], rtol=1e-3)
            np.testing.assert_allclose(got[1], want[1], atol=2e-2)
        for g, w in zip(got[1:3], want[1:3]):
            assert np.abs(g - w).max() <= _grad_tol(w, dtype)
