"""The paper's §5.1 weight sharding in the port, on spawned gloo worlds.

``launch.mesh.make_local_mesh(model=M)`` lays R ranks out as the (R / M,
M) grid of ``jax.make_mesh``; each of its three groups (batch, data,
model) must gather, reduce and scatter over the right ranks.
``core.weight_sharding``'s gather ``Function`` must give the whole leaf
and, as its gradient, the model group's summed gradient cut to the
rank's part, as whole-leaf autograd does. AdaFactorW on parts must take
the reference's step on the whole leaf: factored by the whole shape
(a (2, 256, 256) leaf split four ways has 64-column parts, below
``factored_threshold`` 128), its row / column means and its RMS clip
(clamped here, on heavy-tailed gradients) over the whole leaf, for
``update`` and ``update_from_microbatches``. The trainer's state must be
1/M of every split leaf and of its first moment, in bytes, with gradients
that come back as parts, and a checkpoint saved at one model extent must
restore at another bit for bit.
"""
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim.adafactorw import AdaFactorW as JAdaFactorW
from repro.optim.adafactorw import apply_updates as japply
from repro_torch import checkpoint as ckpt
from repro_torch.configs import get_arch, smoke_dual_variant
from repro_torch.core import sharding as shd
from repro_torch.interop import init_params
from repro_torch.launch import steps as st
from repro_torch.launch import train_distributed as td
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.spawn import run_world
from repro_torch.optim.adafactorw import apply_updates
from repro_torch.tree import leaves, tree_leaves, tree_map

sys.path.insert(0, os.path.dirname(__file__))

from torch_spawn import (worker_adafactor, worker_checkpoint,  # noqa: E402
                         worker_grid)

GRIDS = [(1, 2), (2, 2), (1, 4)]
LR = 1e-2


def _rdv(tmp_path):
    return str(tmp_path / "rdv")


def _smoke():
    return smoke_dual_variant(get_arch("basic-s"))


def test_apply_is_update_then_apply_updates_releasing_each_gradient():
    """``AdaFactorW.apply`` gives ``update`` + ``apply_updates`` bit for
    bit, and sets each gradient's entry to None once used."""
    opt = st.make_optimizer()
    params, state = td.build_state(_smoke(), opt, 0, "cpu")
    rng = torch.Generator().manual_seed(1)

    def grads():
        return tree_map(lambda p: torch.randn(p.shape, generator=rng),
                        params)
    g = grads()
    g_copy = tree_map(torch.clone, g)
    want_u, want_state = opt.update(g_copy, state, params, 1e-3)
    got_p, got_state = opt.apply(g, state, params, 1e-3)
    assert all(x is None for x in tree_leaves(g))
    for (pa, a), (pb, b) in zip(leaves((apply_updates(params, want_u),
                                        want_state)),
                                leaves((got_p, got_state))):
        assert pa == pb and torch.equal(a, b), pa


def _gather_cases(data, model):
    rng = np.random.default_rng(model)
    return [(rng.standard_normal(SHAPE).astype(np.float32), dim,
             rng.standard_normal([data * model] + SHAPE).astype(np.float32))
            for dim in range(len(SHAPE))]


SHAPE = [4, 8, 12]


@pytest.fixture(scope="module", params=GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def grid(request, tmp_path_factory):
    """((data, model), each rank's ``worker_grid`` results): one spawned
    world per grid for the mesh, gather and resident-state checks."""
    data, model = request.param
    rdv = str(tmp_path_factory.mktemp("rdv"))
    return (data, model), run_world(worker_grid, data * model, rdv, model,
                                    _gather_cases(data, model), timeout=180)


def test_mesh_groups_and_collectives(grid):
    """Rank r sits at (r // M, r % M); the batch group is every rank in
    order, the data group the ranks of one model index, the model group
    those of one data index, and each axis's collectives run over its
    own ranks."""
    (data, model), out = grid
    world = data * model
    for r, rec in enumerate(o["mesh"] for o in out):
        d, m = divmod(r, model)
        assert rec["index"] == (d, m, r)
        assert rec["sizes"] == (data, model, world)
        groups = {"batch": list(range(world)),
                  "data": [e * model + m for e in range(data)],
                  "model": [d * model + e for e in range(model)]}
        for name, ranks in groups.items():
            got = rec[name]
            assert got["gather"] == [float(x) for x in ranks]
            assert got["sum"] == float(sum(ranks))
            assert got["max"] == float(max(ranks))
            own = ranks.index(r)
            assert got["scatter"] == [float(own * sum(x + 1 for x in ranks))]
        total = float(sum(range(world)))
        assert rec["tree"] == {"a": [[total] * 3],
                               "b": [[total], [total + world]]}


def test_gather_function_matches_whole_leaf_autograd(grid):
    """Split along each dim of a 3-D leaf: the gathered leaf is the whole
    leaf bit for bit; the gradient of a part is the whole leaf's gradient
    of Σ_r upstream_r · W over the model group's ranks (whole-leaf
    autograd), cut to the part."""
    (data, model), out = grid
    cases = _gather_cases(data, model)
    for r, got in enumerate(o["gather"] for o in out):
        d, m = divmod(r, model)
        for (whole, dim, up), (full, g) in zip(cases, got):
            np.testing.assert_array_equal(full, whole)
            w = torch.from_numpy(whole).requires_grad_()
            loss = sum(torch.sum(w * torch.from_numpy(up[d * model + e]))
                       for e in range(model))
            (gw,) = torch.autograd.grad(loss, w)
            b = SHAPE[dim] // model
            want = gw.numpy().take(range(m * b, (m + 1) * b), axis=dim)
            np.testing.assert_allclose(g, want, rtol=1e-6, atol=1e-6)


# AdaFactorW leaves: name -> (whole shape, dim split at M 2, at M 4)
LEAVES = {"a": ((2, 256, 256), 2, 2),     # factored; 64 columns at M 4
          "b": ((2, 256, 192), 1, 1),     # factored, rows split
          "c": ((96, 256), 1, 1),         # 96 < 128 rows: full second moment
          "e": ((4, 128, 256), 0, 0),     # factored, a leading dim split
          "n": ((64,), None, None)}       # 1-D, whole on every rank


def _adafactor_case():
    rng = np.random.default_rng(0)

    def draw(shape, heavy=False):
        x = rng.standard_normal(shape)
        if heavy:
            x = x * np.exp(2.0 * rng.standard_normal(shape))
        return x.astype(np.float32)
    params = {k: draw(s) for k, (s, _, _) in LEAVES.items()}
    grads = [{k: draw(s, heavy=k == "a") for k, (s, _, _) in LEAVES.items()}
             for _ in range(2)]
    stream = {k: draw((3,) + s, heavy=k == "a")
              for k, (s, _, _) in LEAVES.items()}
    return params, grads, stream


def _reference_adafactor(params, grads, stream, clip=1.0):
    opt = JAdaFactorW(weight_decay=0.0025, clip_threshold=clip)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(p)
    for g in grads:
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                state, p, LR)
        p = japply(p, upd)
    after = (p, state)
    upd, state = opt.update_from_microbatches(
        {k: jnp.asarray(v) for k, v in stream.items()}, state, p, LR)
    return after, (japply(p, upd), state)


def _joined(parts, dim):
    return parts[0] if dim is None else np.concatenate(parts, axis=dim)


@pytest.mark.parametrize("model", [2, 4])
def test_adafactorw_on_parts_matches_the_reference(model, tmp_path):
    params, grads, stream = _adafactor_case()
    col = 1 if model == 2 else 2
    dims = {k: v[col] for k, v in LEAVES.items()}
    out = run_world(worker_adafactor, model, _rdv(tmp_path), model, params,
                    grads, stream, dims, LR, timeout=120)
    ref = _reference_adafactor(params, grads, stream)
    # the RMS clip clamps leaf "a": without it the update differs
    loose = _reference_adafactor(params, grads, stream, clip=1e9)
    assert not np.allclose(np.asarray(ref[0][0]["a"]),
                           np.asarray(loose[0][0]["a"]), rtol=1e-3)
    for stage in (0, 1):
        jp, js = ref[stage]
        for k, (shape, *_) in LEAVES.items():
            d = dims[k]
            nd = len(shape)
            factored = nd >= 2 and shape[-1] >= 128 and shape[-2] >= 128
            row_dim = None if d is None or (factored and d == nd - 1) else d
            col_dim = None if not factored or d in (None, nd - 2) else (
                nd - 2 if d == nd - 1 else d)
            got = {name: _joined([r[stage][name][k] for r in out], dd)
                   for name, dd in (("params", d), ("m", d),
                                    ("v_row", row_dim), ("v_col", col_dim))}
            assert got["v_col"].shape == np.shape(js.v_col[k]), k
            # f32 params of |p| <= 5 round at <= 5e-7, their moves are ~1e-2
            moved = np.abs(np.asarray(jp[k]) - params[k]).max()
            np.testing.assert_allclose(got["params"], np.asarray(jp[k]),
                                       rtol=0, atol=1e-4 * moved, err_msg=k)
            for name, want in (("v_row", js.v_row[k]),
                               ("v_col", js.v_col[k])):
                np.testing.assert_allclose(got[name], np.asarray(want),
                                           rtol=1e-5, atol=0, err_msg=k)
            # bf16 storage: one rounding flip moves m by <= 2^-8 of its size
            m_want = np.asarray(js.m[k], dtype=np.float32)
            np.testing.assert_allclose(got["m"], m_want, rtol=0,
                                       atol=2 ** -8 * np.abs(m_want).max(),
                                       err_msg=k)


def test_each_rank_holds_a_share_of_every_split_leaf(grid):
    """``basic_ws``: per rank, the params and the first moment are 1/M of
    every leaf ``params_specs`` splits plus the whole leaves, in bytes;
    the optimizer state is less than the whole state; one GradAccum
    step's gradients come back as parts. ``replicated`` keeps every leaf
    whole."""
    (data, model), out = grid
    cfg = _smoke()
    whole = init_params(cfg, torch.Generator(), "meta")
    specs = dict(shd.spec_leaves(shd.params_specs(
        whole, Mesh({"data": data, "model": model}), "basic_ws")))
    split = {p for p, s in specs.items() if "model" in s}
    want_params = want_m = 0
    for path, x in leaves(whole):
        share = model if path in split else 1
        want_params += x.numel() * 4 // share
        want_m += x.numel() * 2 // share
    whole_state = sum(x.numel() * x.element_size()
                      for _, x in leaves(st.make_optimizer().init(whole)))
    for rec in (o["resident"]["basic_ws"] for o in out):
        assert set(rec["split"]) == split and split
        assert rec["params_bytes"] == want_params
        m_bytes = sum(int(np.prod(s)) * 2 for s in rec["m"].values())
        assert m_bytes == want_m
        assert want_m < rec["state_bytes"] < whole_state
        assert rec["grads"] == rec["params"] == rec["m"]
        for path, x in leaves(whole):
            shape = list(x.shape)
            if path in split:
                shape[list(specs[path]).index("model")] //= model
            assert rec["params"][path] == tuple(shape), path
    for rec in (o["resident"]["replicated"] for o in out):
        assert rec["split"] is None
        assert rec["params_bytes"] == sum(x.numel() * 4
                                          for _, x in leaves(whole))
        assert rec["state_bytes"] == whole_state


def _index(d):
    import json
    with open(os.path.join(d, "step_00000001", "index.json")) as f:
        return json.load(f)


def test_checkpoints_cross_model_extents_bit_for_bit(tmp_path):
    """The seeded state saved at M 2 (whole leaves gathered over the model
    group) is the file the same state saved at M 1 is, leaf for leaf and
    hash for hash; restored at M 1 it is the whole state, and the M 1
    checkpoint restored at M 2 gives each rank its exact parts."""
    cfg = _smoke()
    opt = st.make_optimizer()
    params, state = td.build_state(cfg, opt, 0, "cpu")
    one, two = str(tmp_path / "m1"), str(tmp_path / "m2")
    ckpt.save(one, 1, (params, state))
    out = run_world(worker_checkpoint, 2, _rdv(tmp_path), 2, two, one,
                    timeout=120)
    assert _index(one) == _index(two)
    for i, rec in enumerate(_index(one)["leaves"]):
        a = np.load(os.path.join(one, "step_00000001", f"arr_{i}.npy"))
        b = np.load(os.path.join(two, "step_00000001", f"arr_{i}.npy"))
        assert a.tobytes() == b.tobytes(), i
    back = ckpt.restore(two, 1, (params, state), device="cpu")
    for (pa, a), (pb, b) in zip(leaves((params, state)), leaves(back)):
        assert pa == pb and torch.equal(a, b), pa
    mesh2 = Mesh({"data": 1, "model": 2})
    specs = shd.params_specs(params, mesh2, "basic_ws")
    split = dict(shd.spec_leaves(specs))
    for rank, (start, parts) in enumerate(out):
        assert start == 1
        for path, x in leaves(params):
            want = x.numpy()
            spec = split[path]
            if "model" in spec:
                d = list(spec).index("model")
                b = x.shape[d] // 2
                want = want.take(range(rank * b, (rank + 1) * b), axis=d)
            np.testing.assert_array_equal(parts["0/" + path], want, path)
