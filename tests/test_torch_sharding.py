"""The port's sharding rules and meshes against the reference's.

``core.sharding``'s ``params_specs`` / ``batch_specs`` / ``cache_specs``
on the port's abstract (``meta``) trees against the reference's on its
``eval_shape`` trees, for every architecture both packages have, under
``basic_ws`` and ``tp``, on data × model meshes of (16, 16) and (4, 2) and
the multi-pod (2, 16, 16). The reference's meshes are
``AbstractMesh((16, 16), ("data", "model"))`` (jax 0.9 refuses the pair
form). The port's spec has one entry per dim; the reference's ``P()``
leaves trailing dims out, so it is padded with None before comparing.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec

from repro.configs import get_arch as jax_get_arch
from repro.configs import list_archs as jax_list_archs
from repro.core import sharding as jshd
from repro.launch import steps as jsteps
from repro.models import dual_encoder as jde
from repro.models import transformer as jtf
from repro_torch.configs import ArchConfig, get_arch, list_archs
from repro_torch.core import sharding as shd
from repro_torch.interop import init_params
from repro_torch.launch import mesh as tmesh
from repro_torch.models import transformer as ttf

ARCHS = sorted(set(list_archs()) & set(jax_list_archs()))
MESHES = {"16x16": (("data", "model"), (16, 16)),
          "4x2": (("data", "model"), (4, 2)),
          "pod2x16x16": (("pod", "data", "model"), (2, 16, 16))}


def _meshes(name):
    axes, sizes = MESHES[name]
    return (AbstractMesh(sizes, axes),
            tmesh.Mesh(dict(zip(axes, sizes))))


@functools.lru_cache(maxsize=None)
def _abstract(arch):
    """(reference eval_shape params, port meta params) of ``arch``."""
    jcfg, tcfg = jax_get_arch(arch), get_arch(arch)
    if isinstance(tcfg, ArchConfig):
        return jsteps.abstract_params(jcfg), init_params(
            tcfg, torch.Generator(), "meta")
    return (jax.eval_shape(lambda k: jde.init_params(jcfg, k),
                           jax.random.key(0)),
            init_params(tcfg, torch.Generator(), "meta"))


def _ref_leaves(specs, values):
    """{path: spec padded to its leaf's ndim} of a reference spec tree."""
    vals = {jshd._path_str(p): np.ndim(v) for p, v in
            jax.tree_util.tree_leaves_with_path(values)}
    out = {}
    for p, s in jax.tree_util.tree_leaves_with_path(
            specs, is_leaf=lambda s: isinstance(s, PartitionSpec)):
        path = jshd._path_str(p)
        out[path] = tuple(s) + (None,) * (vals[path] - len(s))
    return out


def _same(port_specs, ref_specs, ref_values):
    got = dict(shd.spec_leaves(port_specs))
    want = _ref_leaves(ref_specs, ref_values)
    assert got.keys() == want.keys()
    bad = {p: (got[p], want[p]) for p in want if tuple(got[p]) != want[p]}
    assert not bad, bad


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("mode", ["basic_ws", "tp"])
@pytest.mark.parametrize("arch", ARCHS)
def test_params_specs_match_the_reference(arch, mode, mesh):
    jmesh, tm = _meshes(mesh)
    jparams, tparams = _abstract(arch)
    _same(shd.params_specs(tparams, tm, mode),
          jshd.params_specs(jparams, jmesh, mode), jparams)


def test_model_axis_of_one_replicates_every_param():
    """The port's trainer applies the data axis only: on its local mesh
    (model 1) every rule replicates every leaf."""
    def split(specs):
        return [p for p, s in shd.spec_leaves(specs)
                if any(a is not None for a in s)]
    local = tmesh.make_local_mesh()
    for arch in ("basic-s", "mixtral-8x22b"):
        _, tparams = _abstract(arch)
        for mode in ("basic_ws", "tp", "replicated"):
            assert split(shd.params_specs(tparams, local, mode)) == []
    _, tparams = _abstract("basic-s")
    assert split(shd.params_specs(tparams, tmesh.make_production_mesh(),
                                  "basic_ws"))


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_specs_match_the_reference(mesh):
    jmesh, tm = _meshes(mesh)
    rng = np.random.default_rng(0)
    batch = {"images": {"image": rng.standard_normal((64, 8, 8, 3))},
             "texts": {"tokens": rng.integers(0, 9, (64, 16)),
                       "attn_mask": np.ones((64, 16), bool)},
             "odd": rng.standard_normal((6, 4)), "scalar": np.float32(1)}
    tbatch = jax.tree.map(lambda a: torch.from_numpy(np.asarray(a)), batch)
    _same(shd.batch_specs(tbatch, tm), jshd.batch_specs(batch, jmesh), batch)
    _same(shd.batch_specs(tbatch, tm, batch_axes=("data", "model")),
          jshd.batch_specs(batch, jmesh, batch_axes=("data", "model")),
          batch)


@pytest.mark.parametrize("batch", [16, 1])
@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-130m",
                                  "jamba-1.5-large-398b"])
def test_cache_specs_match_the_reference(arch, batch):
    """Batch over the data axes when it divides, else the cache's sequence
    axis (context parallel), on KV and SSM caches."""
    jcfg, tcfg = jax_get_arch(arch), get_arch(arch)
    jcaches = jax.eval_shape(
        lambda: jtf.init_caches(jcfg, batch, 8192, jnp.bfloat16))
    tcaches = ttf.init_caches(tcfg, batch, 8192, torch.bfloat16,
                              device="meta")
    for mesh in sorted(MESHES):
        jmesh, tm = _meshes(mesh)
        _same(shd.cache_specs(tcaches, tm), jshd.cache_specs(jcaches, jmesh),
              jcaches)


def test_meshes():
    local = tmesh.make_local_mesh()
    assert local.shape == {"data": 1, "model": 1} and not local.distributed
    assert local.all_gather(torch.ones(3)).shape == (1, 3)
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.make_local_mesh(model=2)       # a world of one rank
    assert tmesh.make_production_mesh().shape == {"data": 16, "model": 16}
    pod = tmesh.make_production_mesh(multi_pod=True)
    assert tuple(pod.shape) == ("pod", "data", "model")
    assert pod.data_size == 32 and not pod.distributed
    assert shd.data_axes(pod) == ("pod", "data")
    x = torch.arange(8)
    assert torch.equal(shd.local_part(x, shd.P("data"), local), x)
    two = tmesh.Mesh({"data": 2, "model": 1}, data_index=1)
    assert torch.equal(shd.local_part(x, shd.P("data"), two), x[4:])
    assert torch.equal(shd.local_part(x, shd.P(None), two), x)
    with pytest.raises(ValueError, match="divisible"):
        shd.local_part(torch.arange(5), shd.P("data"), two)


def test_shard_places_a_tree_by_its_specs():
    """``shard`` keeps each rank's part: the batch's rows of rank 3 of
    (pod 2, data 2), every param whole under each rule at model 1, and on
    a model axis of 2 the model rank's half of each leaf ``basic_ws``
    splits (never the stacked layer axis), the 1-D leaf whole."""
    pod = tmesh.Mesh({"pod": 2, "data": 2, "model": 1}, data_index=3)
    batch = {"tokens": torch.arange(16).reshape(8, 2),
             "pos": torch.tensor(0)}
    got = shd.shard(batch, shd.batch_specs(batch, pod), pod)
    assert torch.equal(got["tokens"], batch["tokens"][6:])
    assert torch.equal(got["pos"], batch["pos"])
    rank1 = tmesh.Mesh({"data": 2, "model": 1}, data_index=1)
    params = {"w": torch.ones(4, 6), "blocks": [torch.zeros(2, 4, 4)],
              "b": torch.ones(6)}
    for mode in ("basic_ws", "tp", "replicated"):
        placed = shd.shard(params, shd.params_specs(params, rank1, mode),
                           rank1)
        assert all(a is b for a, b in zip(
            (placed["w"], placed["blocks"][0], placed["b"]),
            (params["w"], params["blocks"][0], params["b"])))
    for m in range(2):
        ws = tmesh.Mesh({"data": 1, "model": 2}, model_index=m)
        placed = shd.shard(params, shd.params_specs(params, ws, "basic_ws"),
                           ws)
        assert torch.equal(placed["w"], params["w"][:, 3 * m:3 * m + 3])
        assert torch.equal(placed["blocks"][0],
                           params["blocks"][0][:, 2 * m:2 * m + 2])
        assert placed["b"] is params["b"]
