"""Port parity: retrieval at scale (``repro_torch.serving.retrieval``) and
``similarity_topk``'s ``n_valid`` against the reference on the CPU.

- ``n_valid``: the plain version against the reference's
  ``similarity_topk(..., n_valid=, interpret=True)``: a poisoned tail that
  would win unmasked, and ``n_valid`` at and below k. Live entries: ids
  and values exact. Masked slots: exactly NEG in both. Their ids differ by
  design. The port gives the masked columns' own ids, ascending. The
  reference's select-and-retire merge retires a pick by setting it to NEG,
  so once the live entries are gone it picks the lowest id at NEG again:
  its masked slots repeat one id. The tests pin both.
- ``merge_topk`` against the reference's on pools with ties and empty
  slots.
- ``shard_matrix``'s MAX_K floor, and ``sharded_similarity_topk`` over a
  mesh of four CPU devices against the reference's fused sweep (ids
  equal, values within 1e-6), empty shards included.
- ``build_centroid_index`` against the reference's: members and counts
  equal, centroids within 1e-5. ``two_stage_topk``: "all" equals fused
  and the reference's two-stage answer, recall is monotone in nprobe, the
  starvation growth, the gather callback. An index ``.npz`` written by
  either package loads in the other.
- The registry's index: cached per (key, version, n_blocks), rebuilt after
  ``refresh()``, read back from disk by a new registry.
- ``ZeroShotService`` in each retrieval mode against the reference service
  on converted weights: ``retrieve`` and ``classify`` ids equal. The
  port's "sharded" service (four CPU devices) is held to the reference's
  "fused" one, its answer by the reference's own claim: the reference's
  sharded service cannot run here (under jax 0.9 its Pallas call refuses
  the sharded class matrix's mesh axes).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import smoke_dual_variant as jax_smoke_dual
from repro.data import load_tokenizer as jax_load_tokenizer
from repro.kernels.similarity_topk import ops as jops
from repro.kernels.similarity_topk.kernel import IDX_PAD as J_IDX_PAD
from repro.kernels.similarity_topk.kernel import NEG as J_NEG
from repro.models import dual_encoder as jde
from repro.serving import ZeroShotService as JaxService
from repro.serving import retrieval as jrtv
from repro.serving.embed.registry import \
    ClassEmbeddingRegistry as JaxRegistry
from repro_torch import interop
from repro_torch.configs import get_arch, smoke_dual_variant
from repro_torch.data import load_tokenizer, render_images, world_for_tower
from repro_torch.kernels.similarity_topk import ops as tops
from repro_torch.serving import ZeroShotService
from repro_torch.serving import retrieval as rtv
from repro_torch.serving.retrieval import twostage
from repro_torch.serving.embed.registry import ClassEmbeddingRegistry

torch.set_num_threads(1)
CPU4 = [torch.device("cpu")] * 4


def _unit(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _clustered(n, d, p, seed, sigma=0.2):
    rng = np.random.default_rng(seed)
    cent = _unit(rng, (p, d))
    rows = cent[rng.integers(0, p, n)] + sigma * rng.standard_normal(
        (n, d)).astype(np.float32)
    return rows / np.linalg.norm(rows, axis=1, keepdims=True)


def _jax_topk(x, c, k, n_valid=None):
    v, i = jops.similarity_topk(
        jnp.asarray(x), jnp.asarray(c), k, interpret=True,
        n_valid=None if n_valid is None else jnp.asarray(n_valid, jnp.int32))
    return np.asarray(v), np.asarray(i)


def _topk(x, c, k, **kw):
    v, i = tops.similarity_topk(torch.from_numpy(x), torch.from_numpy(c), k,
                                **kw)
    return v.numpy(), i.numpy()


# -- n_valid -------------------------------------------------------------------

@pytest.mark.parametrize("n_valid", [80, 95, 96, 17, 64])
def test_n_valid_masks_a_poisoned_tail_as_the_reference(n_valid):
    rng = np.random.default_rng(0)
    x = _unit(rng, (5, 16))
    c = _unit(rng, (96, 16))
    c[n_valid:] = x[0]                  # the masked tail would win unmasked
    want_v, want_i = _jax_topk(x, c, 4, n_valid)
    got_v, got_i = _topk(x, c, 4, n_valid=n_valid)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_array_equal(got_v, want_v)
    trunc_v, trunc_i = _topk(x, c[:n_valid], 4)
    np.testing.assert_array_equal(got_i, trunc_i)
    np.testing.assert_array_equal(got_v, trunc_v)


@pytest.mark.parametrize("n_valid,k", [(0, 2), (0, 5), (3, 5), (1, 8)])
def test_n_valid_below_k_gives_neg_sentinels(n_valid, k):
    rng = np.random.default_rng(1)
    x = _unit(rng, (3, 8))
    c = _unit(rng, (32, 8))
    want_v, want_i = _jax_topk(x, c, k, n_valid)
    got_v, got_i = _topk(x, c, k, n_valid=n_valid)
    live = n_valid
    np.testing.assert_array_equal(got_i[:, :live], want_i[:, :live])
    np.testing.assert_array_equal(got_v[:, :live], want_v[:, :live])
    np.testing.assert_array_equal(got_v[:, live:], want_v[:, live:])
    assert (got_v[:, live:] == np.float32(J_NEG)).all()
    # the port: the masked columns' own ids, ascending, after the live ones
    np.testing.assert_array_equal(
        got_i[:, live:], np.broadcast_to(np.arange(n_valid, k),
                                         (3, k - live)))
    # the reference: its retire step cannot retire a NEG pick, so its
    # masked slots repeat the lowest id at NEG
    assert (want_i[:, live:] == want_i[:, live:live + 1]).all()


def test_n_valid_refusals():
    x, c = np.zeros((2, 4), np.float32), np.zeros((8, 4), np.float32)
    for bad in (-1, 9):
        with pytest.raises(ValueError, match="n_valid"):
            _topk(x, c, 2, n_valid=bad)
    v, i = _topk(x, c, 2, n_valid=8)
    np.testing.assert_array_equal(i, [[0, 1], [0, 1]])


@pytest.mark.parametrize("seed", range(3))
def test_merge_topk_matches_reference(seed):
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 5, (6, 40)).astype(np.float32)   # many ties
    i = np.stack([rng.permutation(1000)[:40] for _ in range(6)]).astype(
        np.int32)
    v[:, -5:] = J_NEG
    i[:, -5:] = J_IDX_PAD
    for k in (1, 7, 35):
        wv, wi = jops.merge_topk(jnp.asarray(v), jnp.asarray(i), k)
        gv, gi = tops.merge_topk(torch.from_numpy(v), torch.from_numpy(i), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    with pytest.raises(ValueError, match="narrower"):
        tops.merge_topk(torch.zeros(2, 3), torch.zeros(2, 3,
                                                       dtype=torch.int32), 4)


# -- sharded -----------------------------------------------------------------

def test_shard_matrix_keeps_the_max_k_floor():
    rng = np.random.default_rng(0)
    m = _unit(rng, (10, 8))
    sm = rtv.shard_matrix(m, CPU4)
    assert sm.n_local == tops.MAX_K == jops.MAX_K
    assert sm.n_shards == 4 and sm.n == 10 and sm.d == 8
    assert [sm.n_valid(r) for r in range(4)] == [10, 0, 0, 0]
    assert all(b.shape == (64, 8) for b in sm.blocks)
    np.testing.assert_array_equal(sm.blocks[0][:10].numpy(), m)
    assert not sm.blocks[0][10:].any() and not sm.blocks[3].any()
    jsm = jrtv.shard_matrix(m, jrtv.default_data_mesh(1))
    assert jsm.n_local == max(10, jops.MAX_K)
    big = rtv.shard_matrix(_unit(rng, (1001, 8)), CPU4)
    assert big.n_local == 251 and [big.n_valid(r) for r in range(4)] == \
        [251, 251, 251, 248]
    shares = rtv.shard_winner_shares(np.array([[0, 300], [600, 900]]), big)
    np.testing.assert_allclose(shares, [0.25, 0.25, 0.25, 0.25])


@pytest.mark.parametrize("n,k", [(1001, 10), (300, 64), (130, 5), (997, 1),
                                 (64, 64)])
def test_sharded_matches_reference_fused(n, k):
    rng = np.random.default_rng(n)
    x = _unit(rng, (7, 24))
    c = _unit(rng, (n, 24))
    c[n // 2] = c[n // 3]               # an exact tie across shards
    x[0] = c[n // 3]
    want_v, want_i = _jax_topk(x, c, k)
    got_v, got_i = rtv.sharded_similarity_topk(torch.from_numpy(x), c, k,
                                               mesh=CPU4)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_allclose(got_v.numpy(), want_v, rtol=0, atol=1e-6)
    fused = _topk(x, c, k)
    np.testing.assert_array_equal(got_i.numpy(), fused[1])
    np.testing.assert_array_equal(got_v.numpy(), fused[0])


def test_sharded_one_device_is_the_fused_kernel_and_refusals():
    rng = np.random.default_rng(2)
    x, c = _unit(rng, (3, 8)), _unit(rng, (50, 8))
    sm = rtv.shard_matrix(c, ["cpu"])
    v, i = rtv.sharded_similarity_topk(x, sm, 4)
    fv, fi = _topk(x, c, 4)
    np.testing.assert_array_equal(i.numpy(), fi)
    np.testing.assert_array_equal(v.numpy(), fv)
    for bad in (0, 51):
        with pytest.raises(ValueError, match="k="):
            rtv.sharded_similarity_topk(x, sm, bad)
    with pytest.raises(ValueError, match="dims"):
        rtv.sharded_similarity_topk(x[:, :4], sm, 2)


# -- two-stage -----------------------------------------------------------------

@pytest.mark.parametrize("n,p,iters,seed", [(800, 12, 4, 0), (2000, None, 4, 3),
                                            (300, 6, 1, 1), (333, 40, 6, 2)])
def test_centroid_index_matches_reference(n, p, iters, seed):
    m = _clustered(n, 16, 10, seed=seed)
    want = jrtv.build_centroid_index(m, n_blocks=p, iters=iters, seed=seed)
    got = rtv.build_centroid_index(m, n_blocks=p, iters=iters, seed=seed)
    assert got.n == want.n and got.n_blocks == want.n_blocks
    np.testing.assert_array_equal(got.members.numpy(), want.members)
    np.testing.assert_array_equal(got.counts.numpy(), want.counts)
    np.testing.assert_allclose(got.centroids.numpy(), want.centroids,
                               rtol=0, atol=1e-5)
    for b in (0, got.n_blocks - 1):
        np.testing.assert_array_equal(got.block_members(b).numpy(),
                                      want.block_members(b))
    again = rtv.build_centroid_index(torch.from_numpy(m), n_blocks=p,
                                     iters=iters, seed=seed)
    assert torch.equal(again.centroids, got.centroids)


def test_twostage_all_is_exact_and_matches_reference():
    rng = np.random.default_rng(0)
    q = _unit(rng, (9, 24))
    m = _clustered(800, 24, 12, seed=3)
    index = rtv.build_centroid_index(m, n_blocks=12)
    jindex = jrtv.build_centroid_index(m, n_blocks=12)
    fv, fi = _topk(q, m, 6)
    for nprobe in ("all", None, 12, 99):
        v, i, info = rtv.two_stage_topk(q, torch.from_numpy(m), index, 6,
                                        nprobe=nprobe)
        np.testing.assert_array_equal(i.numpy(), fi)
        np.testing.assert_array_equal(v.numpy(), fv)
        assert info["prune_ratio"] == 1.0 and info["n_blocks_probed"] == 12
    jv, ji, _ = jrtv.two_stage_topk(q, m, jindex, 6, nprobe="all",
                                    interpret=True)
    np.testing.assert_array_equal(i.numpy(), ji)
    np.testing.assert_array_equal(v.numpy(), jv)


def test_twostage_recall_monotone_in_nprobe():
    q = _clustered(8, 16, 10, seed=7, sigma=0.1)
    m = torch.from_numpy(_clustered(2000, 16, 10, seed=7, sigma=0.1))
    index = rtv.build_centroid_index(m, n_blocks=10)
    _, want = tops.similarity_topk(torch.from_numpy(q), m, 5)
    prev_recall, prev_prune = -1.0, -1.0
    for nprobe in (1, 2, 3, 10):
        _, got, info = rtv.two_stage_topk(q, m, index, 5, nprobe=nprobe)
        recall = np.mean([len(set(g.tolist()) & set(w.tolist())) / 5
                          for g, w in zip(got, want)])
        assert recall >= prev_recall and info["prune_ratio"] >= prev_prune
        prev_recall, prev_prune = recall, info["prune_ratio"]
    assert prev_recall == 1.0


def test_twostage_grows_a_starved_probe_and_takes_a_gather_callback():
    rng = np.random.default_rng(0)
    m = _unit(rng, (60, 8))
    index = rtv.build_centroid_index(m, n_blocks=30)
    q = _unit(rng, (2, 8))
    v, i, info = rtv.two_stage_topk(q, torch.from_numpy(m), index, 20,
                                    nprobe=1)
    assert info["n_candidates"] >= 20 and i.shape == (2, 20)
    assert len(set(i[0].tolist())) == 20
    m2 = _clustered(500, 16, 8, seed=11)
    seen = []

    def gather(ids):
        seen.append(ids)
        return m2[ids]
    index2 = rtv.build_centroid_index(m2, n_blocks=8)
    q2 = _unit(rng, (4, 16))
    v1, i1, _ = rtv.two_stage_topk(q2, torch.from_numpy(m2), index2, 5,
                                   nprobe=3)
    v2, i2, _ = rtv.two_stage_topk(q2, gather, index2, 5, nprobe=3)
    assert torch.equal(i1, i2) and torch.equal(v1, v2)
    assert seen and (np.diff(seen[-1]) > 0).all()
    with pytest.raises(ValueError, match="k="):
        rtv.two_stage_topk(q2, torch.from_numpy(m2), index2, 0)
    with pytest.raises(ValueError, match="nprobe"):
        rtv.two_stage_topk(q2, torch.from_numpy(m2), index2, 3, nprobe=0)


@pytest.mark.parametrize("nprobe,use_gather", [(7, False), (7, True),
                                                ("all", True)])
def test_twostage_rerank_in_chunks_equals_one_sweep(monkeypatch, nprobe,
                                                    use_gather):
    """A wide probe (every block but one, or all through a callback) is
    reranked in chunks of at most ``_RERANK_ELEMS`` elements; the merged
    answer equals the one-chunk sweep bit for bit."""
    m = _clustered(900, 16, 8, seed=5)
    q = _clustered(6, 16, 8, seed=6, sigma=0.2)
    index = rtv.build_centroid_index(m, n_blocks=8)
    one_v, one_i, one = rtv.two_stage_topk(q, torch.from_numpy(m), index,
                                           7, nprobe=nprobe)
    seen = []

    def gather(ids):
        seen.append(ids)
        return m[ids]
    monkeypatch.setattr(twostage, "_RERANK_ELEMS", 16 * 100)
    v, i, info = rtv.two_stage_topk(
        q, gather if use_gather else torch.from_numpy(m), index, 7,
        nprobe=nprobe)
    assert torch.equal(i, one_i) and torch.equal(v, one_v)
    assert info["n_candidates"] == one["n_candidates"] > 300
    if use_gather:
        assert len(seen) > 1 and max(len(s) for s in seen) <= 100
        got = np.concatenate(seen)
        assert (np.diff(got) > 0).all() and len(got) == info["n_candidates"]
    want_v, want_i = tops.similarity_topk(torch.from_numpy(q),
                                          torch.from_numpy(m), 7)
    if info["prune_ratio"] == 1.0:
        assert torch.equal(i, want_i) and torch.equal(v, want_v)


def test_index_npz_loads_in_either_package(tmp_path):
    m = _clustered(400, 16, 6, seed=4)
    mine = rtv.build_centroid_index(m, n_blocks=7)
    theirs = jrtv.build_centroid_index(m, n_blocks=7)
    mine.save(str(tmp_path / "t.npz"))
    theirs.save(str(tmp_path / "j.npz"))
    back = jrtv.CentroidIndex.load(str(tmp_path / "t.npz"))
    assert back.n == 400 and back.members.dtype == theirs.members.dtype
    assert back.counts.dtype == theirs.counts.dtype
    np.testing.assert_array_equal(back.members, theirs.members)
    np.testing.assert_array_equal(back.centroids, mine.centroids.numpy())
    loaded = rtv.CentroidIndex.load(str(tmp_path / "j.npz"))
    np.testing.assert_array_equal(loaded.members.numpy(), theirs.members)
    np.testing.assert_array_equal(loaded.centroids.numpy(),
                                  theirs.centroids)
    assert loaded.n == 400 and loaded.counts.dtype == torch.int32


def test_registry_index_cached_per_version_and_read_from_disk(tmp_path):
    names = [f"c{i}" for i in range(40)]
    calls = []

    def compute(class_names, templates):
        calls.append(1)
        return _clustered(len(class_names), 8, 5, seed=len(calls))
    reg = ClassEmbeddingRegistry(compute, cache_dir=str(tmp_path))
    cm = reg.get(names, ["{}"], "tag", embed_dim=8)
    a = reg.get_centroid_index(cm, n_blocks=5)
    b = reg.get_centroid_index(cm, n_blocks=5)
    assert a is b and reg.stats["index_builds"] == 1 and \
        reg.stats["index_hits"] == 1
    kdir = tmp_path / cm.key[:16]
    assert (kdir / "index_v1_p5.npz").exists()
    cm2 = reg.refresh(names, ["{}"], "tag", embed_dim=8)
    c = reg.get_centroid_index(cm2, n_blocks=5)
    assert cm2.version == 2 and reg.stats["index_builds"] == 2
    assert not torch.equal(c.centroids, a.centroids)
    assert (kdir / "index_v2_p5.npz").exists()
    fresh = ClassEmbeddingRegistry(compute, cache_dir=str(tmp_path))
    d = fresh.get_centroid_index(cm2, n_blocks=5)
    assert fresh.stats["index_builds"] == 0 and \
        fresh.stats["index_hits"] == 1
    assert torch.equal(d.members, c.members)
    # the reference's registry reads the port's index file
    jreg = JaxRegistry(compute, cache_dir=str(tmp_path))
    j = jreg.get_centroid_index(cm2, n_blocks=5)
    assert jreg.stats["index_builds"] == 0
    np.testing.assert_array_equal(j.members, c.members.numpy())


# -- the service ---------------------------------------------------------------

@pytest.fixture(scope="module")
def served():
    jcfg = jax_smoke_dual(jax_get_arch("basic-s"))
    tcfg = smoke_dual_variant(get_arch("basic-s"))
    jparams = jde.init_params(jcfg, jax.random.key(0))
    tparams = interop.from_numpy(jax.device_get(jparams), "cpu")
    rng = np.random.default_rng(0)
    world = world_for_tower(rng, tcfg.image_tower, n_classes=70, noise=0.2)
    images = render_images(world, rng.integers(0, 70, 6), rng)
    gallery = _clustered(300, tcfg.embed_dim, 9, seed=5)
    queries = [f"a photo of item {i}" for i in range(5)]
    return jcfg, tcfg, jparams, tparams, world, images, gallery, queries


@pytest.mark.parametrize("mode", ["fused", "sharded", "twostage"])
def test_service_modes_match_reference_service(served, mode):
    jcfg, tcfg, jparams, tparams, world, images, gallery, queries = served
    kw = {"retrieval": mode, "index_blocks": 8 if mode == "twostage"
          else None}
    jkw = dict(kw, retrieval="fused" if mode == "sharded" else mode)
    with JaxService(jcfg, jparams, jax_load_tokenizer(), max_delay_ms=1.0,
                    interpret=True, **jkw) as js:
        jr = js.retrieve(queries, gallery, k=7)
        jc = js.classify(images, world.class_names, k=5)
        jr8 = js.retrieve(queries, gallery, k=7, nprobe=2) \
            if mode == "twostage" else None
    with ZeroShotService(tcfg, tparams, load_tokenizer(), device="cpu",
                         max_delay_ms=1.0,
                         mesh=CPU4 if mode == "sharded" else None,
                         latency_slo_s=30.0, **kw) as ts:
        handle = ts.prepare_gallery(gallery)
        tr = ts.retrieve(queries, handle, k=7)
        tc = ts.classify(images, world.class_names, k=5)
        tr8 = ts.retrieve(queries, handle, k=7, nprobe=2) \
            if mode == "twostage" else None
        stats = ts.stats()
    np.testing.assert_array_equal(tr[1], jr[1])
    np.testing.assert_allclose(tr[0], jr[0], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tc.indices, jc.indices)
    np.testing.assert_allclose(tc.values, jc.values, rtol=0, atol=1e-4)
    assert stats["retrieval_mode"] == mode
    assert stats["slo"]["requests"] == 2 + (tr8 is not None)
    hists = stats["metrics"]["histograms"]
    assert hists[f"serve/retrieval_latency_s{{mode={mode},stage=total}}"][
        "count"] == 2 + (tr8 is not None)
    if mode == "sharded":
        assert hists["serve/retrieval_shard_share{mode=sharded}"]["count"] \
            == 2
    if mode == "twostage":
        assert stats["registry"]["index_builds"] == 1
        assert hists["serve/retrieval_prune_ratio{mode=twostage}"][
            "count"] == 3
        recall = np.mean([len(set(a) & set(b)) / 7
                          for a, b in zip(tr8[1], jr8[1])])
        assert 0.0 <= recall <= 1.0 and tr8[1].shape == (5, 7)
    other = "fused" if mode != "fused" else "sharded"
    with pytest.raises(ValueError, match="prepared for mode"):
        ts.retrieve(queries, dataclasses.replace(handle, mode=other))
