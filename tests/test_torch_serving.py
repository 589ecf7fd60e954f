"""Port parity and semantics: the zero-shot serving stack of
``repro_torch`` (micro-batcher, class-embedding registry, ZeroShotService,
launcher) on the CPU, against the JAX reference where both run.

The service comparison feeds both packages the same weights (through
``repro_torch.interop``), images and class names, with the towers on the
kernel backend on both sides (``pallas``: the Pallas kernels in interpret
mode against the port's plain versions). Indices must be equal and values
within 1e-4 (logits are cosine similarities times 1/0.07).
"""
import dataclasses
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import smoke_dual_variant as jax_smoke_dual
from repro.data import load_tokenizer as jax_load_tokenizer
from repro.models import dual_encoder as jde
from repro.serving import ZeroShotService as JaxService
from repro.serving.embed.registry import ClassEmbeddingRegistry as JaxReg
from repro_torch import interop
from repro_torch.configs import get_arch, smoke_dual_variant
from repro_torch.data import load_tokenizer, render_images, world_for_tower
from repro_torch.device import resolve_device
from repro_torch.launch import serve_zeroshot
from repro_torch.serving import MicroBatcher, ZeroShotService
from repro_torch.serving.embed.registry import (ClassEmbeddingRegistry,
                                                checkpoint_fingerprint,
                                                params_fingerprint)

torch.set_num_threads(1)


def _pallas(cfg):
    return dataclasses.replace(
        cfg, image_tower=dataclasses.replace(cfg.image_tower,
                                             attn_impl="pallas"),
        text_tower=dataclasses.replace(cfg.text_tower, attn_impl="pallas"))


@pytest.fixture(scope="module")
def world():
    jcfg = _pallas(jax_smoke_dual(jax_get_arch("basic-s")))
    tcfg = _pallas(smoke_dual_variant(get_arch("basic-s")))
    jparams = jde.init_params(jcfg, jax.random.key(0))
    tparams = interop.from_numpy(jax.device_get(jparams), "cpu")
    rng = np.random.default_rng(0)
    w = world_for_tower(rng, tcfg.image_tower, n_classes=24)
    return jcfg, tcfg, jparams, tparams, w, rng


# ---------------------------------------------------------------------------
# the service against the reference's
# ---------------------------------------------------------------------------


def test_classify_matches_reference_service(world):
    jcfg, tcfg, jparams, tparams, w, rng = world
    images = render_images(w, rng.integers(0, w.n_classes, 7), rng)
    with JaxService(jcfg, jparams, jax_load_tokenizer(),
                    autostart=False) as js:
        jres = js.classify(images, w.class_names, k=5)
    with ZeroShotService(tcfg, tparams, load_tokenizer(), device="cpu",
                         autostart=False) as ts:
        tres = ts.classify(images, w.class_names, k=5)
        again = ts.classify(images, w.class_names, k=5)
        stats = ts.stats()
    np.testing.assert_array_equal(tres.indices, np.asarray(jres.indices))
    np.testing.assert_allclose(tres.values, np.asarray(jres.values),
                               rtol=0, atol=1e-4)
    assert tres.version == 1 and tres.top_names(0)[0] in w.class_names
    np.testing.assert_array_equal(again.indices, tres.indices)
    assert stats["registry"] == {"mem_hits": 1, "disk_hits": 0,
                                 "computes": 1}
    assert stats["retrieval_mode"] == "fused"


def test_embed_and_retrieve_match_reference(world):
    jcfg, tcfg, jparams, tparams, w, rng = world
    queries = ["a photo of a red cat", "the blue dog", "one old tree"]
    gallery = rng.standard_normal((40, tcfg.embed_dim)).astype(np.float32)
    gallery /= np.linalg.norm(gallery, axis=1, keepdims=True)
    with JaxService(jcfg, jparams, jax_load_tokenizer(),
                    autostart=False) as js:
        jq = np.asarray(js.embed_texts(queries))
        jv, ji = js.retrieve(queries, gallery, k=4)
    with ZeroShotService(tcfg, tparams, load_tokenizer(), device="cpu",
                         autostart=False) as ts:
        tq = ts.embed_texts(queries)
        handle = ts.prepare_gallery(gallery)
        tv, ti = ts.retrieve(queries, handle, k=4)
        tv2, ti2 = ts.retrieve(queries, gallery, k=4)   # raw array: upload
        ts.retrieve(queries, gallery, k=4)              # memo hit
        memo_hits = ts.metrics.counter("serve/gallery_memo_hits").value
    np.testing.assert_allclose(tq, jq, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(ti, np.asarray(ji))
    np.testing.assert_allclose(tv, np.asarray(jv), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ti2, ti)
    assert memo_hits == 1
    assert ts.metrics.counter("serve/gallery_uploads").value == 2


def test_threaded_service_matches_thread_free(world):
    _, tcfg, _, tparams, w, rng = world
    images = render_images(w, rng.integers(0, w.n_classes, 5), rng)
    tok = load_tokenizer()
    with ZeroShotService(tcfg, tparams, tok, device="cpu",
                         autostart=False) as a:
        ra = a.classify(images, w.class_names, k=3)
    with ZeroShotService(tcfg, tparams, tok, device="cpu",
                         max_delay_ms=1.0) as b:
        assert b.batcher.running
        rb = b.classify(images, w.class_names, k=3)
    np.testing.assert_array_equal(ra.indices, rb.indices)
    np.testing.assert_allclose(ra.values, rb.values, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# entry points never fall back to the CPU
# ---------------------------------------------------------------------------


def test_entry_points_without_device_raise_on_cardless_host(world):
    _, tcfg, _, tparams, _, _ = world
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the check is for card-less hosts")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ZeroShotService(tcfg, tparams, load_tokenizer(), autostart=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_zeroshot.build("basic-s", smoke=True)
    with pytest.raises(ValueError):
        resolve_device("mps")


def test_launcher_runs_on_cpu_when_asked(capsys):
    rep = serve_zeroshot.main(["--smoke", "--device", "cpu", "--classes",
                               "12", "--batch", "3", "--requests", "2"])
    assert rep["device"] == "cpu" and len(rep["latencies_s"]) == 2
    assert rep["last_result"].indices.shape == (3, 5)
    assert rep["class_matrix"].shape == (12, 64)
    assert "img/s" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# micro-batcher semantics (the reference's)
# ---------------------------------------------------------------------------


def _sum_encoder(batch):
    v = batch["v"]
    return np.stack([v.sum(axis=1), v.max(axis=1)], axis=1)


def test_batcher_flush_on_size():
    mb = MicroBatcher({"t": _sum_encoder}, buckets=(1, 2, 4),
                      max_delay_ms=60_000.0)
    try:
        futs = [mb.submit("t", {"v": np.full((3,), i, np.float32)})
                for i in range(4)]
        out = [f.result(timeout=10.0) for f in futs]
    finally:
        mb.stop()
    np.testing.assert_allclose(np.stack(out)[:, 0], [0.0, 3.0, 6.0, 9.0])
    assert mb.stats["size_flushes"] >= 1
    assert mb.stats["deadline_flushes"] == 0


def test_batcher_deadline_pads_by_replicating_the_last_row():
    seen = []

    def enc(batch):
        seen.append(batch["v"].copy())
        return _sum_encoder(batch)

    mb = MicroBatcher({"t": enc}, buckets=(1, 2, 4, 8), max_delay_ms=30.0)
    try:
        t0 = time.monotonic()
        futs = [mb.submit("t", {"v": np.full((3,), i, np.float32)})
                for i in range(3)]
        out = [f.result(timeout=10.0) for f in futs]
        dt = time.monotonic() - t0
    finally:
        mb.stop()
    np.testing.assert_allclose(np.stack(out)[:, 0], [0.0, 3.0, 6.0])
    assert dt >= 0.03
    assert mb.stats["deadline_flushes"] >= 1
    assert mb.stats["padded_examples"] == 1
    assert seen[0].shape == (4, 3)
    np.testing.assert_array_equal(seen[0][3], seen[0][2])   # not zeros
    ((key, _),) = mb.compiled_shapes().items()
    assert key[1] == 4


def test_batcher_oversized_group_slices_through_the_ladder():
    shapes = []

    def enc(batch):
        shapes.append(batch["v"].shape[0])
        return _sum_encoder(batch)

    mb = MicroBatcher({"t": enc}, buckets=(2, 4), autostart=False)
    fut = mb.submit_many("t", {"v": np.arange(27, dtype=np.float32)
                               .reshape(9, 3)})
    assert mb.flush_now() == 9
    np.testing.assert_allclose(fut.result(timeout=1)[:, 1],
                               np.arange(9) * 3 + 2)
    assert shapes == [4, 4, 2]
    assert mb.stats["padded_examples"] == 1


def test_batcher_cohorts_do_not_mix_shapes():
    calls = []

    def enc(batch):
        calls.append(tuple(sorted(batch)))
        return np.zeros((next(iter(batch.values())).shape[0], 1))

    mb = MicroBatcher({"t": enc}, buckets=(8,), autostart=False)
    a = mb.submit_many("t", {"v": np.zeros((2, 3), np.float32)})
    b = mb.submit_many("t", {"v": np.zeros((2, 5), np.float32)})
    c = mb.submit_many("t", {"w": np.zeros((1, 3), np.float32)})
    mb.flush_now()
    assert [f.result(timeout=1).shape for f in (a, b, c)] == \
        [(2, 1), (2, 1), (1, 1)]
    assert len(calls) == 3
    with pytest.raises(TypeError):
        mb.submit_many("t", np.zeros((2, 3)))
    with pytest.raises(ValueError):
        mb.submit_many("t", {"v": np.zeros((2, 3)), "w": np.zeros((3, 3))})
    with pytest.raises(KeyError):
        mb.submit_many("nope", {"v": np.zeros((1, 3))})


def test_batcher_delivers_encoder_errors():
    def boom(batch):
        raise RuntimeError("encoder exploded")

    mb = MicroBatcher({"t": boom}, buckets=(1, 2), max_delay_ms=1.0)
    try:
        fut = mb.submit_many("t", {"v": np.zeros((2, 3), np.float32)})
        with pytest.raises(RuntimeError, match="exploded"):
            fut.result(timeout=10.0)
        ok = MicroBatcher({"t": _sum_encoder}, buckets=(1,),
                          max_delay_ms=1.0)
        try:
            assert ok.submit("t", {"v": np.ones(3, np.float32)}).result(
                timeout=10.0)[0] == 3.0
        finally:
            ok.stop()
    finally:
        mb.stop()


def test_batcher_flush_thread_bug_fails_pending_futures(monkeypatch):
    mb = MicroBatcher({"t": _sum_encoder}, buckets=(1, 2, 64),
                      max_delay_ms=1.0, autostart=False)

    def broken(*a, **k):
        raise RuntimeError("flush-thread bug")

    monkeypatch.setattr(mb, "_earliest_deadline_locked", broken)
    fut = mb.submit_many("t", {"v": np.zeros((1, 3), np.float32)})
    mb.start()
    try:
        with pytest.raises(RuntimeError, match="flush-thread bug"):
            fut.result(timeout=10.0)
        assert mb.stats["worker_errors"] >= 1
    finally:
        monkeypatch.undo()
        mb.stop()


def test_batcher_request_deadline_bounds_bare_result():
    release = threading.Event()

    def stuck(batch):
        release.wait(timeout=10.0)
        return _sum_encoder(batch)

    mb = MicroBatcher({"t": stuck}, buckets=(1,), max_delay_ms=1.0,
                      request_timeout_s=0.2)
    try:
        fut = mb.submit("t", {"v": np.zeros(3, np.float32)})
        t0 = time.monotonic()
        with pytest.raises(TimeoutError):
            fut.result()
        assert time.monotonic() - t0 < 5.0
    finally:
        release.set()
        mb.stop()


def test_batcher_brings_tensor_output_to_host():
    mb = MicroBatcher({"t": lambda b: torch.tensor(b["v"]) * 2},
                      buckets=(4,), autostart=False)
    fut = mb.submit_many("t", {"v": np.ones((3, 2), np.float32)})
    mb.flush_now()
    out = fut.result(timeout=1)
    assert isinstance(out, np.ndarray)
    np.testing.assert_array_equal(out, np.full((3, 2), 2.0))


# ---------------------------------------------------------------------------
# registry keying
# ---------------------------------------------------------------------------


def test_registry_key_scheme_equals_reference():
    for names, temps, tag in ((("red cat", "blue dog"), ("a {} {}",), "t1"),
                              (("blue dog", "red cat"), ("a {} {}",), "t1"),
                              (("red cat",), ("a {} {}", "the {} {}"), "x")):
        assert ClassEmbeddingRegistry.key(names, temps, tag) == \
            JaxReg.key(names, temps, tag)


def test_registry_memo_invalidation_and_refresh():
    calls = []

    def compute(names, temps):
        calls.append((names, temps))
        return torch.ones((len(names), 4)) * len(calls)

    reg = ClassEmbeddingRegistry(compute)
    a = reg.get(("x", "y"), ("t",), "ck1", embed_dim=4)
    b = reg.get(("x", "y"), ("t",), "ck1", embed_dim=4)
    assert (a.source, b.source) == ("computed", "memory")
    assert a.matrix.dtype == np.float32 and a.key == b.key
    c = reg.get(("x", "y"), ("t",), "ck2", embed_dim=4)      # new weights
    d = reg.get(("y", "x"), ("t",), "ck1", embed_dim=4)      # new order
    assert len({a.key, c.key, d.key}) == 3 and len(calls) == 3
    r = reg.refresh(("x", "y"), ("t",), "ck1", embed_dim=4)
    assert r.version == 2 and r.key == a.key
    assert reg.get(("x", "y"), ("t",), "ck1", embed_dim=4).version == 2
    assert reg.stats == {"mem_hits": 2, "disk_hits": 0, "computes": 4}
    with pytest.raises(ValueError):
        reg.get(("x",), ("t",), "ck1", embed_dim=5)
    with pytest.raises(RuntimeError):
        ClassEmbeddingRegistry().get(("x",), ("t",), "ck", embed_dim=4)


def test_params_fingerprint_sensitivity(world):
    _, _, _, tparams, _, _ = world
    fp = params_fingerprint(tparams)
    assert fp == params_fingerprint(interop.from_numpy(
        interop.to_numpy(tparams), "cpu"))
    bumped = interop.from_numpy(interop.to_numpy(tparams), "cpu")
    bumped["text"]["proj"][0, 0] += 1e-3
    assert params_fingerprint(bumped) != fp
    tok = load_tokenizer()
    tag = checkpoint_fingerprint(tparams, tok)
    assert tag.startswith(fp) and tok.content_hash() in tag


# ---------------------------------------------------------------------------
# zero-shot metric helpers (numpy, the reference's)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_zero_shot_metric_helpers_match_reference(seed):
    from repro.eval import zero_shot as jzs
    from repro_torch.eval import zero_shot as tzs
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((40, 9)).astype(np.float32)
    labels = rng.integers(0, 9, 40)
    for k in (1, 5, 20):
        assert tzs.topk_accuracy(logits, labels, k) == \
            jzs.topk_accuracy(logits, labels, k)
    assert tzs.mean_per_class_recall(logits, labels) == \
        pytest.approx(jzs.mean_per_class_recall(logits, labels))
    x, y = (rng.standard_normal((12, 6)).astype(np.float32)
            for _ in range(2))
    assert tzs.retrieval_recall_at_k(x, y, (1, 3)) == \
        jzs.retrieval_recall_at_k(x, y, (1, 3))
    assert tzs.DEFAULT_TEMPLATES == jzs.DEFAULT_TEMPLATES
