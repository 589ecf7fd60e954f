"""The port's sharded data subsystem against the reference's.

``data.sharded`` (loader, augmentation, tokenizer artifact) and
``data.pipeline`` are numpy copies: every block of the port's loader is
byte-identical to the reference's ``local_batch_at`` / ``_block`` at the
same (seed, host, step), with and without augmentation, and the global
batch is the blocks in host order. ``LoaderState`` round-trips through
JSON and the port's checkpoint meta, a reference checkpoint's loader
state restores into the port's loader, and a mismatched state is refused
with the reference's message, field by field.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.data import make_world as jax_make_world
from repro.data import pipeline as jpipe
from repro.data import sharded as jsharded
from repro.data.sharded import augment as jaug
from repro.data.sharded.loader import LoaderState as JaxLoaderState
from repro_torch import checkpoint as ckpt
from repro_torch.data import make_world, pipeline
from repro_torch.data import sharded
from repro_torch.data.sharded import augment
from repro_torch.data.sharded.loader import LoaderState


@pytest.fixture(scope="module")
def worlds():
    """(port world, reference world, port tokenizer, reference tokenizer)
    from one seed."""
    return (make_world(np.random.default_rng(0), n_classes=12),
            jax_make_world(np.random.default_rng(0), n_classes=12),
            sharded.load_tokenizer(), jsharded.load_tokenizer())


def _loaders(worlds, n_hosts, host, aug, **kw):
    world, jworld, tok, jtok = worlds
    ops = augment.default_augmentations() if aug else ()
    jops = jaug.default_augmentations() if aug else ()
    return (sharded.ShardedLoader(world, tok, 16,
                                  layout=sharded.HostLayout(n_hosts, host),
                                  augment=ops, **kw),
            jsharded.ShardedLoader(jworld, jtok, 16,
                                   layout=jsharded.HostLayout(n_hosts, host),
                                   augment=jops, **kw))


def _equal(got, want):
    for part in want:
        for k in want[part]:
            assert got[part][k].dtype == want[part][k].dtype
            assert got[part][k].tobytes() == want[part][k].tobytes(), \
                (part, k)


@pytest.mark.parametrize("aug", [False, True], ids=["plain", "augment"])
@pytest.mark.parametrize("n_hosts", [1, 2, 4])
def test_blocks_are_the_references_bytes(worlds, n_hosts, aug):
    for host in range(n_hosts):
        port, ref = _loaders(worlds, n_hosts, host, aug, seed=9)
        for step in (0, 3):
            _equal(port.local_batch_at(step), ref._block(step, host))
    port, ref = _loaders(worlds, n_hosts, 0, aug, seed=9)
    _equal(port.global_batch_at(5), ref.global_batch_at(5))
    blocks = [_loaders(worlds, n_hosts, h, aug, seed=9)[0].local_batch_at(5)
              for h in range(n_hosts)]
    assert np.concatenate([b["images"]["image"] for b in blocks]).tobytes() \
        == port.global_batch_at(5)["images"]["image"].tobytes()


def test_augment_ops_match_the_reference():
    imgs = np.random.default_rng(1).standard_normal((4, 8, 8, 3)).astype(
        np.float32)
    for op, jop in zip(augment.default_augmentations(),
                       jaug.default_augmentations()):
        assert repr(op) == repr(jop)
        np.testing.assert_array_equal(op(imgs, sharded.aug_rng(0, 1, 2)),
                                      jop(imgs, jsharded.aug_rng(0, 1, 2)))
    ops = augment.default_augmentations()
    assert augment.from_names([o.name for o in ops]) == ops
    with pytest.raises(KeyError):
        augment.from_names(["nope"])
    assert augment.apply_ops((), imgs, None) is imgs


def test_pipeline_matches_the_reference(worlds):
    world, jworld, tok, jtok = worlds
    assert pipeline.host_rng(3, 1, 7).random() == \
        jpipe.host_rng(3, 1, 7).random()
    got = pipeline.contrastive_stream(world, tok, 8, seed=2, host_id=1,
                                      n_hosts=2)
    want = jpipe.contrastive_stream(jworld, jtok, 8, seed=2, host_id=1,
                                    n_hosts=2)
    try:
        for _ in range(2):
            _equal(next(got), next(want))
    finally:
        got.close()
        want.close()
    with pytest.raises(ValueError, match="divisible"):
        pipeline.contrastive_stream(world, tok, 9, n_hosts=2)


def test_prefetcher_surfaces_errors_and_closes():
    def make(step):
        if step == 2:
            raise RuntimeError("boom")
        return step
    pf = pipeline.Prefetcher(make, depth=1)
    assert [next(pf), next(pf)] == [0, 1]
    with pytest.raises(RuntimeError, match="boom"):
        next(pf)
    pf.close()
    pf = pipeline.Prefetcher(lambda s: s, depth=2, start=5)
    assert next(pf) == 5
    pf.close()
    pf.close()                                   # idempotent
    assert len(list(pf)) <= 2                    # drains, then ends


def test_state_round_trip_and_replay(worlds, tmp_path):
    port, _ = _loaders(worlds, 2, 1, True, seed=7)
    next(port), next(port)
    st = port.state()
    tail = [next(port) for _ in range(2)]
    fresh, _ = _loaders(worlds, 2, 1, True, seed=7)
    fresh.restore(LoaderState.from_json(json.loads(json.dumps(
        st.to_json()))))
    for want in tail:
        _equal(next(fresh), want)
    # through the port's checkpoint meta
    ckpt.save(str(tmp_path), 1, {"w": torch.zeros(2)},
              meta={"loader": st.to_json()})
    assert LoaderState.from_json(
        ckpt.load_meta(str(tmp_path), 1)["loader"]) == st


def test_reference_state_restores_into_the_port(worlds):
    """The reference's loader state (as its trainer writes it into a
    checkpoint's meta) is the port's, field for field."""
    port, ref = _loaders(worlds, 2, 0, True, seed=7)
    for _ in range(3):
        next(ref)
    state = ref.state().to_json()
    assert state == port.state(step=3).to_json()
    port.restore(LoaderState.from_json(state))
    _equal(next(port), next(ref))


@pytest.mark.parametrize("field,val", [
    ("seed", 8), ("tokenizer_sha", "deadbeef"),
    ("augment", ("HorizontalFlip(prob=0.5)",)), ("n_hosts", 2),
    ("host_id", 1), ("global_batch", 32), ("text_len", 32),
    ("classes_sha", "beef")])
def test_restore_refuses_what_the_reference_refuses(worlds, field, val):
    port, ref = _loaders(worlds, 1, 0, True, seed=7)
    if field == "host_id":
        port, ref = _loaders(worlds, 2, 0, True, seed=7)
    with pytest.raises(ValueError) as got:
        port.restore(dataclasses.replace(port.state(), **{field: val}))
    with pytest.raises(ValueError) as want:
        ref.restore(dataclasses.replace(ref.state(), **{field: val}))
    assert str(got.value) == str(want.value)
    assert field in str(got.value)


def test_state_matches_the_reference_with_a_class_pool(worlds):
    world, jworld, tok, jtok = worlds
    classes = np.array([1, 3, 5])
    port = sharded.ShardedLoader(world, tok, 8, seed=4, classes=classes)
    ref = jsharded.ShardedLoader(jworld, jtok, 8, seed=4, classes=classes)
    assert port.state().to_json() == ref.state().to_json()
    _equal(port.local_batch_at(1), ref.local_batch_at(1))
    assert JaxLoaderState.from_json(port.state().to_json()) == ref.state()


def test_stream_advances_the_cursor(worlds):
    port, _ = _loaders(worlds, 1, 0, True, seed=3)
    pf = port.stream(depth=2)
    try:
        for _ in range(3):
            next(pf)
        assert port.state().step == 3
        want = next(pf)
    finally:
        pf.close()
    fresh, _ = _loaders(worlds, 1, 0, True, seed=3)
    fresh.restore(port.state(step=3))
    _equal(next(fresh), want)


def test_device_put_global_moves_the_ranks_block(worlds):
    port, _ = _loaders(worlds, 2, 1, False, seed=5)
    want = port.local_batch_at(4)
    got = sharded.device_put_global(want, "cpu")
    for part in want:
        for k in want[part]:
            assert torch.equal(got[part][k], torch.from_numpy(want[part][k]))


def test_tokenizer_artifact_is_the_references(tmp_path):
    tok, jtok = sharded.load_tokenizer("v1"), jsharded.load_tokenizer("v1")
    assert tok.pieces == jtok.pieces and tok.version == "v1"
    assert tok.content_hash() == jtok.content_hash()
    assert sharded.build_default_tokenizer().pieces == tok.pieces
    path = sharded.save_tokenizer(tok, str(tmp_path / "tokenizer_vX.json"),
                                  version="vX")
    with open(path) as f:
        payload = json.load(f)
    assert payload["sha256"] == tok.content_hash()
    payload["pieces"].append("zz")
    with open(path, "w") as f:
        json.dump(payload, f)
    with pytest.raises(ValueError, match="hash mismatch"):
        sharded.load_tokenizer(path=path)
    with pytest.raises(FileNotFoundError, match="build_tokenizer"):
        sharded.load_tokenizer("v999", directory=str(tmp_path))
