"""Sharded loader: each rank draws its block of the global batch, and the
blocks reassemble bit for bit (port of ``repro/data/sharded/loader.py``;
DESIGN.md §9).

The paper feeds a 65536 global batch "distributed equally to all cores";
reproducibility at that scale hinges on the input layout being a pure
function of ``(seed, step, layout)`` and nothing else:

    global_batch(step) = concat_h  draw(host_rng(seed, h, step), B/H)

Host ``h`` (the port: rank ``h`` of the data axis) materialises ONLY its
block (``local_batch_at``); a single process — an oracle, or a one-rank
run that wants the blocks of a wider layout — materialises every block and
concatenates (``global_batch_at``). Each block is keyed by ``(seed, h,
step)`` and augmented on a tagged sibling stream, so the two are
byte-identical, and rank r's block is the same bytes as the reference's
block r.

``device_put_global`` moves this rank's block onto its device: where the
reference hands the whole global batch to
``jax.make_array_from_process_local_data``, each rank of the port builds
and moves its own rows only.

Resume: ``state()`` snapshots (seed, next step, host layout, tokenizer
hash and version, augmentation policy); ``restore()`` validates every
field — a retrained tokenizer or a changed layout fails loudly instead of
silently replaying a different batch sequence — and rewinds the cursor,
after which the loader replays the exact batches an uninterrupted run
would have drawn.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.data.pipeline import Prefetcher, host_rng
from repro_torch.data.sharded.augment import apply_ops
from repro_torch.data.synthetic import World, contrastive_batch
from repro_torch.obs import trace as obs_trace
from repro_torch.tree import tree_map

# tags the augmentation stream so it never collides with the batch-draw
# stream at the same (seed, host, step) key
_AUG_STREAM_TAG = 0xA06


def aug_rng(seed: int, host_id: int, step: int) -> np.random.Generator:
    """Deterministic per-(host, step) augmentation stream, disjoint from
    ``host_rng``'s batch-draw stream at the same key."""
    return np.random.default_rng(
        np.random.SeedSequence([seed, host_id, step, _AUG_STREAM_TAG]))


@dataclasses.dataclass(frozen=True)
class HostLayout:
    """One process's coordinates in the input decomposition: ``n_hosts``
    equal blocks per global batch, this process owning block ``host_id``.
    In the port n_hosts is the mesh's data extent and host_id the rank's
    data index, so block h lands on the model ranks of data shard h, each
    keeping its sub-block (``device_put_global``)."""
    n_hosts: int = 1
    host_id: int = 0

    def __post_init__(self):
        if self.n_hosts < 1 or not 0 <= self.host_id < self.n_hosts:
            raise ValueError(f"invalid host layout: host {self.host_id} "
                             f"of {self.n_hosts}")


@dataclasses.dataclass(frozen=True)
class LoaderState:
    """Resumable input-state snapshot: everything needed to replay the
    exact batch sequence — persisted as checkpoint user-meta through
    ``checkpoint.io`` step dirs (``save(..., meta=...)``).

    ``augment`` stores op REPRS (e.g. ``"RandomCrop(pad=2)"``), not just
    names, so a resumed run with different op parameters fails validation;
    ``classes_sha`` digests an explicit class pool (empty = full world)."""
    seed: int
    step: int                 # next step the loader will produce
    global_batch: int
    text_len: int
    n_hosts: int
    host_id: int
    tokenizer_sha: str        # Tokenizer.content_hash() at save time
    tokenizer_version: str
    augment: Tuple[str, ...]  # op reprs, pipeline order
    classes_sha: str = ""     # sha256 of the classes array, "" when None

    def to_json(self) -> dict:
        """Plain-JSON form (for checkpoint user-meta)."""
        d = dataclasses.asdict(self)
        d["augment"] = list(self.augment)
        return d

    @classmethod
    def from_json(cls, d: dict) -> "LoaderState":
        """Inverse of ``to_json``."""
        return cls(seed=int(d["seed"]), step=int(d["step"]),
                   global_batch=int(d["global_batch"]),
                   text_len=int(d["text_len"]),
                   n_hosts=int(d["n_hosts"]), host_id=int(d["host_id"]),
                   tokenizer_sha=str(d["tokenizer_sha"]),
                   tokenizer_version=str(d["tokenizer_version"]),
                   augment=tuple(d["augment"]),
                   classes_sha=str(d.get("classes_sha", "")))


class ShardedLoader:
    """Shard-exact contrastive input stream for one host of ``layout``.

    Iterating yields this host's local batches (advancing the cursor);
    ``global_batch_at`` materializes all blocks for single-process
    training/oracles. Batches are the standard contrastive tree
    ``{'images': {'image'}, 'texts': {'tokens', 'attn_mask'}}``.
    """

    def __init__(self, world: World, tok, global_batch: int, *,
                 layout: HostLayout = HostLayout(), seed: int = 0,
                 text_len: int = 16, classes: Optional[np.ndarray] = None,
                 augment: Sequence = (), start_step: int = 0,
                 registry=None, tracer=None):
        if global_batch % layout.n_hosts:
            raise ValueError(
                f"global batch {global_batch} must be divisible by "
                f"n_hosts {layout.n_hosts} (each host gets an equal block; "
                f"got remainder {global_batch % layout.n_hosts})")
        self.world, self.tok = world, tok
        self.global_batch = int(global_batch)
        self.layout = layout
        self.seed = int(seed)
        self.text_len = int(text_len)
        self.classes = classes
        self.augment = tuple(augment)
        self._step = int(start_step)
        # telemetry (DESIGN.md §11): per-host block-generation timing into
        # ``registry`` histograms and ``tracer`` spans on pid lane
        # 1+host_id (the trace's simulated-host lanes); both optional and
        # free when None
        self._registry = registry
        self._tracer = tracer
        self._h_gen = None if registry is None else {
            h: registry.histogram("data/gen_seconds", host=h)
            for h in range(layout.n_hosts)}
        self._h_global = None if registry is None else \
            registry.histogram("data/global_batch_seconds")

    @property
    def local_batch(self) -> int:
        """Rows this host contributes per step (B / n_hosts)."""
        return self.global_batch // self.layout.n_hosts

    # -- batch materialization --------------------------------------------
    def _block(self, step: int, host_id: int) -> dict:
        t0 = time.perf_counter()
        with obs_trace.span(self._tracer, "host_block", pid=1 + host_id,
                            step=step, host=host_id):
            rng = host_rng(self.seed, host_id, step)
            batch, _ = contrastive_batch(self.world, self.tok,
                                         self.local_batch, rng,
                                         text_len=self.text_len,
                                         classes=self.classes)
            if self.augment:
                batch["images"]["image"] = apply_ops(
                    self.augment, batch["images"]["image"],
                    aug_rng(self.seed, host_id, step))
        if self._h_gen is not None:
            self._h_gen[host_id].observe(time.perf_counter() - t0)
        return batch

    def local_batch_at(self, step: int) -> dict:
        """This host's block of step ``step`` (pure function of
        (seed, layout.host_id, step) — no cursor side effects)."""
        return self._block(step, self.layout.host_id)

    def global_batch_at(self, step: int) -> dict:
        """The full global batch of step ``step``: every host's block,
        concatenated in host order (the single-process materialization and
        the oracle the two-host test reassembles against)."""
        t0 = time.perf_counter()
        blocks = [self._block(step, h) for h in range(self.layout.n_hosts)]
        out = tree_map(lambda *xs: np.concatenate(xs, axis=0), *blocks)
        if self._h_global is not None:
            self._h_global.observe(time.perf_counter() - t0)
        return out

    # -- iteration ---------------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self) -> dict:
        """The next LOCAL batch; advances the resumable cursor."""
        b = self.local_batch_at(self._step)
        self._step += 1
        return b

    def stream(self, *, global_batches: bool = False,
               depth: int = 2) -> "_CursorStream":
        """Background-prefetching iterator from the current cursor
        (local blocks, or full global batches for the single-process
        trainer). Each CONSUMED batch advances the loader's cursor — the
        Prefetcher may have produced further ahead, but ``state()`` after
        n ``next()`` calls snapshots exactly step ``cursor + n``, so a
        checkpoint taken mid-stream resumes without replaying or skipping
        batches."""
        make = self.global_batch_at if global_batches else self.local_batch_at
        return _CursorStream(self, Prefetcher(make, depth=depth,
                                              start=self._step))

    # -- resumable state ---------------------------------------------------
    def state(self, step: Optional[int] = None) -> LoaderState:
        """Snapshot at ``step`` (default: the cursor): seed, next step,
        batch geometry, host layout, tokenizer hash/version, augmentation
        policy (op reprs, so parameters are captured), class pool."""
        import hashlib
        classes_sha = "" if self.classes is None else hashlib.sha256(
            np.ascontiguousarray(np.asarray(self.classes)).tobytes()
        ).hexdigest()
        return LoaderState(
            seed=self.seed,
            step=self._step if step is None else int(step),
            global_batch=self.global_batch, text_len=self.text_len,
            n_hosts=self.layout.n_hosts, host_id=self.layout.host_id,
            tokenizer_sha=self.tok.content_hash(),
            tokenizer_version=getattr(self.tok, "version", "unversioned"),
            augment=tuple(repr(op) for op in self.augment),
            classes_sha=classes_sha)

    def restore(self, state: LoaderState) -> None:
        """Rewind to ``state`` after validating it belongs to THIS
        configuration — every field except the cursor must match: seed,
        batch geometry, host layout, augmentation policy (parameters
        included), class pool, and the tokenizer artifact hash. A mismatch
        means the resumed run would replay a DIFFERENT batch sequence than
        the one checkpointed (the failure mode versioned artifacts exist
        to prevent), so it raises instead."""
        mine = self.state(step=state.step)
        for field in ("seed", "global_batch", "text_len", "n_hosts",
                      "host_id", "tokenizer_sha", "augment", "classes_sha"):
            got, want = getattr(mine, field), getattr(state, field)
            if got != want:
                raise ValueError(
                    f"loader state mismatch on {field}: checkpoint has "
                    f"{want!r}, this loader has {got!r}"
                    + (" — the tokenizer artifact changed since the "
                       "checkpoint was written; load the matching version"
                       if field == "tokenizer_sha" else ""))
        self._step = state.step


class _CursorStream:
    """Prefetching iterator that advances its loader's resumable cursor on
    every CONSUMED batch (production may run ahead in the background;
    consumption is what a checkpoint must not replay)."""

    def __init__(self, loader: ShardedLoader, prefetcher: Prefetcher):
        self._loader = loader
        self._pf = prefetcher

    def __iter__(self):
        return self

    def __next__(self):
        batch = next(self._pf)           # raises StopIteration when closed
        self._loader._step += 1
        return batch

    def close(self):
        """Stop the underlying Prefetcher (idempotent)."""
        self._pf.close()


def device_put_global(block, device, part=(0, 1)):
    """This rank's rows of a global batch (the numpy tree
    ``local_batch_at`` draws) as torch tensors on ``device``: the port's
    counterpart of the reference's ``device_put_global``, which splits the
    whole global batch over the mesh. Rank r of the port has drawn only
    the block of its data shard (its loader laid out as
    ``HostLayout(data extent, data index)``); ``part = (index, count)``
    keeps sub-block ``index`` of ``count`` equal ones (the rank's model
    index and the model extent: the M ranks of a data shard split its
    block, paper §5.1) and moves only that."""
    import torch
    index, count = part

    def rows(a):
        b = a.shape[0] // count
        if b * count != a.shape[0]:
            raise ValueError(f"a block of {a.shape[0]} rows does not split "
                             f"into {count} equal sub-blocks")
        return torch.from_numpy(np.ascontiguousarray(
            a[index * b:(index + 1) * b])).to(device)
    return tree_map(rows, block)
