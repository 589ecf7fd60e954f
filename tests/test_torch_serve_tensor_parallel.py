"""The port's sharded serving steps (``steps.make_prefill_step`` /
``make_serve_step`` on a rank's parts, ``transformer.prefill`` /
``decode_step`` with a ``layout``) on spawned gloo worlds, against the
reference's ``make_prefill_step`` / ``make_serve_step`` on the whole
weights, f32, logits rtol 1e-5 / atol 1e-6 of their largest entry (the
tp tests' tolerance).

- Each case: the reference's smoke params (``repro_torch.interop``) cut by
  the rule on the (world / M, M) mesh, the prefill with
  ``collect_cache_len`` and 4 decode steps, lockstep (an int) or per-slot
  ((b,) positions): smoke Llama-3.2-1B under ``tp`` at (1, 2) and
  (2, 2) and under ``basic_ws`` at (1, 2), smoke
  Mixtral-8x22B under ``tp`` (experts split, dense dispatch), smoke
  Mamba-2-130M and smoke Jamba under ``tp``, smoke InternVL2 from image
  patches and tokens under ``tp``; these caches (48 slots) are shorter
  than a head (64), where the reference's ``cache_specs`` split the head
  dim, and their sequence stays whole.
- The sequence split (context-parallel decode, ``steps.cache_seq_axis``)
  on caches of 128 slots, or a ring of 64 (the window), whose sequence
  ``cache_specs`` split: smoke Llama under ``basic_ws`` at (1, 2), b 1,
  lockstep (over the model ranks), under ``tp`` at (2, 2), b 1 (kv heads
  over the model ranks, the sequence over the data ranks), on a wrapped
  ring split over 2, and per-slot at (1, 2) with every row empty on rank
  1's slice; smoke Jamba under ``basic_ws`` at (1, 2), b 1 (its KV cache
  split, its SSM state whole). Each split lies where the reference's
  ``cache_specs`` put it, and a rank's prefill makes no tensor of the
  whole cache's length (rank 1 of 2 on 4096 slots, smoke Llama and
  Jamba), its KV caches the unsplit caches' second half.
- Every rank's logits are the whole vocab and the reference's; its caches
  after the prefill and after the last step are its rows' and, under
  ``tp``, its kv heads' (or SSD heads' and their conv channels') slice of
  the reference's caches, and its slice of a KV cache's sequence where it
  is split.
- Under ``tp`` no rank gathers a weight: the params are placed by
  ``steps.serving_layout``, which holds the norm scales, the mixer's B, C
  and conv weights and the vision frontend whole, and every expert
  product runs over E/M experts.
- ``scripts/serve_sharded_probe.py --device cpu --smoke`` on two gloo
  ranks: smoke Llama under ``tp`` serves the tokens one rank serves, its
  prefill logits within 1e-5 of the largest, and a decode step hands its
  collectives 2 all-reduces a block and the embedding's, and all-gathers
  the logits alone.
- A rank's params and cache bytes follow the rule (under ``tp`` the
  leaves held whole, whole); against the reference's ``cache_specs`` at
  full size its KV cache bytes are equal under ``tp`` and ``basic_ws``
  (``long_500k`` at b 1 included), its SSM state is equal under ``tp``
  where the batch splits over the data axes and whole otherwise, and its
  SSD conv window keeps all of B and C.
"""
import dataclasses
import functools
import math
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_arch as jax_get_arch
from repro.configs import smoke_variant as jax_smoke_variant
from repro.core import sharding as jshd
from repro.launch import steps as jsteps
from repro.models import frontends as jfe
from repro.models import transformer as jtf
from repro_torch.configs import get_arch, smoke_variant
from repro_torch.configs.base import INPUT_SHAPES
from repro_torch.core import sharding as shd
from repro_torch.interop import init_params
from repro_torch.launch import steps as st
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.spawn import run_world
from repro_torch.models import ssm as ssm_lib
from repro_torch.tree import leaves, tree_leaves

sys.path.insert(0, os.path.dirname(__file__))

from torch_spawn import worker_serve_probe, worker_tp_serve  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
DENSE = {"dispatch": "dense"}
PROMPT, CACHE_LEN, STEPS = 32, 48, 4


class Case(NamedTuple):
    """A served case: the arch, its rule, the (data, model) grid, per-slot
    positions or lockstep, the global batch (None: 2 rows a data shard),
    the prompt's tokens, the cache's slots, and the mesh axis its KV
    caches' sequence lies over (None: whole)."""
    arch: str
    sharding: str
    grid: tuple
    slots: bool
    batch: Optional[int] = None
    prompt: int = PROMPT
    cache: int = CACHE_LEN
    seq: Optional[str] = None


CASES = {
    "llama-tp-1x2": Case("llama3.2-1b", "tp", (1, 2), False),
    "llama-tp-2x2-slots": Case("llama3.2-1b", "tp", (2, 2), True),
    "llama-basic_ws-1x2-slots": Case("llama3.2-1b", "basic_ws", (1, 2),
                                     True),
    "mixtral-tp-1x2-slots": Case("mixtral-8x22b", "tp", (1, 2), True),
    "mamba2-tp-1x2": Case("mamba2-130m", "tp", (1, 2), False),
    "jamba-tp-1x2-slots": Case("jamba-1.5-large-398b", "tp", (1, 2), True),
    "internvl2-tp-1x2": Case("internvl2-76b", "tp", (1, 2), False),
    # the sequence split: 128 slots (twice the smoke head dim) past a
    # 80-token prompt, so both slices hold prompt keys
    "llama-basic_ws-1x2-b1-seq": Case("llama3.2-1b", "basic_ws", (1, 2),
                                      False, 1, 80, 128, "model"),
    "llama-tp-2x2-b1-seq": Case("llama3.2-1b", "tp", (2, 2), False, 1, 80,
                                128, "data"),
    # the window's ring of 64 slots, wrapped by a 100-token prompt (its
    # length ties the head dim; cache_specs take the sequence)
    "llama-ring-1x2-seq": Case("llama3.2-1b", "basic_ws", (1, 2), False, 2,
                               100, 64, "model"),
    # every row's keys on rank 0's slice: rank 1 sweeps none
    "llama-basic_ws-1x2-slots-seq": Case("llama3.2-1b", "basic_ws", (1, 2),
                                         True, 2, 32, 128, "model"),
    # a prompt of whole scan chunks (32)
    "jamba-basic_ws-1x2-b1-seq": Case("jamba-1.5-large-398b", "basic_ws",
                                      (1, 2), False, 1, 96, 128, "model"),
}


@functools.lru_cache(maxsize=None)
def _weights(arch):
    """The reference's smoke params of ``arch`` from key 0, numpy."""
    jcfg = jax_smoke_variant(jax_get_arch(arch))
    return jax.device_get(jax.jit(functools.partial(jtf.init_params, jcfg))(
        jax.random.key(0)))


def _case(name):
    """The worker's case of ``name``: the reference's smoke weights, a
    numpy batch (2 rows a data shard), the decode tokens and positions."""
    c = CASES[name]
    jcfg = jax_smoke_variant(jax_get_arch(c.arch))
    weights = _weights(c.arch)
    rng = np.random.default_rng(len(name))
    b = 2 * c.grid[0] if c.batch is None else c.batch
    if jcfg.family == "vlm":     # 16 patches, then 16 tokens
        full = jax.device_get(jfe.synthetic_inputs(jcfg, b, c.prompt, rng))
        batch = {k: np.asarray(full[k]) for k in ("image", "tokens")}
    else:
        batch = {"tokens": rng.integers(0, jcfg.vocab, (b, c.prompt)).astype(
            np.int32)}
    slots, start = c.slots, c.prompt
    # per-slot: each row at its own depth, writing over the prompt's tail
    positions = (start - np.arange(b, dtype=np.int64) % 3 if slots
                 else start)
    tokens = rng.integers(0, jcfg.vocab, (STEPS, b, 1)).astype(np.int32)
    return {"arch": c.arch, "sharding": c.sharding, "weights": weights,
            "batch": batch, "tokens": tokens, "positions": positions,
            "cache_len": c.cache, "moe_args": DENSE}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """name -> (the case, each rank's ``worker_tp_serve`` record). The
    spawned worlds, one per grid running its cases, start at once in
    threads, so the reference's steps in this process overlap them."""
    cases = {n: _case(n) for n in CASES}
    grids = sorted({c.grid for c in CASES.values()})
    pool = ThreadPoolExecutor(len(grids))
    worlds = {}
    for grid in grids:
        names = [n for n, c in CASES.items() if c.grid == grid]
        worlds[grid] = names, pool.submit(
            run_world, worker_tp_serve, grid[0] * grid[1],
            str(tmp_path_factory.mktemp("rdv")), grid[1],
            [cases[n] for n in names], timeout=240)

    def get(name):
        names, world = worlds[CASES[name].grid]
        return cases[name], [r[names.index(name)] for r in world.result()]
    yield get
    pool.shutdown()


def _reference(case):
    """The reference's prefill logits and caches from the prompt (its
    ``prefill``, which its ``make_prefill_step`` calls, with
    ``collect_cache_len``), each ``make_serve_step`` step's logits and
    the caches after the last step, all numpy."""
    jcfg = jax_smoke_variant(jax_get_arch(case["arch"]))
    p = jax.tree.map(jnp.asarray, case["weights"])
    batch = jax.tree.map(jnp.asarray, case["batch"])
    margs = case["moe_args"]
    out, caches = jtf.prefill(jcfg, p, batch, precision="f32",
                              moe_args=margs,
                              collect_cache_len=case["cache_len"])
    logits = [out]
    pre = jax.device_get(caches)
    serve = jax.jit(jsteps.make_serve_step(jcfg, precision="f32",
                                           moe_args=margs))
    pos = case["positions"]
    for i, tok in enumerate(case["tokens"]):
        at = jnp.asarray(pos + i, jnp.int32)
        out, caches = serve(p, caches, jnp.asarray(tok), at)
        logits.append(out)
    return [np.asarray(x) for x in logits], pre, jax.device_get(caches)


# the SSM and hybrid families' own tests hold the one-rank port to the
# reference at these (tests/test_torch_ssm.py, tests/test_torch_hybrid.py):
# the mixer's scan sums in another order, so the one-rank port's smoke
# Jamba logits are 4.6e-6 off (1.7e-6 of the largest)
FAMILY_TOL = {"ssm": dict(rtol=1e-4, atol=1e-5),
              "hybrid": dict(rtol=2e-4, atol=1e-5)}


def _close(got, want, what, cache=False, family=None):
    """rtol 1e-5 and atol 1e-6 of the largest entry for logits; a cache's
    atol is 1e-5 of its largest entry, as the tp tests give gradients:
    the one-rank port's own caches are up to 1.3e-6 of the largest entry
    off the reference's (smoke Llama's k and v), as its products sum in
    another order. ``family`` 'ssm' or 'hybrid': that family's tolerance
    against the reference (``FAMILY_TOL``)."""
    want = np.asarray(want)
    if family in FAMILY_TOL:
        np.testing.assert_allclose(got, want, err_msg=what,
                                   **FAMILY_TOL[family])
        return
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=(RTOL if cache else ATOL) * scale,
                               err_msg=what)


def _one_rank(case):
    """The port's own steps on the whole weights and every row, as
    ``_reference`` returns the reference's (the sharding's error is
    measured against these)."""
    from repro_torch import interop
    cfg = smoke_variant(get_arch(case["arch"]))
    p = interop.from_numpy(case["weights"], "cpu")
    kw = dict(precision="f32", moe_args=case["moe_args"])
    with torch.no_grad():
        out, caches = st.make_prefill_step(
            cfg, collect_cache_len=case["cache_len"], **kw)(
            p, {k: torch.from_numpy(v) for k, v in case["batch"].items()})
        logits = [out.numpy()]
        pre = [type(c)(*(a.copy() for a in c))
               for c in interop.caches_to_numpy(caches)]
        serve = st.make_serve_step(cfg, **kw)
        pos = case["positions"]
        for i, tok in enumerate(case["tokens"]):
            at = torch.from_numpy(pos + i) if hasattr(pos, "shape") \
                else pos + i
            out, caches = serve(p, caches, torch.from_numpy(tok), at)
            logits.append(out.numpy())
    return logits, pre, interop.caches_to_numpy(caches)


def _seq_slice(case, rank):
    """(the rank's slice index, the slice count) of a KV cache's sequence
    in ``case`` on rank ``rank`` of its (data, model) grid, or None."""
    data, model = case.grid
    return {"model": (rank % model, model), "data": (rank // model, data),
            "batch": (rank, data * model), None: None}[case.seq]


def _rank_slice(cfg, cache, rows, model, index, tp, seq=None):
    """The reference cache's leaves (L, b, ...) that rank ``index`` of
    ``model`` holds: its rows and, under tp, its kv heads, or its SSD
    heads and the conv window of its x channels and all of B and C; with
    ``seq`` (its slice index, the slice count) its slots of a KV cache's
    sequence."""
    first, n = rows
    out = [np.asarray(x)[:, first:first + n] for x in cache]
    kv_cache = type(cache).__name__ == "KVCache"
    if kv_cache and seq is not None:
        at, parts = seq
        t = out[0].shape[3] // parts
        out = [x[:, :, :, at * t:(at + 1) * t] for x in out]
    if not tp or model == 1:
        return out
    if kv_cache:
        kv = cfg.n_kv_heads // model
        return [x[:, :, index * kv:(index + 1) * kv] for x in out]
    d_in, heads, _ = ssm_lib.dims(cfg)
    h, c = heads // model, d_in // model
    ssm, conv = out
    return [ssm[:, :, index * h:(index + 1) * h],
            np.concatenate([conv[..., index * c:(index + 1) * c],
                            conv[..., d_in:]], axis=-1)]


def _close_or_reference_farther(got, want, exact, what):
    """``_close`` of a smoke Llama rank's logits against the reference's;
    where that fails, a float64 plain path (``exact()``: the case's
    logits, ``_f64_steps``) decides each element past the tolerance: the
    rank is within the tolerance of float64 there, and the reference is
    the one farther from float64."""
    try:
        _close(got, want, what)
        return
    except AssertionError:
        pass
    want, exact = np.asarray(want), exact()
    tol = RTOL * np.abs(want) + ATOL * max(1.0, float(np.abs(want).max()))
    past = np.abs(got - want) > tol
    d_got, d_want = (np.abs(x - exact)[past] for x in (got, want))
    assert (d_got <= tol[past]).all() and (d_got < d_want).all(), (
        what, d_got, d_want, tol[past])


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_steps_are_the_references(served, name):
    """Every rank's logits and caches against the reference's (at the tp
    tolerance, or the SSM families' own) and against the one-rank port's
    (at the tp tolerance, where the sharding's rounding alone shows). A
    smoke Llama rank's logits past the tolerance of the reference's are
    held to a float64 plain path (``_close_or_reference_farther``)."""
    case, ranks = served(name)
    c = CASES[name]
    model = c.grid[1]
    cfg = smoke_variant(get_arch(c.arch))
    f64 = functools.lru_cache(maxsize=None)(lambda: _f64_steps(case))
    for r, rec in enumerate(ranks):
        seq = _seq_slice(c, r)
        assert rec["seq"] == (None if seq is None else (c.seq, *seq)), rec
    for against, (logits, pre, post), family in (
            ("reference", _reference(case), cfg.family),
            ("one rank", _one_rank(case), None)):
        for r, rec in enumerate(ranks):
            first, n = rec["rows"]
            assert len(rec["logits"]) == STEPS + 1
            for i, (got, want) in enumerate(zip(rec["logits"], logits)):
                assert got.shape == (n, 1, cfg.vocab)
                what = f"{against}: rank {r} logits {i}"
                if against == "reference" and c.arch == "llama3.2-1b":
                    _close_or_reference_farther(
                        got, want[first:first + n],
                        lambda: f64()[i][first:first + n], what)
                else:
                    _close(got, want[first:first + n], what, family=family)
            for what, got, want in (("prefill", rec["prefill_caches"], pre),
                                    ("last step", rec["caches"], post)):
                for j, (g, w) in enumerate(zip(got, want)):
                    for k, (gl, wl) in enumerate(zip(g, _rank_slice(
                            cfg, w, rec["rows"], model, r % model,
                            c.sharding == "tp", _seq_slice(c, r)))):
                        _close(gl, wl, f"{against}: rank {r} {what} cache "
                               f"{j} leaf {k}", cache=True, family=family)


TP = [n for n, c in CASES.items() if c.sharding == "tp"]


@pytest.mark.parametrize("name", TP)
def test_no_rank_gathers_a_block_weight_under_tp(served, name):
    _, ranks = served(name)
    cfg = smoke_variant(get_arch(CASES[name].arch))
    model = CASES[name].grid[1]
    for rec in ranks:
        # the leaves a block uses whole are held whole where they are
        # placed: no step makes a leaf whole
        assert rec["whole"] == [] and rec["gathered"] == [], rec
        if cfg.moe is not None:
            assert rec["experts"] and set(rec["experts"]) == {
                cfg.moe.num_experts // model}
        if cfg.ssm is not None:     # the prefill's scan on H/M heads
            assert set(rec["scan_heads"]) == {ssm_lib.dims(cfg)[1] // model}


# the leaves a serving step's params hold whole under tp, where the rule
# splits them: the norm scales (over d), the mixer's B, C and conv
# weights, the vision frontend
HELD_WHOLE = ("ln1", "ln2", "in_B", "in_C", "conv_w")


def _params_bytes(cfg, grid, sharding):
    """Bytes of a rank's f32 parts: 1/M of every leaf the rule splits but,
    under ``tp``, ``HELD_WHOLE`` and the frontend."""
    whole = init_params(cfg, torch.Generator(), "meta")
    specs = dict(shd.spec_leaves(shd.params_specs(
        whole, Mesh({"data": grid[0], "model": grid[1]}), sharding)))

    def held(p):
        return sharding == "tp" and (p.rsplit("/", 1)[-1] in HELD_WHOLE
                                     or p.startswith("frontend/"))
    return sum(x.numel() * 4 // (grid[1] if "model" in specs[p]
                                 and not held(p) else 1)
               for p, x in leaves(whole))


def _rank_caches(cfg, batch, model, cache_len=CACHE_LEN, parts=1):
    """A rank's f32 caches of ``batch`` rows on ``meta`` under 'tp' at (1,
    ``model``) (whole at 1), a KV cache ``cache_len`` slots long (a linear
    cache: the prefill's, whatever the window) cut into ``parts`` slices
    of its sequence."""
    from repro_torch.core import tensor_parallel as tp
    from repro_torch.launch.mesh import Axis
    from repro_torch.models import transformer as ttf
    lay = None if model == 1 else tp.layout(
        cfg, init_params(cfg, torch.Generator(), "meta"),
        Mesh({"data": 1, "model": model}))
    return ttf.init_caches(dataclasses.replace(cfg, sliding_window=None),
                           batch, cache_len, torch.float32, device="meta",
                           layout=lay, seq_axis=Axis(size=parts))


def _nbytes(tree):
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


@pytest.mark.parametrize("name", list(CASES))
def test_rank_bytes_follow_the_rule(served, name):
    _, ranks = served(name)
    c = CASES[name]
    grid = c.grid
    cfg = smoke_variant(get_arch(c.arch))
    for r, rec in enumerate(ranks):
        n = rec["rows"][1]
        parts = 1 if c.seq is None else _seq_slice(c, r)[1]
        whole = _nbytes(_rank_caches(cfg, n, 1, c.cache))
        want = _nbytes(_rank_caches(cfg, n, grid[1] if c.sharding == "tp"
                                    else 1, c.cache, parts))
        assert rec["params_bytes"] == _params_bytes(cfg, grid, c.sharding)
        assert rec["cache_bytes"] == want
        if cfg.ssm is None:
            split = (grid[1] if c.sharding == "tp" else 1) * parts
            assert want * split == whole


# the cases with a KV cache
ATTN = [n for n, c in CASES.items() if c.arch != "mamba2-130m"]


@pytest.mark.parametrize("name", ATTN)
def test_the_sequence_lies_where_the_references_cache_specs_put_it(name):
    """The sequence dim of the reference's KV caches of the case under its
    ``cache_specs`` on the case's grid: over the model axis where the
    port splits it over the model ranks, over the data and model axes
    where the port splits it over every rank, or, under 'tp', the data
    ranks (the kv heads lying over the model ranks); unsplit or its head
    dim split where the port keeps it whole."""
    c = CASES[name]
    jcfg = jax_smoke_variant(jax_get_arch(c.arch))
    b = 2 * c.grid[0] if c.batch is None else c.batch
    caches = jax.eval_shape(lambda: jtf.init_caches(
        dataclasses.replace(jcfg, sliding_window=None), b, c.cache,
        jnp.float32))
    mesh = AbstractMesh(c.grid, ("data", "model"))
    kv = [spec for cache, spec in zip(caches, jshd.cache_specs(caches, mesh))
          if type(cache).__name__ == "KVCache"]
    for spec in kv:
        parts = tuple(spec.k) + (None,) * (5 - len(spec.k))
        seq = parts[3] if isinstance(parts[3], tuple) else (parts[3],)
        if c.seq is None:
            # under tp the kv heads lie over the model ranks instead
            assert seq == (None,) or (c.sharding == "tp"
                                      and seq == ("model",)), spec
        elif c.seq == "model":
            assert seq == ("model",), spec
        else:
            assert seq == ("data", "model") and (
                c.seq == "batch" or c.sharding == "tp"), spec


class _Shapes(TorchDispatchMode):
    """Records the shape of every tensor an operation returns."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.shapes += [tuple(t.shape) for t in tree_leaves(out)
                        if isinstance(t, torch.Tensor)]
        return out


@pytest.mark.parametrize("arch", ["llama3.2-1b", "jamba-1.5-large-398b"])
def test_a_ranks_prefill_builds_its_slice_alone(arch):
    """The prefill of rank 1 of 2 along a cache's sequence (b 1, a linear
    cache of 4096 slots after 64 tokens) makes no tensor with the whole
    cache's 4096 slots, where the unsplit prefill does, and its KV caches
    are the unsplit caches' second half."""
    from repro_torch.launch.mesh import Axis
    cfg = smoke_variant(get_arch(arch))
    p = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, cfg.vocab, (1, 64), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1))
    t = 4096
    built = {}
    for parts in (1, 2):
        step = st.make_prefill_step(cfg, precision="f32", collect_cache_len=t,
                                    seq_axis=Axis(size=parts, index=1))
        with torch.no_grad(), _Shapes() as seen:
            _, built[parts] = step(p, {"tokens": tokens})
        whole = [sh for sh in seen.shapes if t in sh]
        assert bool(whole) == (parts == 1), whole
    for one, half in zip(*built.values()):
        if type(one).__name__ == "KVCache":
            for a, b in zip(one, half):
                assert torch.equal(a[..., t // 2:, :], b)
        else:
            for a, b in zip(one, half):
                assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the rank's cache bytes against the reference's cache_specs, full size
# ---------------------------------------------------------------------------


def _reference_bytes(arch, shape, grid):
    """Per-device bytes of the reference's decode caches of ``shape``
    under its ``cache_specs`` on an ``AbstractMesh`` of ``grid``, by
    leaf kind ('kv', 'ssm', 'conv')."""
    jcfg = jax_get_arch(arch)
    caches = jax.eval_shape(lambda: jtf.init_caches(
        jcfg, shape.global_batch, shape.seq_len, jnp.bfloat16))
    mesh = AbstractMesh(grid, ("data", "model"))
    sizes = dict(zip(("data", "model"), grid))
    out = {}
    for c, spec in zip(caches, jshd.cache_specs(caches, mesh)):
        kinds = ("kv", "kv") if type(c).__name__ == "KVCache" \
            else ("ssm", "conv")
        for kind, x, s in zip(kinds, c, spec):
            split = 1
            for part in s:
                for a in (part if isinstance(part, tuple) else (part,)):
                    split *= sizes.get(a, 1)
            out[kind] = out.get(kind, 0) + \
                math.prod(x.shape) * x.dtype.itemsize // split
    return out


def _port_bytes(arch, shape, grid, sharding):
    """Bytes of rank 0's decode caches of ``shape`` as
    ``steps.shardings_for`` hands them out, by leaf kind."""
    cfg = get_arch(arch)
    mesh = Mesh({"data": grid[0], "model": grid[1]})
    _, (_, caches, _, _) = st.shardings_for(
        cfg, shape, mesh, sharding, st.abstract_params(cfg))
    out = {}
    for c in caches:
        kinds = ("kv", "kv") if type(c).__name__ == "KVCache" \
            else ("ssm", "conv")
        for kind, x in zip(kinds, c):
            out[kind] = out.get(kind, 0) + x.numel() * x.element_size()
    return out


# (arch, shape, grid): decode_32k's 128 rows split over the data axis;
# long_500k's one row does not, and the reference splits its sequence
BYTES = [("llama3.2-1b", "decode_32k", (4, 2)),
         ("llama3.2-1b", "long_500k", (4, 2)),
         ("jamba-1.5-large-398b", "decode_32k", (2, 4)),
         ("jamba-1.5-large-398b", "long_500k", (2, 4)),
         ("mamba2-130m", "long_500k", (2, 4))]


@pytest.mark.parametrize("arch,shape,grid", BYTES,
                         ids=[f"{a}-{s}-{g[0]}x{g[1]}" for a, s, g in BYTES])
@pytest.mark.parametrize("sharding", ["tp", "basic_ws"])
def test_cache_bytes_against_the_references_cache_specs(arch, shape, grid,
                                                        sharding):
    shape = INPUT_SHAPES[shape]
    data, model = grid
    ref = _reference_bytes(arch, shape, grid)
    got = _port_bytes(arch, shape, grid, sharding)
    assert set(got) == set(ref)
    cfg = get_arch(arch)
    # a KV cache lies as the reference places it (steps.cache_seq_axis)
    if "kv" in ref:
        assert got["kv"] == ref["kv"], (got, ref)
    # the ranks the reference spreads a row's SSM state over that the port
    # does not: the data ranks when the batch does not split over them,
    # and under basic_ws the model ranks too
    spread = (1 if shape.global_batch % data == 0 else data) * (
        model if sharding == "basic_ws" else 1)
    if "ssm" in ref:
        assert got["ssm"] == spread * ref["ssm"], (got, ref)
    if "conv" in ref:
        # the conv window of the rank's x channels and all of B and C
        # (under basic_ws all channels), where the reference splits the
        # channels evenly over the model axis
        d_in, _, d_conv = ssm_lib.dims(cfg)
        channels = ((d_in // model + 2 * cfg.ssm.state_dim) * model
                    if sharding == "tp" else d_conv)
        assert got["conv"] * d_conv == spread * ref["conv"] * channels, \
            (got, ref)


def test_the_probe_serves_one_ranks_tokens_on_gloo_ranks(tmp_path):
    argv = ["--device", "cpu", "--smoke", "--runs",
            "llama3.2-1b:tp,llama3.2-1b:one"]
    reports = run_world(worker_serve_probe, 2, str(tmp_path / "rdv"), argv,
                        timeout=240)
    rep = reports[0]
    assert rep["ok"] and rep["backend"] == "gloo"
    tp_run, one = rep["runs"]
    assert tp_run["ranks_agree"] and one["tokens_equal_vs_sharded"] == 1.0
    assert one["max_logit_diff_vs_sharded"] <= 1e-5 * one["max_abs_logit"]
    n = smoke_variant(get_arch("llama3.2-1b")).n_layers
    for calls in tp_run["step_collective_calls"]:
        assert calls == {"all_reduce": 2 * n + 1, "all_gather": 1,
                         "reduce_scatter": 0}


# The lockstep Llama split cases run 80-token prompts. With fp32 RoPE
# frequencies rounded at run time the one-rank port was 1.3e-6 of the
# largest logit off the reference at 80 tokens, past ATOL. Both packages
# are held here to a float64 plain path on those cases' draws.
F64_CASES = ["llama-basic_ws-1x2-b1-seq", "llama-tp-2x2-b1-seq"]
# each package's largest |logit − float64| over the largest |logit|: an
# fp32 evaluation of the smoke model sits ~1e-6 from float64
F64_REL = 2e-6


def _llama_f64(cfg, weights, tokens, prompt):
    """Logits (b, n, vocab) of smoke Llama in float64, numpy, from the
    reference's numpy weights, for tokens (b, n) of which the first
    ``prompt`` are the prefill: a prefill position attends its window,
    a decode position every earlier one (a linear cache longer than the
    window, as ``decode_step`` masks it)."""
    def f64(x):
        return np.asarray(x, np.float64)

    hd, heads, kv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    n = tokens.shape[1]
    pos = np.arange(n)
    ang = pos[:, None] / cfg.rope_theta ** (np.arange(0, hd, 2) / hd)
    sin, cos = np.sin(ang)[:, None], np.cos(ang)[:, None]

    def rope(x):
        x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
        return np.concatenate([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                              axis=-1)

    def norm(x, scale):
        return x / np.sqrt(np.mean(x * x, -1, keepdims=True)
                           + cfg.norm_eps) * f64(scale)

    i, j = pos[:, None], pos[None, :]
    seen = (j <= i) & ((i >= prompt) | (i - j < cfg.sliding_window))
    h = f64(weights["embed"])[tokens]
    blk = weights["blocks"][0]
    for layer in range(cfg.n_layers):
        attn = {k: f64(v[layer]) for k, v in blk["attn"].items()}
        ffn = {k: f64(v[layer]) for k, v in blk["ffn"].items()}
        x = norm(h, blk["ln1"][layer])
        b = x.shape[0]
        q = rope((x @ attn["wq"]).reshape(b, n, heads, hd))
        k = rope((x @ attn["wk"]).reshape(b, n, kv, hd))
        v = (x @ attn["wv"]).reshape(b, n, kv, hd)
        k, v = (np.repeat(t, heads // kv, axis=2) for t in (k, v))
        sc = np.einsum("bihd,bjhd->bhij", q, k) / np.sqrt(hd)
        sc = np.where(seen, sc, -np.inf)
        w = np.exp(sc - sc.max(-1, keepdims=True))
        w /= w.sum(-1, keepdims=True)
        o = np.einsum("bhij,bjhd->bihd", w, v).reshape(b, n, heads * hd)
        h = h + o @ attn["wo"]
        x = norm(h, blk["ln2"][layer])
        g = x @ ffn["wg"]
        h = h + ((x @ ffn["wi"]) * g / (1 + np.exp(-g))) @ ffn["wo"]
    return norm(h, weights["final_norm"]) @ f64(weights["embed"]).T


def _f64_steps(case):
    """A smoke Llama case's logits in float64 (``_llama_f64``), laid out
    as ``_reference`` returns them, each (b, 1, vocab): the prefill's at
    the prompt's last token, then each decode step's at its position. A
    row at position p sees the prompt's first p tokens and the decode
    tokens after them (a slot's steps write over the prompt's tail)."""
    cfg = smoke_variant(get_arch(case["arch"]))
    w, prompt = case["weights"], case["batch"]["tokens"]
    b, n = prompt.shape
    dec = case["tokens"][:, :, 0].T
    pos = np.broadcast_to(case["positions"], (b,))
    rows = [_llama_f64(cfg, w, np.concatenate([prompt[r, :p], dec[r]])[None],
                       p)[0] for r, p in enumerate(pos)]
    return [_llama_f64(cfg, w, prompt, n)[:, n - 1:n]] + [
        np.stack([rows[r][p + i] for r, p in enumerate(pos)])[:, None]
        for i in range(dec.shape[1])]


@pytest.mark.parametrize("name", F64_CASES)
def test_one_rank_at_80_tokens_against_float64(name):
    """One rank, no split, ``name``'s case (an 80-token prompt): the
    port's and the reference's prefill and decode logits
    against a float64 plain path built from the same numpy weights
    (``_f64_steps``). Each is within ``F64_REL`` of the largest |logit|,
    the port no farther than twice the reference's distance on any step
    (the rule of the f32 training parities, ``chip_smoke.fp64_distances``),
    and the port is the reference's at the tests' tolerance (``ATOL``
    1e-6)."""
    case = _case(name)
    ref, _, _ = _reference(case)
    port, _, _ = _one_rank(case)
    f64 = _f64_steps(case)
    assert len(port) == len(ref) == len(f64) == STEPS + 1
    for i, (got, want, exact) in enumerate(zip(port, ref, f64)):
        top = np.abs(exact).max()
        d_port = np.abs(got - exact).max() / top
        d_ref = np.abs(want - exact).max() / top
        assert d_port <= F64_REL and d_ref <= F64_REL, (i, d_port, d_ref)
        assert d_port <= 2 * d_ref, (i, d_port, d_ref)
        _close(got, want, f"one rank: logits {i}")
