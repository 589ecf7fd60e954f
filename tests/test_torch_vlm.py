"""Port parity: the vlm family against the JAX reference on the CPU, at
InternVL2-76B's smoke size (``smoke_variant``: 2 layers, d 256, 4 query
heads over 2 kv heads, 16 patches of a 16×16 image before the text,
vocab 512), from the reference's weights carried over by
``interop.from_numpy`` and batches drawn with numpy from a seed.

- The registry: the port lists the reference's archs, and every config
  equals the reference's field for field (``dataclasses.astuple``).
- The parameter tree (the frontend's ``patch_proj``, ``embed`` and the
  untied ``lm_head``) has the reference's paths, shapes and dtypes at
  full size, and crosses both ways bit for bit.
- ``embed_inputs``: the patches, then the token embeddings; positions
  and the text mask; a token-only batch embeds its tokens alone.
- ``lm_loss`` (the next-token loss of the text tail) and its gradients
  against ``jax.value_and_grad``, with naive attention and with the flash
  path (here its plain version: causal, grouped-query): the loss and
  ``xent`` at rtol 2e-5 and every gradient leaf at rtol 2e-5 with the
  leaf's largest |gradient| as the absolute part (``GA_RTOL``,
  ``tests/test_torch_lm_train.py``).
- ``train --mode lm`` for 3 steps against the reference's ``run_lm``:
  losses at rel 1e-4, params per leaf within 1e-3 of the change the steps
  made.
- Serving: the lockstep and continuous engines against the reference's
  engines token for token on token prompts (the reference's engines never
  take an image).
- ``train_distributed`` at (data 1, model 2) under ``basic_ws`` and
  ``tp``: the reference's runs of the same flags (4 steps, checkpoints at
  2 and 4, in a subprocess with four CPU devices, the Auto-axis mesh as in
  ``tests/test_torch_train_tensor_parallel_ssm.py``), resumed by the port
  from step 2 on spawned gloo ranks: steps 2-3's losses at rtol 1e-4 and
  the step-4 parameters and AdaFactorW slots within 1e-3 of the change.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import get_arch as jax_get_arch
from repro.configs import list_archs as jax_list_archs
from repro.configs import smoke_variant as jax_smoke_variant
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import frontends as jfe
from repro.models import transformer as jtf
from repro.serving import ContinuousEngine as JaxContinuousEngine
from repro.serving import Engine as JaxEngine
from repro_torch import interop
from repro_torch.core import tensor_parallel as tpl
from repro_torch.configs import (INPUT_SHAPES, applicable_shapes, get_arch,
                                 list_archs, smoke_variant)
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.launch.spawn import run_world
from repro_torch.models import frontends as tfe
from repro_torch.models import transformer as ttf
from repro_torch.serving import ContinuousEngine, Engine
from repro_torch.tree import leaves

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_lm_train import (GA_RTOL, _assert_change_close,  # noqa: E402
                                 _assert_grads_close, _paths,
                                 _record_reference_floats, _ref_args,
                                 _ref_paths)
from test_torch_train_distributed import (_assert_step4_matches,  # noqa: E402
                                          _from_step2)
from torch_spawn import worker_train  # noqa: E402

torch.set_num_threads(1)

ARCH = "internvl2-76b"
SEQ = 40                # 16 patches, then 24 tokens
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def vlm():
    """(reference cfg, port cfg, reference params as numpy, the same
    params in the port, one numpy batch of 2 images and 2 × 24 tokens)."""
    jcfg = jax_smoke_variant(jax_get_arch(ARCH))
    tcfg = smoke_variant(get_arch(ARCH))
    jparams = jax.device_get(jtf.init_params(jcfg, jax.random.key(0)))
    batch = jax.device_get(jfe.synthetic_inputs(jcfg, 2, SEQ,
                                                np.random.default_rng(1)))
    return jcfg, tcfg, jparams, interop.from_numpy(jparams, "cpu"), batch


def _shapes(tree):
    return {p: (tuple(x.shape), str(x.dtype).removeprefix("torch."))
            for p, x in leaves(tree)}


def test_registry_and_configs_are_the_reference_s():
    assert list_archs() == jax_list_archs()
    for name in list_archs():
        assert dataclasses.astuple(get_arch(name)) == \
            dataclasses.astuple(jax_get_arch(name)), name
    assert get_arch(ARCH).family == "vlm"


def test_param_tree_is_the_reference_s_and_crosses_both_ways(vlm):
    jcfg, tcfg, jparams, tparams, _ = vlm
    full = tsteps.abstract_params(get_arch(ARCH))
    ref = jsteps.abstract_params(jax_get_arch(ARCH))
    assert _shapes(full) == {p: (tuple(s.shape), str(s.dtype))
                             for p, s in leaves(ref)}
    assert {"frontend", "embed", "lm_head"} <= set(full)
    back = interop.to_numpy(tparams)
    got, want = dict(leaves(back)), dict(leaves(jparams))
    assert set(got) == set(want)
    for path, w in want.items():
        np.testing.assert_array_equal(got[path], w, err_msg=path)
    # the port's own draw has the reference's tree
    drawn = ttf.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert _shapes(drawn) == _shapes(tparams)


def test_embed_inputs_match_reference(vlm):
    jcfg, tcfg, jparams, tparams, batch = vlm
    jh, jpos, jmask = jtf.embed_inputs(
        jcfg, jax.tree.map(jnp.asarray, jparams),
        jax.tree.map(jnp.asarray, batch), jnp.float32)
    h, pos, mask = ttf.embed_inputs(tcfg, tparams,
                                    interop.from_numpy(batch, "cpu"),
                                    torch.float32)
    assert h.shape == (2, SEQ, tcfg.d_model)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert not mask[:, :tcfg.frontend_len].any()
    assert mask[:, tcfg.frontend_len:].all()
    # a token-only batch (serving) embeds its tokens alone, no mask
    toks = {"tokens": batch["tokens"]}
    jh, _, jmask = jtf.embed_inputs(jcfg, jax.tree.map(jnp.asarray, jparams),
                                    jax.tree.map(jnp.asarray, toks),
                                    jnp.float32)
    h, _, mask = ttf.embed_inputs(tcfg, tparams,
                                  interop.from_numpy(toks, "cpu"),
                                  torch.float32)
    assert mask is None and jmask is None
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))


@pytest.fixture(scope="module")
def reference_grads(vlm):
    jcfg, _, jparams, _, batch = vlm
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jtf.lm_loss(jcfg, p, jax.tree.map(jnp.asarray, batch)),
        has_aux=True)(jax.tree.map(jnp.asarray, jparams))
    return jl, jm, jg


@pytest.mark.parametrize("attn", ["naive", "pallas"])
def test_lm_loss_and_grads_match_reference(vlm, reference_grads, attn):
    _, tcfg, _, tparams, batch = vlm
    jl, jm, jg = reference_grads
    cfg = dataclasses.replace(tcfg, attn_impl=attn)
    tbatch = interop.from_numpy(batch, "cpu")
    loss, metrics, grads = tsteps.value_and_grad(
        lambda p: ttf.lm_loss(cfg, p, tbatch), tparams)
    assert float(loss) == pytest.approx(float(jl), rel=GA_RTOL)
    assert float(metrics["xent"]) == pytest.approx(float(jm["xent"]),
                                                   rel=GA_RTOL)
    got = _paths(grads)
    _assert_grads_close(got, _ref_paths(jg))
    # the text tail's loss reaches the frontend through attention
    assert np.abs(got["frontend/patch_proj"]).max() > 0


def test_run_lm_matches_reference(vlm, tmp_path, monkeypatch):
    jcfg, tcfg, jparams, tparams, _ = vlm
    args = ttrain.parse_args([
        "--mode", "lm", "--arch", ARCH, "--smoke", "--device", "cpu",
        "--steps", "3", "--batch", "2", "--seq", str(SEQ), "--log-every",
        "1", "--seed", "0"])
    rep = ttrain.run_lm(args, params_init=tparams)
    seen = _record_reference_floats(monkeypatch)
    ref = jax.device_get(jtrain.run_lm(_ref_args(args, tmp_path)))
    assert rep["losses"] == pytest.approx(seen, rel=1e-4)
    _assert_change_close(_paths(rep["params"]), _ref_paths(ref),
                         _ref_paths(jparams), 1e-3)


def _prompts(seed, vocab, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(4, vocab, (n,)).astype(np.int32) for n in lens]


def test_lockstep_engine_matches_reference(vlm):
    jcfg, tcfg, jparams, tparams, _ = vlm
    prompts = np.stack(_prompts(3, tcfg.vocab, [8, 8, 8]))
    want = JaxEngine(jcfg, jparams, cache_len=32).generate(
        prompts, 6, temperature=0.0)
    got = Engine(tcfg, tparams, cache_len=32).generate(prompts, 6,
                                                       temperature=0.0)
    np.testing.assert_array_equal(got, want)


def test_continuous_engine_matches_reference(vlm):
    """5 ragged token requests through 2 slots on both sides."""
    jcfg, tcfg, jparams, tparams, _ = vlm
    reqs = [(p, m, i) for i, (p, m) in enumerate(zip(
        _prompts(4, tcfg.vocab, [8, 5, 8, 12, 5]), [5, 3, 6, 2, 4]))]
    want = JaxContinuousEngine(jcfg, jparams, cache_len=32,
                               num_slots=2).run(reqs)
    got = ContinuousEngine(tcfg, tparams, cache_len=32, num_slots=2).run(reqs)
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid], err_msg=rid)


# ---------------------------------------------------------------------------
# train_distributed at (1, 2) against the reference's runs of the same flags
# ---------------------------------------------------------------------------

_REFERENCE = r"""
import json, sys, types
import jax
from jax.sharding import AxisType
import repro.launch.train_distributed as rtd

def make_local_mesh(model=1):
    return jax.make_mesh((1, model), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:model])

rtd.make_local_mesh = make_local_mesh
base = dict(objective="auto", smoke=True, steps=4, seed=0, remat="basic",
            model_parallel=2, log_every=100, ckpt_every=2, stop_after=None,
            quiet=True, run_dir=None, batch=4, lr=3e-3)
out = {}
for name, kw in json.loads(sys.argv[2]).items():
    out[name] = rtd.train(types.SimpleNamespace(
        **base, **kw, ckpt_dir=f"{sys.argv[1]}/{name}"))
print("LOSSES " + json.dumps(out))
"""


def reference_runs(root: str, runs: dict) -> dict:
    """{name: (losses, checkpoint dir)} of the reference's
    ``train_distributed.train`` at (data 1, model 2), 4 steps, batch 4,
    for each run {name: {"arch", "seq", "sharding"}}."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"),
               XLA_FLAGS=os.environ.get("XLA_FLAGS", "")
               + " --xla_force_host_platform_device_count=4")
    proc = subprocess.run([sys.executable, "-c", _REFERENCE, root,
                           json.dumps(runs)],
                          capture_output=True, text=True, timeout=600,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("LOSSES "))
    return {k: (v, os.path.join(root, k))
            for k, v in json.loads(line[len("LOSSES "):]).items()}


def resumed_argv(run: dict, ref_dir: str, port_dir: str) -> list:
    """The port's trainer flags for ``run``, resuming from the reference's
    step-2 checkpoint copied into ``port_dir``."""
    return ["--arch", run["arch"], "--smoke", "--batch", "4", "--seq",
            str(run["seq"]), "--lr", "3e-3", "--device", "cpu", "--steps",
            "4", "--quiet", "--model-parallel", "2", "--sharding",
            run["sharding"], "--ckpt-dir", _from_step2(ref_dir, port_dir)]


def check_resumed_runs(runs: dict, tmp_path) -> None:
    """The reference's ``runs``, resumed by the port on two gloo ranks:
    losses of steps 2-3 at rtol 1e-4 and the step-4 state."""
    ref = reference_runs(str(tmp_path / "reference"), runs)
    dirs = {name: str(tmp_path / "port" / name) for name in runs}
    argvs = [resumed_argv(run, ref[name][1], dirs[name])
             for name, run in runs.items()]
    ranks = run_world(worker_train, 2, str(tmp_path / "rdv"), argvs,
                      timeout=300)
    for got in ranks:
        for name, losses in zip(runs, got):
            np.testing.assert_allclose(losses, ref[name][0][2:], rtol=1e-4,
                                       err_msg=name)
    for name in runs:
        _assert_step4_matches(dirs[name], ref[name][1])
        with open(os.path.join(dirs[name], "runlog.jsonl")) as f:
            meta = json.loads(f.readline())["meta"]
        assert (meta["ranks"], meta["model"], meta["sharding"]) == \
            (2, 2, runs[name]["sharding"])


def test_tp_refuses_only_what_cannot_split():
    """``tp`` splits whole heads, kv groups and ff columns: the smoke
    InternVL2 (4 heads over 2) at M 2, not at M 4; the full-size one at
    M 8 (64 over 8, d_ff 28672); HuBERT-XLarge (16 over 16) at M 4, not
    at M 3. A vocab that does not divide falls back to a head split over
    d, made whole on use, so it is not refused."""
    cfg = smoke_variant(get_arch(ARCH))
    tpl.check(cfg, 2)
    with pytest.raises(ValueError, match="kv heads do not both divide"):
        tpl.check(cfg, 4)
    tpl.check(get_arch(ARCH), 8)
    tpl.check(get_arch("hubert-xlarge"), 4)
    with pytest.raises(ValueError, match="by 3"):
        tpl.check(get_arch("hubert-xlarge"), 3)
    tpl.check(dataclasses.replace(cfg, vocab=509), 2)


def test_train_distributed_resumes_the_references_runs(tmp_path):
    """InternVL2 smoke (b 4 × 40: 16 patches and 24 tokens a row) at
    (1, 2): under ``basic_ws`` the batch and the weights split over both
    ranks; under ``tp`` both ranks run the batch, the frontend made whole,
    the text tail's cross-entropy vocab-parallel."""
    check_resumed_runs({f"vlm_{s}": {"arch": ARCH, "seq": SEQ,
                                     "sharding": s}
                        for s in ("basic_ws", "tp")}, tmp_path)


def test_applicable_shapes_cover_the_vlm():
    names = [s.name for s in applicable_shapes(get_arch(ARCH))]
    assert names == [s.name for s in
                     jbase.applicable_shapes(jax_get_arch(ARCH))]
    assert names == ["train_4k", "prefill_32k", "decode_32k"]
    spec = tfe.train_inputs_spec(get_arch(ARCH), INPUT_SHAPES["train_4k"])
    assert tuple(spec["image"].shape) == (256, 256, 256, 3)
    assert tuple(spec["tokens"].shape) == (256, 4096 - 256)


@pytest.mark.parametrize("size,seq", [("smoke", SEQ), ("full", 264)])
def test_synthetic_inputs_are_the_reference_s(size, seq):
    """Same draws from the same ``np.random.default_rng``, twice in a row,
    at smoke size and at full width (256×256 images, 8 tokens after the
    256 patches)."""
    jcfg, tcfg = jax_get_arch(ARCH), get_arch(ARCH)
    if size == "smoke":
        jcfg, tcfg = jax_smoke_variant(jcfg), smoke_variant(tcfg)
    jrng, trng = np.random.default_rng(7), np.random.default_rng(7)
    for _ in range(2):
        ref = jax.device_get(jfe.synthetic_inputs(jcfg, 2, seq, jrng))
        got = tfe.synthetic_inputs(tcfg, 2, seq, trng, device="cpu")
        assert set(got) == set(ref) == {"image", "tokens"}
        for k, r in ref.items():
            assert str(got[k].dtype).removeprefix("torch.") == str(r.dtype)
            np.testing.assert_array_equal(got[k].numpy(), r, err_msg=k)
    assert got["tokens"].shape == (2, seq - tcfg.frontend_len)
