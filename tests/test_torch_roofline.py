"""The port's roofline module (``repro_torch.launch.roofline``) against the
reference's (``repro.launch.roofline``), in H100 terms.

- The reference's cases (``tests/test_roofline.py``): every collective
  kind and the count and total, nothing counted where nothing moves, the
  three terms and the bottleneck, ``model_flops`` for train and decode;
  the port counts the bytes handed to ``launch.mesh``'s collectives
  (``CollectiveBytes``) where the reference parses HLO text.
- ``model_flops`` equal to the reference's for every arch and applicable
  shape, from each package's own config and parameter count.
- The least-work formulas: ``attended_pairs`` in closed form equals the
  count of pairs the kernels' masks keep, and the kernels' (bytes, FLOP)
  at the shapes ``chip_smoke.py`` bounds.
- A ``CollectiveBytes`` count equals the bytes handed over in a 2-rank
  gloo world (``tests/torch_spawn.py``), on every axis of (1, 2) and
  (2, 1).
"""
import os
import sys

import numpy as np
import pytest
import torch

from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs import get_arch as jax_get_arch
from repro.launch import roofline as jrf
from repro_torch.configs import get_arch, list_archs
from repro_torch.configs.base import INPUT_SHAPES, applicable_shapes
from repro_torch.launch import roofline as rf
from repro_torch.launch.mesh import Axis
from repro_torch.launch.spawn import run_world

sys.path.insert(0, os.path.dirname(__file__))

from torch_spawn import worker_collectives  # noqa: E402


def test_peaks_are_the_h100s():
    assert rf.PEAK_FLOPS == {"float32": 67e12, "bfloat16": 989e12}
    assert rf.PEAK_3XTF32 == 495e12 / 3
    assert rf.HBM_BW == 3.35e12 and rf.NVLINK_BW == 450e9


class _Moved:
    """A ``CollectiveBytes`` count stand-in: bytes and calls by op."""

    def __init__(self, nbytes, calls):
        self.bytes, self.calls = nbytes, calls


def test_collective_bytes_counts_all_kinds():
    c = rf.collective_bytes(_Moved(
        {"all_gather": 16 * 1024 * 512 * 2 + 2 * 8 * 2,
         "all_reduce": 256 * 4096 * 4, "reduce_scatter": 16 * 256 * 4},
        {"all_gather": 2, "all_reduce": 1, "reduce_scatter": 1}))
    assert c["all-gather"] == 16 * 1024 * 512 * 2 + 2 * 8 * 2
    assert c["all-reduce"] == 256 * 4096 * 4
    assert c["reduce-scatter"] == 16 * 256 * 4
    assert c["all-to-all"] == 0 and c["collective-permute"] == 0
    assert c["count"] == 4
    assert c["total"] == sum(c[k] for k in
                             ("all-gather", "all-reduce", "reduce-scatter",
                              "all-to-all", "collective-permute"))
    assert set(c) == set(jrf.collective_bytes(""))


def test_one_rank_collectives_are_not_counted():
    """The reference counts no ``dot``; the port no collective of an axis
    of one rank (an identity that moves nothing)."""
    with rf.CollectiveBytes() as moved:
        axis = Axis()
        t = torch.ones(4096, 4096)
        axis.all_gather(t)
        axis.all_reduce(t)
        axis.reduce_scatter(t[None])
    assert rf.collective_bytes(moved)["total"] == 0
    assert rf.collective_bytes(moved)["count"] == 0


def test_roofline_terms_and_bottleneck():
    t = rf.roofline_terms({"flops": 989e12, "bytes accessed": 3.35e12 * 2},
                          {"total": 450e9 * 0.5})
    np.testing.assert_allclose(t["compute_s"], 1.0)
    np.testing.assert_allclose(t["memory_s"], 2.0)
    np.testing.assert_allclose(t["collective_s"], 0.5)
    assert t["bottleneck"] == "memory"
    assert set(t) == set(jrf.roofline_terms({}, {}))
    t = rf.roofline_terms({"flops": 3 * 989e12}, {"total": 450e9})
    assert t["bottleneck"] == "compute"


def test_model_flops_train_vs_decode():
    cfg = get_arch("llama3.2-1b")
    n = cfg.param_counts()["active"]
    tr = rf.model_flops(cfg, INPUT_SHAPES["train_4k"], n)
    de = rf.model_flops(cfg, INPUT_SHAPES["decode_32k"], n)
    assert tr == 6 * n * 256 * 4096
    assert de == 2 * n * 128


LM_ARCHS = [a for a in list_archs() if hasattr(get_arch(a), "family")]


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_model_flops_equal_the_references(arch):
    cfg, jcfg = get_arch(arch), jax_get_arch(arch)
    shapes = applicable_shapes(cfg)
    assert shapes
    for shape in shapes:
        want = jrf.model_flops(jcfg, J_SHAPES[shape.name],
                               jcfg.param_counts()["active"])
        assert rf.model_flops(cfg, shape, cfg.param_counts()["active"]) \
            == want, shape.name


@pytest.mark.parametrize("s,t,causal,window", [
    (196, 196, False, None), (16, 16, True, None), (1024, 1024, True, 8192),
    (4608, 4608, True, 4096), (520, 520, True, 70), (7, 12, True, None),
    (12, 7, True, 3), (9, 9, False, 4)])
def test_attended_pairs_count_the_masks(s, t, causal, window):
    """The closed form equals the pairs the flash kernels' masks keep
    (key j <= query i when causal, within ``window`` keys of it)."""
    i = np.arange(s)[:, None]
    j = np.arange(t)[None, :]
    keep = np.ones((s, t), bool)
    if causal:
        keep &= j <= i
    if window is not None:
        keep &= (i - j) < window
    assert rf.attended_pairs(s, causal, window, t) == int(keep.sum())


def test_work_at_the_bounds_shapes():
    """(bytes, FLOP) of the kernels at shapes ``chip_smoke.py`` bounds."""
    # flash forward: image f32, bh 192, s 196, d 64 (PERF.md §6 row 1:
    # bound 0.0115 ms by bytes)
    nbytes, flops = rf.flash_fwd_work(192, 192, 196, 196, 64, 4,
                                      causal=False)
    assert nbytes == 4 * 192 * 196 * 64 * 4 + 192 * 196 * 4
    assert flops == 4.0 * 192 * 64 * 196 * 196
    ms, by = rf.bound(nbytes, flops, "float32", rf.tensor_core_peak("float32"))
    assert by == "bytes" and round(ms, 4) == 0.0115
    # its backward at Mixtral's s 4096, bf16 (row 3: 0.5213 by operations)
    nbytes, flops = rf.flash_bwd_work(48, 8, 4096, 4096, 128, 2,
                                      causal=True, window=4096)
    ms, by = rf.bound(nbytes, flops, "bfloat16")
    assert by == "operations" and round(ms, 4) == 0.5213
    # the fused contrastive pair at B 2048, D 512, f32 (rows 4-5)
    assert round(rf.bound(*rf.contrastive_fwd_work(2048, 2048, 512, 4),
                          "float32")[0], 4) == 0.0641
    assert round(rf.bound(*rf.contrastive_bwd_work(2048, 2048, 512, 4),
                          "float32")[0], 4) == 0.1923
    # decode: a full cache bf16, 8 slots, 32 heads over 8, t 8192, d 64
    assert round(rf.bound(*rf.decode_work(8, 32, 8, 8192, 64, 2),
                          "bfloat16")[0], 4) == 0.0401
    # top-k: b 64 over 21841 classes, k 5 (row 2: 0.0214 by operations)
    assert rf.bound(*rf.topk_work(64, 21841, 512, 5), "float32")[1] == \
        "operations"
    # the SSD scan's training shape, f32 at the 3×TF32 rate (row 9)
    assert round(rf.bound(*rf.ssd_scan_work(2, 4096, 24, 64, 128, 4),
                          "float32", rf.PEAK_3XTF32)[0], 4) == 0.0420
    assert round(rf.bound(*rf.ssd_bwd_work(2, 4096, 24, 64, 128, 4),
                          "float32", rf.PEAK_3XTF32)[0], 4) == 0.0841


@pytest.mark.parametrize("model", [2, 1], ids=["1x2", "2x1"])
def test_collective_bytes_count_what_a_gloo_world_hands_over(model,
                                                             tmp_path):
    ranks = run_world(worker_collectives, 2, str(tmp_path / "rdv"), model,
                      [3, 1000])
    for counted, calls, handed in ranks:
        assert counted == handed
        assert all(v > 0 for v in handed.values())
        # the batch axis and the one distributed grid axis: 2 sizes each
        assert calls == {"all_gather": 4, "all_reduce": 4,
                         "reduce_scatter": 4}
