"""Roofline terms of the port on the H100 (counterpart of
``repro/launch/roofline.py``), and the one home of the card's peaks and of
the hand-written kernels' least work.

Hardware model (NVIDIA H100 SXM, data sheet, dense rates, at the full
700 W power limit; a card set lower runs slower under load):
    bf16 tensor cores   989 TFLOP/s
    TF32 tensor cores   495 TFLOP/s; fp32-accurate work split 3×TF32
                        (three tf32 products a product) at 495 / 3
    fp32 FMA units       67 TFLOP/s
    HBM3                3.35 TB/s
    NVLink              450 GB/s a direction

Terms (per step, per rank; ``launch.memstats`` counts a step of one rank,
so its numbers are per card already):
    compute    = flops / PEAK_FLOPS['bfloat16']
    memory     = bytes_accessed / HBM_BW
    collective = collective_bytes / NVLINK_BW

``collective_bytes`` are the bytes a rank hands to the collectives of
``launch.mesh`` (``CollectiveBytes``), one pass over the wire per call: a
lower bound that ignores the ring's extra hops, enough to rank the
bottlenecks, as the reference's count of the post-SPMD HLO is.

The kernels' least work (``*_work``: (bytes, FLOP) of one call) lives
beside the kernels in ``kernels.work`` and is re-exported here: it is what
``chip_smoke.py``'s bounds divide by these peaks.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.kernels.work import (  # noqa: F401  (re-exported)
    attended_pairs, contrastive_bwd_work, contrastive_fwd_work, decode_work,
    flash_bwd_work, flash_fwd_work, ssd_bwd_work, ssd_least_flops,
    ssd_scan_work, topk_work)

HBM_BW = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# fp32-accurate work on the tensor cores as split 3×TF32: three tf32
# products (495 TFLOP/s) per fp32 product. The f32 flash kernels and the
# SSD scans compute so, and their bounds are taken at this rate (the
# card's fastest for work held to fp32 accuracy), not at the FMA units' 67.
PEAK_3XTF32 = 495e12 / 3
NVLINK_BW = 450e9

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
# launch.mesh's collectives under the reference's names
_MESH_OPS = {"all_gather": "all-gather", "all_reduce": "all-reduce",
             "reduce_scatter": "reduce-scatter"}


def bound(nbytes: float, flops: float, dtype: str,
          peak: Optional[float] = None):
    """(least milliseconds the card could take, what bounds it: 'bytes' or
    'operations'), at the dtype's peak rate or at ``peak`` FLOP/s."""
    t_bytes = nbytes / HBM_BW
    t_ops = flops / (peak or PEAK_FLOPS[dtype])
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def tensor_core_peak(dtype: str) -> Optional[float]:
    """The peak a tensor-core kernel's bound is taken at (the flash
    kernels, the SSD scan): f32 runs split 3×TF32, bf16 at the dtype's own
    peak (None: ``bound``'s default)."""
    return PEAK_3XTF32 if dtype == "float32" else None


class CollectiveBytes:
    """Bytes this rank hands to the collectives of ``launch/mesh.py``
    (``Axis.all_reduce``, ``all_gather``, ``reduce_scatter`` over more
    than one rank), by operation, and their calls, counted while it is
    installed (a context manager). A collective that an axis runs inside
    another (gloo's reduce-scatter is an all-reduce) is the outer one's
    and is not counted again."""

    OPS = ("all_reduce", "all_gather", "reduce_scatter")

    def __init__(self):
        from repro_torch.launch import mesh
        self.axis, self.real = mesh.Axis, {}
        self.bytes = dict.fromkeys(self.OPS, 0)
        self.calls = dict.fromkeys(self.OPS, 0)
        self._depth = 0

    def __enter__(self):
        for op in self.OPS:
            real = self.real[op] = getattr(self.axis, op)

            def counted(axis, t, *args, _op=op, _real=real, **kw):
                if axis.distributed and not self._depth:
                    self.bytes[_op] += t.numel() * t.element_size()
                    self.calls[_op] += 1
                self._depth += 1
                try:
                    return _real(axis, t, *args, **kw)
                finally:
                    self._depth -= 1
            setattr(self.axis, op, counted)
        return self

    def __exit__(self, *exc):
        for op, real in self.real.items():
            setattr(self.axis, op, real)


def collective_bytes(count: CollectiveBytes) -> Dict[str, int]:
    """A ``CollectiveBytes`` count under the reference's keys: bytes by
    collective kind (the port's mesh issues no all-to-all or
    collective-permute: 0), ``count`` calls and their ``total`` bytes."""
    out = dict.fromkeys(COLLECTIVES, 0)
    for op, kind in _MESH_OPS.items():
        out[kind] = int(count.bytes[op])
    out["count"] = int(sum(count.calls.values()))
    out["total"] = sum(out[k] for k in COLLECTIVES)
    return out


def roofline_terms(cost: dict, coll: dict) -> dict:
    """The three terms of a step from its ``cost`` ('flops', 'bytes
    accessed') and collective count ('total'), each in seconds on the
    H100's peaks, and the largest as the ``bottleneck``."""
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    cbytes = float(coll.get("total", 0))
    terms = {
        "flops_per_device": flops,
        "bytes_per_device": byts,
        "collective_bytes_per_device": cbytes,
        "compute_s": flops / PEAK_FLOPS["bfloat16"],
        "memory_s": byts / HBM_BW,
        "collective_s": cbytes / NVLINK_BW,
    }
    dom = max(("compute_s", "memory_s", "collective_s"),
              key=lambda k: terms[k])
    terms["bottleneck"] = dom.replace("_s", "")
    return terms


def model_flops(cfg, shape, n_active: int) -> float:
    """MODEL_FLOPS = 6·N·D for training, 2·N·D for inference forward
    (D = tokens processed globally per step)."""
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6 if shape.kind == "train" else 2
    return float(mult * n_active * tokens)
