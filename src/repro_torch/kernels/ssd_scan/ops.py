"""Mamba-2 SSD chunked scan: the wrapper of ``csrc/ssd.cu``.

``ssd_scan(x, dt, A, Bm, Cm, D, chunk=..., init_state=...)`` computes what
the reference's ``ssd_scan_bh`` + ``ops.ssd_scan`` compute
(``repro/kernels/ssd_scan/kernel.py:69``), y with ``D·x`` folded in, and
also what its model's ``ssd_chunked`` adds: an initial state in and the
final state out. It keeps the mixer's layout, x (b, l, h, p) and y
(b, l, h, p), where the reference moves heads in front and back.

The chunk follows the reference's rule, ``min(chunk, l)`` dividing l
(``ref.chunk_of``); a length it refuses raises ``ValueError`` on every
device. On a CPU tensor the plain ``ref.ssd_chunked`` runs in that chunk.
On a CUDA tensor the kernel launches or it raises, one device kernel per
call. It scans in sub-chunks of its own 64 tokens (``SUB``), which changes
the result only by rounding: the sequence is cut into segments of whole
sub-chunks, one CTA each, and the segments of one (batch, head, head_dim
block) form a thread-block cluster that passes the state along in order
(``ssd_plan`` picks the shape). It reads x, dt, B and C through their
strides (the mixer passes split views of its conv output, 16-byte aligned
at Mamba-2-130M, so nothing is copied) and needs only their last
dimension contiguous; a view of x, B or C whose address or strides are not
whole 16-byte units is copied to a contiguous tensor first.

Under grad mode, with an input that requires grad, the scan is a
``torch.autograd.Function`` (``_Scan``): on the card the forward kernel
also writes the state entering each sub-chunk, and the backward is
``ssd_scan_bwd``, the hand-written ``csrc/ssd_bwd.cu``; on the CPU the
forward is ``ssd_chunked`` and the backward its plain counterpart
``ref.ssd_chunked_bwd``. Without grad mode nothing is saved and the
forward launches as it does for serving.
"""
from __future__ import annotations

import ctypes
import functools
import itertools
import os
from typing import NamedTuple

import torch

from repro_torch.kernels.build import KernelLibrary, LaunchCounter, check
from repro_torch.kernels.ssd_scan.ref import (chunk_of, ssd_chunked,
                                              ssd_chunked_bwd)

SUB = 64             # tokens per sub-chunk (csrc kQ)
P_BLOCKS = (64, 32, 16)  # head_dim columns per CTA
MAX_CLUSTER = 8      # CTAs along the sequence in one cluster (csrc)
MAX_STATE = 256      # largest state size n (csrc kMaxN)
MAX_SMEM = 232448    # an H100 CTA's dynamic shared memory (csrc kMaxSmem)
SM_SMEM = 233472     # an H100 SM's shared memory, 1 KB of it kept per CTA
SMS = 132            # the H100's streaming multiprocessors
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
LIB = KernelLibrary(
    "ssd_scan",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                 "ssd.cu"),
    {"repro_ssd_scan": (_I, [_P] * 10 + [_I] * 6 + [_L] * 9 + [_I] * 4
                        + [_L, _P])})
COUNTER = LaunchCounter("ssd_scan")
BWD_LIB = KernelLibrary(
    "ssd_scan_bwd",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                 "ssd_bwd.cu"),
    {"repro_ssd_scan_bwd": (_I, [_P] * 23 + [_I] * 6 + [_L] * 9
                            + [_I, _I, _L, _P])})
BWD_COUNTER = LaunchCounter("ssd_scan_bwd")


class SsdPlan(NamedTuple):
    """The scan's launch: ``p_block`` head_dim columns per CTA, the
    sequence's ``subchunks`` 64-token sub-chunks cut into ``cluster``
    segments of ``per_cta`` (one CTA each, one thread-block cluster per
    (batch, head, p-block)), ``stages`` staging buffers, grid
    (cluster · b · h, p / p_block) of 256 threads, and ``smem`` bytes of
    shared memory per CTA (the kernel's layout; the C entry refuses other
    bytes)."""
    p_block: int
    subchunks: int
    cluster: int
    per_cta: int
    stages: int
    grid: tuple
    smem: int

    @property
    def ctas(self) -> int:
        """CTAs of the launch."""
        return self.grid[0] * self.grid[1]


def smem_bytes(item: int, p_block: int, n: int, stages: int,
               per_cta: int) -> int:
    """Shared memory of one CTA (csrc ``smem_bytes``): per stage B and C
    (64 × (n16 + 8)) and x (64 × p_block) in the input dtype (``item``
    bytes), dt and cum (64 fp32 each); then dt·x (64 × (p_block + 4)), the
    decay (64), the published and the carried state (p_block × (n16 + 8)
    each) in fp32 and 16 bytes; n16 is n rounded up to 16. With one
    sub-chunk per CTA the carried state takes the staged B's place when it
    fits there."""
    ns = -(-n // 16) * 16 + 8
    stage = 2 * SUB * ns * item + SUB * p_block * item + 2 * SUB * 4
    state = p_block * ns * 4
    in_b = per_cta == 1 and p_block * 4 <= SUB * item
    return (stages * stage + SUB * (p_block + 4) * 4 + SUB * 4
            + (1 if in_b else 2) * state + 16)


def ctas_per_sm(smem: int, p_block: int) -> int:
    """CTAs of the kernel an SM holds at once: by shared memory, and by
    registers (two 256-thread CTAs of at most 128 registers a thread up to
    32 head_dim columns, csrc ``__launch_bounds__``; one above)."""
    return max(1, min(SM_SMEM // (smem + 1024), 2 if p_block <= 32 else 1))


@functools.lru_cache(maxsize=256)   # host time: a prefill plans 24 calls
def ssd_plan(b: int, l: int, h: int, p: int, n: int, dtype, *,
             p_block=None, max_cluster: int = MAX_CLUSTER,
             stages=None) -> SsdPlan:
    """The launch at (b, l, h, p, n) and x's dtype. The sequence's
    ⌈l / 64⌉ sub-chunks go to at most ``max_cluster`` CTAs, as evenly as
    whole sub-chunks allow (none empty); with two sub-chunks or more a CTA
    double-buffers its staging when that fits (else it restages one
    buffer). The head_dim block (64, 32 or 16, dividing p, fitting the
    shared memory) is the one whose grid takes the fewest waves of the
    card (``ctas_per_sm`` a SM), of those the narrowest: more CTAs, each
    shorter (the probes of PERF.md §6 find it fastest). ``p_block``,
    ``max_cluster`` and ``stages`` force a choice (for probes and
    tests). Raises ``ValueError`` for a shape the kernel does not
    take."""
    if p % 16 or n % 8 or not 8 <= n <= MAX_STATE:
        raise ValueError(f"ssd_scan kernel needs head_dim a multiple of 16 "
                         f"and a state size a multiple of 8 up to "
                         f"{MAX_STATE}, got p={p}, n={n}")
    if not 1 <= max_cluster <= MAX_CLUSTER:
        raise ValueError(f"max_cluster must be 1..{MAX_CLUSTER}, got "
                         f"{max_cluster}")
    if stages not in (None, 1, 2):
        raise ValueError(f"stages must be 1 or 2, got {stages}")
    item = torch.finfo(dtype).bits // 8
    subchunks = -(-l // SUB)
    per = -(-subchunks // max_cluster)
    cluster = -(-subchunks // per)
    blocks = [pb for pb in P_BLOCKS if p % pb == 0]
    if p_block is not None:
        if p_block not in blocks:
            raise ValueError(f"p_block {p_block} must be one of {P_BLOCKS} "
                             f"and divide p={p}")
        blocks = [p_block]

    def stages_for(pb):
        if stages is not None:
            return stages
        two = per > 1 and smem_bytes(item, pb, n, 2, per) <= MAX_SMEM
        return 2 if two else 1

    def smem_of(pb):
        return smem_bytes(item, pb, n, stages_for(pb), per)
    fits = [pb for pb in blocks if smem_of(pb) <= MAX_SMEM]
    if not fits:
        raise ValueError(f"ssd_scan: no head_dim block fits shared memory "
                         f"at p={p}, n={n}, {dtype}")

    def waves(pb):
        ctas = cluster * b * h * (p // pb)
        return -(-ctas // (SMS * ctas_per_sm(smem_of(pb), pb)))
    pb = min(fits, key=lambda q: (waves(q), q))
    return SsdPlan(pb, subchunks, cluster, per, stages_for(pb),
                   (cluster * b * h, p // pb), smem_of(pb))


def _check_inputs(x, dt, A, Bm, Cm, D, init_state):
    if x.dim() != 4:
        raise ValueError(f"expected x (b, l, h, p), got {tuple(x.shape)}")
    b, l, h, p = x.shape
    n = Bm.shape[-1] if Bm.dim() == 3 else -1
    want = {"dt": (dt, (b, l, h)), "A": (A, (h,)), "Bm": (Bm, (b, l, n)),
            "Cm": (Cm, (b, l, n)), "D": (D, (h,)),
            "init_state": (init_state, (b, h, p, n))}
    for name, (t, shape) in want.items():
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, want "
                             f"{shape} for x {tuple(x.shape)}")
    if any(t is not None and t.device != x.device
           for t in (dt, A, Bm, Cm, D, init_state)):
        raise ValueError("the SSD scan's inputs must be on one device")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` if its address and its strides but the last are whole 16-byte
    units (what the kernel's 16-byte copies need), else a contiguous copy
    (whose rows then are, as the wrapper's shape checks ensure)."""
    unit = 16 // t.element_size()
    if t.data_ptr() % 16 == 0 and all(s % unit == 0
                                      for s in t.stride()[:-1]):
        return t
    return t.clone(memory_format=torch.contiguous_format)


class SsdBwdPlan(NamedTuple):
    """The backward's launch: ``p_block`` head_dim columns per slab (the
    local kernel's grid (sub-chunks, b·h, p / p_block); the main kernel
    loops over a head's slabs), ``group`` heads per main-kernel CTA, the
    main kernel's ``grid`` (sub-chunks, b·h / group) of 512 threads and
    ``smem`` bytes of shared memory per CTA (its layout; the C entry
    refuses other bytes), and ``scratch``, the floats of each fp32 scratch
    part the call allocates, in the C entry's order: the carried gradient
    R, the sub-chunks' log-decays, the dB and dC partials by head group,
    dA's and dD's by (batch, sub-chunk)."""
    p_block: int
    group: int
    grid: tuple
    smem: int
    scratch: tuple


BWD_VEC_FLOATS = 3264   # the main kernel's vectors (csrc kVFloats)
MAX_GROUP = 8           # heads per main-kernel CTA (csrc kMaxGroup)


def bwd_smem_bytes(item: int, p_block: int, n: int) -> int:
    """Shared memory of one main-kernel CTA (csrc ``MainLayout``) for
    inputs of ``item`` bytes: B and C (64 × (nmax + 8)) in the input
    dtype; C·Bᵀ, later Σ V (64 × 68); dy in two buffers and x (64 ×
    (p_block + 8)); R and S0 (p_block × (nmax + 4)); for bf16 x's staging
    (64 × p_block, 2 bytes); and 3264 floats of vectors and partial sums;
    nmax is 128 up to n 128, else 256."""
    nmax = 128 if n <= 128 else MAX_STATE
    return (2 * SUB * (nmax + 8) * item + SUB * (SUB + 4) * 4
            + 3 * SUB * (p_block + 8) * 4 + 2 * p_block * (nmax + 4) * 4
            + (SUB * p_block * 2 if item == 2 else 0) + 4 * BWD_VEC_FLOATS)


def bwd_group(b: int, l: int, h: int) -> int:
    """Heads per main-kernel CTA: the largest divisor of h up to 8 whose
    grid still gives every SM a CTA (more heads a CTA share C·Bᵀ and
    the dB / dC products; fewer CTAs than SMs would leave the card
    part idle), else 1."""
    nsub = -(-l // SUB)
    fill = [d for d in range(MAX_GROUP, 0, -1)
            if h % d == 0 and nsub * b * (h // d) >= SMS]
    return fill[0] if fill else 1


@functools.lru_cache(maxsize=256)
def ssd_bwd_plan(b: int, l: int, h: int, p: int, n: int,
                 dtype=torch.float32) -> SsdBwdPlan:
    """The backward's launch at (b, l, h, p, n) and x's dtype: the widest
    head_dim slab (64, 32, 16, dividing p) whose main-kernel CTA fits the
    shared memory (64 at n 128; at n 256 16 in f32, 32 in bf16) and the
    head group of ``bwd_group``. Raises ``ValueError`` for a shape the
    kernel does not take (b·h is the local kernel's grid rows, at most
    65535)."""
    if p % 16 or n % 8 or not 8 <= n <= MAX_STATE:
        raise ValueError(f"ssd_scan backward needs head_dim a multiple of 16 "
                         f"and a state size a multiple of 8 up to "
                         f"{MAX_STATE}, got p={p}, n={n}")
    if b * h > 65535:
        raise ValueError(f"ssd_scan backward takes b·h <= 65535, got "
                         f"{b * h}")
    item = torch.finfo(dtype).bits // 8
    blocks = [pb for pb in P_BLOCKS if p % pb == 0
              and bwd_smem_bytes(item, pb, n) <= MAX_SMEM]
    if not blocks:
        raise ValueError(f"ssd_scan backward: no head_dim block fits shared "
                         f"memory at p={p}, n={n}")
    pb = blocks[0]
    group = bwd_group(b, l, h)
    nsub = -(-l // SUB)
    scratch = (b * h * nsub * p * n, b * h * nsub,
               h // group * b * l * n, h // group * b * l * n,
               b * nsub * h, b * nsub * h)
    return SsdBwdPlan(pb, group, (nsub, b * h // group),
                      bwd_smem_bytes(item, pb, n), scratch)


def _strides(x, dt, Bm, Cm):
    return (x.stride(0), x.stride(1), x.stride(2), dt.stride(0),
            dt.stride(1), Bm.stride(0), Bm.stride(1), Cm.stride(0),
            Cm.stride(1))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _kernel_inputs(x, dt, A, Bm, Cm, D, init_state):
    """The inputs as both kernels read them: x, Bm, Cm of one dtype (f32 or
    bf16) in whole 16-byte units (``_aligned``), dt, A, D, init_state fp32
    (A, D, init_state contiguous), x, dt, Bm, Cm with a contiguous last
    dimension; raises ``TypeError`` / ``ValueError`` otherwise."""
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"ssd_scan kernel takes x, Bm, Cm of one dtype, f32 "
                        f"or bf16, got {x.dtype}/{Bm.dtype}/{Cm.dtype}")
    if any(t is not None and t.dtype != torch.float32
           for t in (dt, A, D, init_state)):
        raise TypeError("ssd_scan kernel takes dt, A, D and init_state in "
                        "float32")
    if any(t.stride(-1) != 1 for t in (x, dt, Bm, Cm)):
        raise ValueError("ssd_scan kernel needs x, dt, Bm and Cm with a "
                         "contiguous last dimension")
    return (_aligned(x), dt, A.contiguous(), _aligned(Bm), _aligned(Cm),
            None if D is None else D.contiguous(),
            None if init_state is None else init_state.contiguous())


def _launch(x, dt, A, Bm, Cm, D, init_state, save_states: bool):
    """The forward kernel on checked CUDA inputs: (y, final, the state
    entering each sub-chunk (b, h, ⌈l / 64⌉, p, n) fp32 when
    ``save_states``, else None)."""
    b, l, h, p = x.shape
    n = Bm.shape[-1]
    x, dt, A, Bm, Cm, D, init_state = _kernel_inputs(x, dt, A, Bm, Cm, D,
                                                     init_state)
    plan = ssd_plan(b, l, h, p, n, x.dtype)
    y = torch.empty((b, l, h, p), dtype=torch.float32, device=x.device)
    final = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    states = (torch.empty((b, h, plan.subchunks, p, n), dtype=torch.float32,
                          device=x.device) if save_states else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = LIB.lib().repro_ssd_scan(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), _ptr(D), _ptr(init_state), y.data_ptr(),
            final.data_ptr(), _ptr(states), _DTYPES[x.dtype], b, l, h, p,
            n, *_strides(x, dt, Bm, Cm), plan.p_block, plan.cluster,
            plan.per_cta, plan.stages, plan.smem, stream)
    check(rc, "ssd_scan launch")
    COUNTER.add()
    return y, final, states


def ssd_scan_bwd(x, dt, A, Bm, Cm, D, init_state, states, final, dy,
                 dfinal=None):
    """The scan's backward on the card (``csrc/ssd_bwd.cu``): the
    gradients (dx, ddt, dA, dBm, dCm, dD, d_init_state) of ``ssd_scan``'s
    y (with ``D·x``) and final state, given the forward's inputs, the
    state entering each 64-token sub-chunk and the final state (from the
    forward kernel, ``_launch(..., save_states=True)``), dy (b, l, h, p)
    and dfinal (b, h, p, n) or None (zeros). dx, dBm and dCm come in x's
    dtype, the rest in fp32; dD is None when D is, d_init_state when
    init_state is. One call is one counted launch sequence of four device
    kernels, as ``ssd_bwd_plan`` says: ``ssd_bwd_local_kernel``,
    ``ssd_bwd_carry_kernel``, ``ssd_bwd_main_kernel`` (one CTA per
    sub-chunk, batch and group of heads) and ``ssd_bwd_sum_kernel`` (the
    fixed-order sums of the head groups' dB and dC and of dA and dD).
    There is no CPU path here (``ref.ssd_chunked_bwd`` is the plain
    version)."""
    _check_inputs(x, dt, A, Bm, Cm, D, init_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan_bwd runs on cuda, not {x.device}")
    b, l, h, p = x.shape
    n = Bm.shape[-1]
    want = {"states": (states, (b, h, -(-l // SUB), p, n)),
            "final": (final, (b, h, p, n)), "dy": (dy, (b, l, h, p)),
            "dfinal": (dfinal, (b, h, p, n))}
    for name, (t, shape) in want.items():
        if t is not None and (tuple(t.shape) != shape
                              or t.device != x.device):
            raise ValueError(f"ssd_scan_bwd: {name} is {tuple(t.shape)} on "
                             f"{t.device}, want {shape} on {x.device}")
    if any(t is not None and t.dtype != torch.float32
           for t in (states, final, dy, dfinal)):
        raise TypeError("ssd_scan_bwd takes the states, dy and dfinal in "
                        "float32")
    x, dt, A, Bm, Cm, D, init_state = _kernel_inputs(x, dt, A, Bm, Cm, D,
                                                     init_state)
    plan = ssd_bwd_plan(b, l, h, p, n, x.dtype)
    states, final, dy = (_aligned(t.contiguous())
                         for t in (states, final, dy))
    dfinal = None if dfinal is None else _aligned(dfinal.contiguous())
    dev = x.device
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.empty((b, l, h, p), dtype=x.dtype, device=dev)
    dB = torch.empty((b, l, n), dtype=x.dtype, device=dev)
    dC = torch.empty((b, l, n), dtype=x.dtype, device=dev)
    ddt = torch.empty((b, l, h), **f32)
    dA = torch.empty((h,), **f32)
    dD = None if D is None else torch.empty((h,), **f32)
    dinit = None if init_state is None else torch.empty((b, h, p, n), **f32)
    # each part starts on a 16-byte boundary
    sizes = [-(-c // 4) * 4 for c in plan.scratch]
    buf = torch.empty((sum(sizes),), **f32)
    parts = [buf[o:o + c] for o, c in zip(
        itertools.accumulate([0] + sizes[:-1]), plan.scratch)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = BWD_LIB.lib().repro_ssd_scan_bwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), _ptr(D), states.data_ptr(), final.data_ptr(),
            dy.data_ptr(), _ptr(dfinal), dx.data_ptr(), dB.data_ptr(),
            dC.data_ptr(), ddt.data_ptr(), dA.data_ptr(), _ptr(dD),
            _ptr(dinit), *(t.data_ptr() for t in parts), _DTYPES[x.dtype],
            b, l, h, p, n, *_strides(x, dt, Bm, Cm), plan.p_block,
            plan.group, plan.smem, stream)
    check(rc, "ssd_scan_bwd launch")
    BWD_COUNTER.add()
    return dx, ddt, dA, dB, dC, dD, dinit


class _Scan(torch.autograd.Function):
    """The differentiable scan: forward and backward both kernels on the
    card, both plain versions on the CPU (the same Function either way,
    so the CPU tests drive what the card runs). The final state's gradient
    is None when training does not read it
    (``set_materialize_grads(False)``)."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, D, init_state, chunk):
        ctx.set_materialize_grads(False)
        if x.device.type == "cpu":
            y, final = ssd_chunked(x, dt, A, Bm, Cm, chunk, init_state, D)
            states = None
        else:
            y, final, states = _launch(x, dt, A, Bm, Cm, D, init_state,
                                       save_states=True)
        ctx.chunk = chunk
        ctx.save_for_backward(x, dt, A, Bm, Cm, D, init_state, states,
                              final)
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, dt, A, Bm, Cm, D, init_state, states, final = ctx.saved_tensors
        if dy is None and dfinal is None:
            return (None,) * 8
        if dy is None:
            dy = torch.zeros(x.shape, dtype=final.dtype, device=x.device)
        if x.device.type == "cpu":
            grads = ssd_chunked_bwd(x, dt, A, Bm, Cm, D, init_state, dy,
                                    dfinal, ctx.chunk)
        else:
            grads = ssd_scan_bwd(x, dt, A, Bm, Cm, D, init_state, states,
                                 final, dy.float(),
                                 None if dfinal is None else dfinal.float())
        ins = (x, dt, A, Bm, Cm, D, init_state)
        return (*(g.to(t.dtype) if need and g is not None else None
                  for g, t, need in zip(grads, ins, ctx.needs_input_grad)),
                None)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, D=None, *, chunk: int,
             init_state=None):
    """x (b, l, h, p); dt (b, l, h); A (h,); Bm/Cm (b, l, n); D (h,) or
    None; init_state (b, h, p, n) or None (zeros). Returns (y (b, l, h, p)
    fp32 with ``D·x`` added, final_state (b, h, p, n) fp32).

    The kernel takes x, Bm and Cm of one dtype, f32 or bf16; dt, A, D and
    init_state in fp32; p a multiple of 16, n a multiple of 8 up to 256;
    x, dt, Bm, Cm with a contiguous last dimension. One call is one device
    kernel, launched as ``ssd_plan`` says. x, Bm or Cm not laid out in
    whole 16-byte units (address, strides) is first copied to a contiguous
    tensor. With grad mode on and an input that requires grad, the call is
    differentiable (``_Scan``): the backward is ``ssd_scan_bwd`` on the
    card, ``ssd_chunked_bwd`` on the CPU."""
    _check_inputs(x, dt, A, Bm, Cm, D, init_state)
    c = chunk_of(x.shape[1], chunk)
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssd_scan runs on cpu or cuda, not {x.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, A, Bm, Cm, D, init_state)):
        return _Scan.apply(x, dt, A, Bm, Cm, D, init_state, c)
    if x.device.type == "cpu":
        return ssd_chunked(x, dt, A, Bm, Cm, c, init_state, D)
    y, final, _ = _launch(x, dt, A, Bm, Cm, D, init_state, save_states=False)
    return y, final
