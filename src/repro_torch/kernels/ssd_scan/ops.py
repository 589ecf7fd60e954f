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
On a CUDA tensor the kernel launches or it raises; it scans in sub-chunks
of its own 64 tokens, which changes the result only by rounding. It reads
x, dt, B and C through their strides (the mixer passes split views of its
conv output, so nothing is copied) and needs only their last dimension
contiguous.
"""
from __future__ import annotations

import ctypes
import os

import torch

from repro_torch.kernels.build import KernelLibrary, LaunchCounter, check
from repro_torch.kernels.ssd_scan.ref import chunk_of, ssd_chunked

P_BLOCK = 16         # head_dim columns per CTA (csrc kPB)
MAX_STATE = 256      # largest state size n (csrc kMaxN)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
LIB = KernelLibrary(
    "ssd_scan",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                 "ssd.cu"),
    {"repro_ssd_scan": (_I, [_P] * 9 + [_I] * 6 + [_L] * 9 + [_P])})
COUNTER = LaunchCounter("ssd_scan")


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


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor, D=None, *, chunk: int,
             init_state=None):
    """x (b, l, h, p); dt (b, l, h); A (h,); Bm/Cm (b, l, n); D (h,) or
    None; init_state (b, h, p, n) or None (zeros). Returns (y (b, l, h, p)
    fp32 with ``D·x`` added, final_state (b, h, p, n) fp32).

    The kernel takes x, Bm and Cm of one dtype, f32 or bf16; dt, A, D and
    init_state in fp32; p a multiple of 16, n a multiple of 4 up to 256;
    x, dt, Bm, Cm with a contiguous last dimension. One call is one device
    kernel."""
    _check_inputs(x, dt, A, Bm, Cm, D, init_state)
    b, l, h, p = x.shape
    n = Bm.shape[-1]
    c = chunk_of(l, chunk)
    if x.device.type == "cpu":
        return ssd_chunked(x, dt, A, Bm, Cm, c, init_state, D)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cpu or cuda, not {x.device}")
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"ssd_scan kernel takes x, Bm, Cm of one dtype, f32 "
                        f"or bf16, got {x.dtype}/{Bm.dtype}/{Cm.dtype}")
    if any(t is not None and t.dtype != torch.float32
           for t in (dt, A, D, init_state)):
        raise TypeError("ssd_scan kernel takes dt, A, D and init_state in "
                        "float32")
    if p % P_BLOCK or n % 4 or n > MAX_STATE:
        raise ValueError(f"ssd_scan kernel needs head_dim a multiple of "
                         f"{P_BLOCK} and a state size a multiple of 4 up to "
                         f"{MAX_STATE}, got p={p}, n={n}")
    if any(t.stride(-1) != 1 for t in (x, dt, Bm, Cm)):
        raise ValueError("ssd_scan kernel needs x, dt, Bm and Cm with a "
                         "contiguous last dimension")
    A = A.contiguous()
    D = None if D is None else D.contiguous()
    init_state = None if init_state is None else init_state.contiguous()
    y = torch.empty((b, l, h, p), dtype=torch.float32, device=x.device)
    final = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = LIB.lib().repro_ssd_scan(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), None if D is None else D.data_ptr(),
            None if init_state is None else init_state.data_ptr(),
            y.data_ptr(), final.data_ptr(), _DTYPES[x.dtype], b, l, h, p, n,
            x.stride(0), x.stride(1), x.stride(2), dt.stride(0),
            dt.stride(1), Bm.stride(0), Bm.stride(1), Cm.stride(0),
            Cm.stride(1), stream)
    check(rc, "ssd_scan launch")
    COUNTER.add()
    return y, final
