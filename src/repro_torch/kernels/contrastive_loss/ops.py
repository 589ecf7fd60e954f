"""Fused contrastive loss: the wrappers of ``csrc/contrastive.cu`` and the
differentiable loss built on them.

``fwd_fused(x, y, inv_tau)`` returns the row and column LSE of
X·Yᵀ·inv_tau, as the reference's ``fwd_fused`` does
(``repro/kernels/contrastive_loss/kernel.py:107``); ``bwd_fused`` returns
dX, dY and dlog_tau from them, with the ``b_norm`` and ``with_diag``
arguments of the reference's ``bwd_fused`` (``kernel.py:185``).
``fused_contrastive_loss(x, y, log_tau)`` is the ``torch.autograd.Function``
counterpart of the reference's custom VJP (``ops.py:147-188``): one forward
call, one backward call, and the B×B matrix never reaches device memory.

The legacy 4-pass pair comes over too: ``row_col_lse`` (``kernel.py:295``)
returns the same LSEs, and ``grads``
(``kernel.py:337``) the same gradients from a dX sweep and a dY sweep;
``fused_loss_and_lse_4pass`` and ``fused_contrastive_loss_4pass`` are the
counterparts of the reference's ``ops.py:240-268``, its public baseline for
the fused pair.

On a CPU tensor the wrappers run the plain versions in ``ref.py``; on a
CUDA tensor they launch the kernels or raise; on a ``meta`` (or fake)
tensor they launch nothing, allocate what the launch would and record the
kernel's work (``kernels.build.record_work``). ``inv_tau`` stays on the
device (a 0-d tensor), so no wrapper synchronises with the host.

What does not carry over from the TPU module: its VMEM block model
(``pick_blocks``, ``autotune_blocks``, ``bwd_fits_fused``), the ``bm`` /
``bn`` / ``interpret`` arguments of every op and the B % 8 check, and the
compiled-mode fallback from ``bwd_fused`` to ``grads`` when the
VMEM-resident (B, D) dY carrier does not fit (``ops.py:179-184``,
``:231-237``). The Hopper backward keeps no resident dY: ``bwd_fused``
already computes dX and dY in two launches of one row-parallel kernel (X
against Y, then Y against X), which is the TPU's ``grads`` loop, so
``grads`` here launches that same sequence under its own entry and
counter, and there is nothing to fall back from. The TPU's
``row_col_lse`` runs a row sweep and a column sweep, each computing all of
A, and its ``fwd_fused`` one sweep that carries column statistics; on
Hopper both compute each tile of A once and fold partial row and column
statistics, one launch sequence (tile kernel + combine) that ``fwd_fused``
and ``row_col_lse`` each run under their own entry and counter. Any B >= 1
is taken. ``bwd_plan`` is the backward's launch plan (slices of the other
rows, grid, scratch) and ``lse_plan`` that of both forwards (tile edge,
grid, scratch), worked out here and passed to the kernels.
"""
from __future__ import annotations

import ctypes
import os
from typing import NamedTuple, Optional, Union

import torch

from repro_torch.kernels.build import (KernelLibrary, LaunchCounter, check,
                                      is_abstract, record_work)
from repro_torch.kernels.contrastive_loss.ref import (bwd_fused_ref,
                                                      fwd_fused_ref,
                                                      grads_ref,
                                                      row_col_lse_ref)
from repro_torch.kernels.work import (contrastive_bwd_work,
                                      contrastive_fwd_work)

MAX_D = 1024          # the backward keeps its dX / dY rows in shared memory
BWD_ROWS = 32         # rows of X (Y) per backward CTA (csrc kGS)
BWD_TILE = 256        # other rows per backward tile (csrc kGO)
MAX_SLICES = 8        # bounds the backward's scratch at 8 × (dX + dY)
LSE_TILES = (128, 64, 32)  # row_col_lse tile edges, largest first
SMS = 132             # the H100's streaming multiprocessors
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I = ctypes.c_void_p, ctypes.c_int
_BWD_ARGS = [_P] * 9 + [_I] * 3 + [ctypes.c_float, _I, _I, _P]
LIB = KernelLibrary(
    "contrastive",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                 "contrastive.cu"),
    {"repro_contrastive_fwd": (_I, [_P, _P, _P, _P, _P, _P, _I, _I, _I,
                                    _I, _P]),
     "repro_contrastive_bwd": (_I, _BWD_ARGS),
     "repro_contrastive_row_col_lse": (_I, [_P, _P, _P, _P, _P, _P, _I, _I,
                                            _I, _I, _P]),
     "repro_contrastive_grads": (_I, _BWD_ARGS)})
FWD_COUNTER = LaunchCounter("contrastive_fwd")
BWD_COUNTER = LaunchCounter("contrastive_bwd")
ROW_COL_LSE_COUNTER = LaunchCounter("contrastive_row_col_lse")
GRADS_COUNTER = LaunchCounter("contrastive_grads")


def _inv_tau_tensor(inv_tau: Union[float, torch.Tensor], like: torch.Tensor
                    ) -> torch.Tensor:
    """inv_tau as a 0-d fp32 tensor on ``like``'s device."""
    if isinstance(inv_tau, torch.Tensor):
        return inv_tau.detach().reshape(()).to(torch.float32)
    return torch.tensor(float(inv_tau), dtype=torch.float32,
                        device=like.device)


def _check_kernel_inputs(what: str, x, y, *rest):
    if x.dim() != 2 or y.shape != x.shape or x.shape[0] < 1:
        raise ValueError(f"{what}: expected x, y of one (B, D) shape, got "
                         f"{tuple(x.shape)}, {tuple(y.shape)}")
    if x.device.type != "cuda" and not is_abstract(x):
        raise ValueError(f"{what} runs on cpu or cuda, not {x.device}")
    if x.dtype not in _DTYPES or y.dtype != x.dtype:
        raise TypeError(f"{what} kernel takes f32 or bf16 x/y of one dtype, "
                        f"got {x.dtype}/{y.dtype}")
    if any(t.device != x.device for t in (y, *rest)):
        raise ValueError(f"{what}: all tensors must be on one device")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError(f"{what} kernel needs contiguous x, y")


def _lse(what, entry, counter, ref, x, y, inv_tau):
    """Row and column LSE through C entry ``entry`` (the tile sweep and
    the combine under ``lse_plan``), counted on ``counter``; ``ref`` on a
    CPU tensor."""
    inv = _inv_tau_tensor(inv_tau, x)
    if x.device.type == "cpu" and not is_abstract(x):
        return ref(x, y, inv)
    _check_kernel_inputs(what, x, y, inv)
    b, d = x.shape
    plan = lse_plan(b, x.dtype)
    row_lse = torch.empty((b,), dtype=torch.float32, device=x.device)
    col_lse = torch.empty((b,), dtype=torch.float32, device=x.device)
    part = torch.empty((plan.scratch_floats,), dtype=torch.float32,
                       device=x.device)

    def work():
        return contrastive_fwd_work(b, b, d, x.element_size())
    if is_abstract(x):
        record_work(counter.name, work)
        return row_lse, col_lse
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = getattr(LIB.lib(), entry)(
            x.data_ptr(), y.data_ptr(), inv.data_ptr(), row_lse.data_ptr(),
            col_lse.data_ptr(), part.data_ptr(), _DTYPES[x.dtype], b, d,
            plan.tile, stream)
    check(rc, f"contrastive {what} launch")
    counter.add()
    record_work(counter.name, work)
    return row_lse, col_lse


def fwd_fused(x: torch.Tensor, y: torch.Tensor,
              inv_tau: Union[float, torch.Tensor]):
    """x, y: (B, D) f32 or bf16; inv_tau: scalar. Returns (row_lse,
    col_lse), each (B,) fp32, of A = X·Yᵀ·inv_tau, from one sweep over
    tiles of A and a combine of the tiles' partials (``lse_plan``)."""
    return _lse("fwd_fused", "repro_contrastive_fwd", FWD_COUNTER,
                fwd_fused_ref, x, y, inv_tau)


class BwdPlan(NamedTuple):
    """The backward launch at batch B: ``blocks`` CTAs of 32 self rows per
    sweep, the other rows cut into ``slices`` runs of ``tiles_per_slice``
    256-row tiles, grid (blocks, 2 sweeps, slices), and the fp32 scratch:
    ``partial_floats`` (the slices' dX and dY partials, none with one
    slice) then ``dtau_floats`` (one dlog_tau partial per dX CTA)."""
    blocks: int
    slices: int
    tiles_per_slice: int
    grid: tuple
    partial_floats: int
    dtau_floats: int

    @property
    def scratch_floats(self) -> int:
        """Entries of the one fp32 scratch the wrapper allocates."""
        return self.partial_floats + self.dtau_floats


def bwd_plan(b: int, d: int) -> BwdPlan:
    """Slices enough that the two sweeps give about two waves of one CTA
    per SM (2·132 CTAs), at most ``MAX_SLICES`` and no more than the 256-row
    tiles of B, and none empty. From B = 4193 one slice fills the card and
    no partials are kept."""
    blocks = -(-b // BWD_ROWS)
    tiles = -(-b // BWD_TILE)
    want = max(1, min(-(-2 * SMS // (2 * blocks)), tiles, MAX_SLICES))
    per = -(-tiles // want)
    slices = -(-tiles // per)
    partial = 2 * b * d * slices if slices > 1 else 0
    return BwdPlan(blocks, slices, per, (blocks, 2, slices), partial,
                   blocks * slices)


def lse_smem_bytes(tile: int, itemsize: int) -> int:
    """Dynamic shared memory of one forward tile CTA (csrc ``LseLayout``):
    two stages of ``tile`` X and Y rows of a 32-wide embedding chunk (16
    bytes of padding a row), then the fp32 column max and sum of 8
    warps."""
    sld = 32 + 16 // itemsize
    return 2 * (2 * tile * sld) * itemsize + 4 * 2 * 8 * tile


def bwd_smem_bytes(d: int, itemsize: int) -> int:
    """Dynamic shared memory of one backward CTA (csrc ``GradLayout``): the
    fp32 accumulator of its ``BWD_ROWS`` rows at D rounded up to 4, the
    ring of score chunks or contraction pieces, dAᵀ, the LSEs and sums.
    Past ``MAX_D`` it does not fit a CTA."""
    sld, pld = 16 + 16 // itemsize, 256 + 16 // itemsize
    ring = 2 * max((BWD_ROWS + BWD_TILE) * sld, 16 * pld)
    dp = (d + 3) & ~3
    return 4 * (BWD_ROWS * dp + BWD_TILE * (BWD_ROWS + 4) + BWD_ROWS + 8) \
        + itemsize * ring


def bwd_buffers(b: int, d: int, device):
    """(plan, dX, dY, dlog_tau, scratch): what the backward wrapper
    allocates for one call, all fp32, the scratch as ``bwd_plan`` says."""
    plan = bwd_plan(b, d)

    def empty(shape):
        return torch.empty(shape, dtype=torch.float32, device=device)
    return (plan, empty((b, d)), empty((b, d)), empty(()),
            empty((plan.scratch_floats,)))


def _backward(what, entry, counter, ref, x, y, inv_tau, row_lse, col_lse,
              b_norm, with_diag):
    """The backward's dX sweep, dY sweep and dlog_tau sum through C entry
    ``entry``, counted on ``counter``; ``ref`` on a CPU tensor."""
    inv = _inv_tau_tensor(inv_tau, x)
    if x.device.type == "cpu" and not is_abstract(x):
        return ref(x, y, inv, row_lse, col_lse, b_norm=b_norm,
                   with_diag=with_diag)
    _check_kernel_inputs(what, x, y, inv, row_lse, col_lse)
    b, d = x.shape
    if d > MAX_D:
        raise ValueError(f"{what} kernel takes D <= {MAX_D}, got {d}")
    row_lse = row_lse.float().contiguous()
    col_lse = col_lse.float().contiguous()
    if row_lse.shape != (b,) or col_lse.shape != (b,):
        raise ValueError(f"row/col lse must be ({b},), got "
                         f"{tuple(row_lse.shape)}, {tuple(col_lse.shape)}")
    plan, dx, dy, dtau, part = bwd_buffers(b, d, x.device)

    def work():
        return contrastive_bwd_work(b, b, d, x.element_size())
    if is_abstract(x):
        record_work(counter.name, work)
        return dx, dy, dtau
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        rc = getattr(LIB.lib(), entry)(
            x.data_ptr(), y.data_ptr(), inv.data_ptr(), row_lse.data_ptr(),
            col_lse.data_ptr(), dx.data_ptr(), dy.data_ptr(),
            dtau.data_ptr(), part.data_ptr(), _DTYPES[x.dtype], b, d,
            float(2.0 * (b if b_norm is None else b_norm)), int(with_diag),
            plan.slices, stream)
    check(rc, f"contrastive {what} launch")
    counter.add()
    record_work(counter.name, work)
    return dx, dy, dtau


def bwd_fused(x: torch.Tensor, y: torch.Tensor,
              inv_tau: Union[float, torch.Tensor], row_lse: torch.Tensor,
              col_lse: torch.Tensor, *, b_norm: Optional[int] = None,
              with_diag: bool = True):
    """Returns (dX, dY, dlog_tau) in fp32 from the forward's row/column LSE.
    ``b_norm`` overrides the 1/(2B) normalisation batch; ``with_diag=False``
    drops the -2·δ_ij positive-pair term."""
    return _backward("bwd_fused", "repro_contrastive_bwd", BWD_COUNTER,
                     bwd_fused_ref, x, y, inv_tau, row_lse, col_lse, b_norm,
                     with_diag)


def chunk_row_col_lse(x: torch.Tensor, y_chunk: torch.Tensor,
                      inv_tau: Union[float, torch.Tensor]):
    """Row and column LSE of one square chunk X·Y_chunkᵀ·inv_tau: the
    streaming unit of the cross-shard chunked loss
    (``core/distributed_loss.py``, reference ``ops.py:200``). ``x`` is the
    rank's local (B_local, D) block, ``y_chunk`` one rank's (B_local, D)
    block. Returns ((B_local,) fp32 partial row LSE over this chunk's
    columns, (B_local,) fp32 partial column LSE over the local rows), from
    one ``fwd_fused`` call (its launch and counter)."""
    return fwd_fused(x, y_chunk, inv_tau)


def chunk_grads(x: torch.Tensor, y_chunk: torch.Tensor,
                inv_tau: Union[float, torch.Tensor], row_lse: torch.Tensor,
                col_lse_chunk: torch.Tensor, *, b_norm: int,
                with_diag: bool = False):
    """dX, dY and dlog_tau contributions of one square chunk of the
    cross-shard loss (reference ``ops.py:215``): ``row_lse`` is the GLOBAL
    row LSE of the local rows, ``col_lse_chunk`` the GLOBAL column LSE of
    this chunk's columns, ``b_norm`` the global batch, and ``with_diag``
    True only on the rank's own chunk, where the positive pairs are.
    Returns ((B_local, D) fp32 dX partial, (B_local, D) fp32 dY partial for
    this chunk's columns, scalar fp32 dlog_tau partial).

    Always one ``bwd_fused`` call. The reference takes its two-sweep
    ``grads`` kernel only when the fused backward's VMEM residency does not
    fit (``bwd_fits_fused``); the Hopper ``bwd_fused`` keeps no resident dY
    and runs the same device loop as ``grads``, so there is nothing to fall
    back from (module docstring)."""
    return bwd_fused(x, y_chunk, inv_tau, row_lse, col_lse_chunk,
                     b_norm=b_norm, with_diag=with_diag)


class LsePlan(NamedTuple):
    """The forwards' launch (``fwd_fused``, ``row_col_lse``) at batch B:
    ``tile`` × ``tile`` tiles of A, ``tiles`` of them along each side,
    grid (tiles, tiles), and the fp32 scratch of partial row and column
    (max, sum): ``scratch_floats`` = 4 · tiles · B."""
    tile: int
    tiles: int
    grid: tuple
    scratch_floats: int


def lse_plan(b: int, dtype=torch.float32) -> LsePlan:
    """The largest tile edge whose ⌈B/T⌉² tiles give every SM a CTA (128
    from B = 1409), else the smallest (32): more, smaller tiles where 128
    would leave most of the card idle (B 512 gives 16 tiles of 128, 256 of
    32). bf16 inputs take 64 at most: the 8×8 register block of a 128 tile
    spills when each load widens bf16 to fp32 (1.6× slower at B 2048 × D
    512 than 64, PERF.md §6)."""
    tiles = LSE_TILES if dtype == torch.float32 else LSE_TILES[1:]
    tile = next((t for t in tiles if (-(-b // t)) ** 2 >= SMS), tiles[-1])
    n = -(-b // tile)
    return LsePlan(tile, n, (n, n), 4 * n * b)


def row_col_lse(x: torch.Tensor, y: torch.Tensor,
                inv_tau: Union[float, torch.Tensor]):
    """The legacy pair's forward: (row_lse, col_lse), each (B,) fp32, of
    A = X·Yᵀ·inv_tau, the same function as ``fwd_fused`` (and the same
    device launches)."""
    return _lse("row_col_lse", "repro_contrastive_row_col_lse",
                ROW_COL_LSE_COUNTER, row_col_lse_ref, x, y, inv_tau)


def grads(x: torch.Tensor, y: torch.Tensor,
          inv_tau: Union[float, torch.Tensor], row_lse: torch.Tensor,
          col_lse: torch.Tensor, *, b_norm: Optional[int] = None,
          with_diag: bool = True):
    """The legacy pair's backward: (dX, dY, dlog_tau) in fp32, the same
    function as ``bwd_fused`` (and the same device loop)."""
    return _backward("grads", "repro_contrastive_grads", GRADS_COUNTER,
                     grads_ref, x, y, inv_tau, row_lse, col_lse, b_norm,
                     with_diag)


def _loss(x, y, inv_tau, row_lse, col_lse):
    """0.5·(mean(row_lse − diag) + mean(col_lse − diag)), fp32."""
    diag = torch.sum(x.float() * y.float(), dim=1) * inv_tau
    return 0.5 * (torch.mean(row_lse - diag) + torch.mean(col_lse - diag))


def _fwd(x, y, log_tau):
    inv_tau = torch.exp(-log_tau.float())
    row_lse, col_lse = fwd_fused(x, y, inv_tau)
    return _loss(x, y, inv_tau, row_lse, col_lse), inv_tau, row_lse, col_lse


class _FusedContrastiveLoss(torch.autograd.Function):
    """Paper Eq. 3 through the fused kernels: one forward launch, one
    backward launch (the reference's ``_fwd`` / ``_bwd``)."""

    @staticmethod
    def forward(ctx, x, y, log_tau):
        loss, inv_tau, row_lse, col_lse = _fwd(x.detach(), y.detach(),
                                               log_tau.detach())
        ctx.save_for_backward(x, y, inv_tau, row_lse, col_lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        x, y, inv_tau, row_lse, col_lse = ctx.saved_tensors
        dx, dy, dtau = bwd_fused(x, y, inv_tau, row_lse, col_lse)
        return (g * dx).to(x.dtype), (g * dy).to(y.dtype), g * dtau


def fused_contrastive_loss(x: torch.Tensor, y: torch.Tensor,
                           log_tau: torch.Tensor) -> torch.Tensor:
    """x, y: (B, D) fp32/bf16 unit-norm embeddings; log_tau: scalar fp32.
    Returns the scalar fp32 loss 0.5·(mean(row_lse − diag) +
    mean(col_lse − diag)); differentiable in all three (dX, dY in the
    input dtype, dlog_tau fp32)."""
    return _FusedContrastiveLoss.apply(x, y, log_tau)


def fused_loss_and_lse(x: torch.Tensor, y: torch.Tensor,
                       log_tau: torch.Tensor):
    """Non-differentiable entry returning (loss, row_lse, col_lse) for
    diagnostics: a scalar fp32 loss and two (B,) fp32 LSE vectors."""
    with torch.no_grad():
        loss, _, row_lse, col_lse = _fwd(x, y, log_tau)
    return loss, row_lse, col_lse


def fused_loss_and_lse_4pass(x: torch.Tensor, y: torch.Tensor,
                             log_tau: torch.Tensor):
    """The legacy forward (``row_col_lse``), non-differentiable: returns
    (loss, row_lse, col_lse), a scalar fp32 loss and two (B,) fp32 LSE
    vectors."""
    with torch.no_grad():
        inv_tau = torch.exp(-log_tau.float())
        row_lse, col_lse = row_col_lse(x, y, inv_tau)
        return _loss(x, y, inv_tau, row_lse, col_lse), row_lse, col_lse


def fused_contrastive_loss_4pass(x: torch.Tensor, y: torch.Tensor,
                                 log_tau: torch.Tensor):
    """The legacy 4-pass path (``row_col_lse`` then ``grads``), not
    differentiable: returns (loss, dX, dY, dlog_tau), dX and dY (B, D)
    fp32 and the rest fp32 scalars."""
    with torch.no_grad():
        loss, row_lse, col_lse = fused_loss_and_lse_4pass(x, y, log_tau)
        dx, dy, dtau = grads(x, y, torch.exp(-log_tau.float()), row_lse,
                             col_lse)
    return loss, dx, dy, dtau
