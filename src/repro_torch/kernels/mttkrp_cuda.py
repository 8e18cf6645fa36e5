"""Wrappers of the hand-written CSF kernel (``csrc/mttkrp.cu``): MTTKRP
and TTMc.

Replaces ``src/repro/kernels/mttkrp_pallas.py`` (the TPU one-hot
segment-matmul kernel) in both its uses, and the factor-row gathers (and
for TTMc the Kronecker rows and all-ones operand) its callers ran in XLA.
Both uses run the row-segmented kernel of ``csrc/segmented.cuh``: one warp
per range of the row-sorted stream, each lane's output columns summed in
registers and flushed when the row changes, the factor rows gathered inside
the kernel.  The launch is picked here, by :func:`mttkrp_geometry` (lane l
owns columns l + 32 k of the rank) and :func:`ttmc_geometry` (a lane owns a
run of consecutive Kronecker columns); the design notes are at the top of
the CUDA sources.  The plain versions are
:func:`repro_torch.kernels.ref.mttkrp_ref` and :func:`~repro_torch.kernels.
ref.ttmc_ref`; these wrappers take CUDA tensors only and launch or raise.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Sequence

import torch

from repro_torch.core.csf import CSF

from . import _build

_DTYPES = (torch.float32, torch.bfloat16)
LANES = 32               # kLanes in csrc/segmented.cuh
WARPS = 8                # kWarps: kThreads / kLanes
MAX_COLS_PER_LANE = 16   # the widest KroneckerRun the kernel is built for
MTTKRP_COLS = (1, 2, 4, 8)  # the K of KhatriRaoStrided the kernel is built for
SEGMENT = 512            # stored entries a warp takes


@dataclasses.dataclass(frozen=True)
class SegmentedGeometry:
    """One launch of the row-segmented kernel: each lane sums
    ``cols_per_lane`` output columns (consecutive for TTMc, 32 apart for
    MTTKRP), each warp ``segment`` consecutive stored entries, over
    ``ctas`` x ``slices`` CTAs (``slices`` along the width)."""

    cols_per_lane: int
    segment: int
    ctas: int
    slices: int

    @property
    def warps(self) -> int:
        return self.ctas * WARPS


def _ctas(padded_nnz: int) -> int:
    """CTAs that give every stored entry a warp, one range of SEGMENT
    entries a warp."""
    warps = -(-padded_nnz // SEGMENT)
    return max(1, -(-warps // WARPS))


def ttmc_geometry(padded_nnz: int, ranks: Sequence[int]) -> SegmentedGeometry:
    """The launch for a TTMc over ``padded_nnz`` stored entries and the
    other modes' ``ranks`` (ascending mode order; width = their product).

    Columns a lane: the fewest powers of two that cover the width in one
    32-lane slice, at most MAX_COLS_PER_LANE, then halved until they divide
    the last rank, so that a lane's run of columns lies inside one digit of
    every other factor.  Past 32 x that, the width takes more slices, each
    reading the stream again."""
    width = math.prod(ranks)
    if padded_nnz < 0 or width < 1:
        raise ValueError(f"no TTMc launch for {padded_nnz} entries, ranks "
                         f"{tuple(ranks)}")
    cpl = 1
    while cpl < MAX_COLS_PER_LANE and LANES * cpl < width:
        cpl *= 2
    while ranks[-1] % cpl:
        cpl //= 2
    return SegmentedGeometry(cols_per_lane=cpl, segment=SEGMENT,
                             ctas=_ctas(padded_nnz),
                             slices=-(-width // (LANES * cpl)))


def mttkrp_geometry(padded_nnz: int, rank: int) -> SegmentedGeometry:
    """The launch for an MTTKRP over ``padded_nnz`` stored entries at
    ``rank``.

    Lane l owns columns l + 32 k for k < K: K is the fewest of MTTKRP_COLS
    that cover the rank in one slice (at R = 35, K = 2 and the second group
    runs on lanes 0-2), so a warp gathers a factor row as one coalesced run.
    Past 32 x 8 = 256 columns the rank takes more slices of 256, each
    reading the stream again."""
    if padded_nnz < 0 or rank < 1:
        raise ValueError(f"no MTTKRP launch for {padded_nnz} entries, rank "
                         f"{rank}")
    need = -(-rank // LANES)
    k = next((k for k in MTTKRP_COLS if k >= need), MTTKRP_COLS[-1])
    return SegmentedGeometry(cols_per_lane=k, segment=SEGMENT,
                             ctas=_ctas(padded_nnz),
                             slices=-(-rank // (LANES * k)))


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("mttkrp")
    p, i, ip = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    lib.csf_launch.argtypes = [p, p, p, i, ctypes.POINTER(ctypes.c_void_p),
                               ip, i, i, p, ctypes.c_longlong, i, i, i, i, i,
                               p]
    lib.csf_launch.restype = ctypes.c_int
    return lib


def _check_inputs(csf: CSF, factors: Sequence[torch.Tensor], *,
                  kronecker: bool) -> tuple[int, ...]:
    """Raise on what the kernel does not take; returns the other modes'
    ranks (one shared rank unless ``kronecker``)."""
    dev = csf.vals.device
    if dev.type != "cuda":
        raise ValueError("mttkrp_cuda takes CUDA tensors; the plain versions "
                         "are kernels.ref.mttkrp_ref and ttmc_ref")
    if len(factors) != csf.order:
        raise ValueError(f"{len(factors)} factors for an order-{csf.order} "
                         "workspace")
    if csf.vals.dtype not in _DTYPES:
        raise TypeError(f"vals dtype {csf.vals.dtype} is not float32/bfloat16")
    first = factors[csf.other_modes[0]]
    ranks = []
    for m in csf.other_modes:
        f = factors[m]
        if f.device != dev:
            raise ValueError(f"factor {m} is on {f.device}, workspace on {dev}")
        if f.dtype != first.dtype or f.dtype not in _DTYPES:
            raise TypeError("factors must share one dtype, float32 or bfloat16")
        rank = int((f if kronecker else first).shape[-1])
        if f.dim() != 2 or tuple(f.shape) != (csf.dims[m], rank):
            raise ValueError(f"factor {m} has shape {tuple(f.shape)}, expected "
                             f"{(csf.dims[m], rank)}")
        if not f.is_contiguous():
            raise ValueError(f"factor {m} is not contiguous")
        if kronecker and f.data_ptr() % 16:
            raise ValueError(f"factor {m} does not start on 16 bytes (the "
                             "TTMc kernel reads its rows in 16-byte loads)")
        ranks.append(rank)
    for name in ("row_ids", "other_ids", "vals"):
        x = getattr(csf, name)
        if x.device != dev or not x.is_contiguous():
            raise ValueError(f"workspace {name} must be contiguous on {dev}")
    for name in ("row_ids", "other_ids"):
        if getattr(csf, name).dtype != torch.int32:
            raise TypeError(f"workspace {name} must be int32")
    return tuple(ranks)


def _launch(csf: CSF, factors: Sequence[torch.Tensor], *,
            kronecker: bool) -> torch.Tensor:
    """Check the inputs and run the kernel; the (num_rows, width) result
    in the factors' dtype, accumulated in float32."""
    ranks = _check_inputs(csf, factors, kronecker=kronecker)
    width = math.prod(ranks) if kronecker else ranks[0]
    lib = _library()
    other = csf.other_modes
    fdtype = factors[other[0]].dtype
    out = torch.zeros((csf.num_rows, width), dtype=torch.float32,
                      device=csf.vals.device)
    ptrs = (ctypes.c_void_p * len(other))(
        *[factors[m].data_ptr() for m in other])
    c_ranks = (ctypes.c_int * len(other))(*ranks)
    geo = (ttmc_geometry(csf.padded_nnz, ranks) if kronecker
           else mttkrp_geometry(csf.padded_nnz, width))
    stream = torch.cuda.current_stream(csf.vals.device).cuda_stream
    code = lib.csf_launch(
        csf.row_ids.data_ptr(), csf.other_ids.data_ptr(), csf.vals.data_ptr(),
        int(csf.vals.dtype == torch.bfloat16), ptrs, c_ranks, len(other),
        int(fdtype == torch.bfloat16), out.data_ptr(), csf.padded_nnz,
        int(kronecker), geo.cols_per_lane, geo.segment, geo.ctas, geo.slices,
        stream)
    _build.check(lib, code, "csf_launch kernel launch")
    return out if fdtype == torch.float32 else out.to(fdtype)


def mttkrp(csf: CSF, factors: Sequence[torch.Tensor]) -> torch.Tensor:
    """MTTKRP for the mode ``csf`` was built for: (num_rows, R), in the
    factors' dtype, accumulated in float32."""
    out = _launch(csf, factors, kronecker=False)
    mttkrp.launches += 1
    return out


def ttmc(csf: CSF, factors: Sequence[torch.Tensor]) -> torch.Tensor:
    """TTMc for the mode ``csf`` was built for: (num_rows, prod of the
    other modes' ranks) in ``kron_chain``'s column order, in the factors'
    dtype, accumulated in float32."""
    out = _launch(csf, factors, kronecker=True)
    ttmc.launches += 1
    return out


mttkrp.launches = 0
ttmc.launches = 0
