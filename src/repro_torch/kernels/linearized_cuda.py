"""Wrappers of the hand-written linearized kernel (``csrc/linearized.cu``):
MTTKRP and TTMc on the workspace's sort mode.

Replaces ``src/repro/kernels/linearized_pallas.py`` (the TPU kernel with
the in-kernel row decode) in both its uses, and the decodes and factor-row
gathers (and for TTMc the Kronecker rows and all-ones operand) its callers
ran in XLA.  The kernel runs on the workspace's sort mode only; the design
notes are at the top of the CUDA source.  The plain versions are
:func:`repro_torch.kernels.ref.mttkrp_lin_ref` and :func:`~repro_torch.
kernels.ref.ttmc_lin_ref`; these wrappers take CUDA tensors only and launch
or raise.  The TTMc runs the row-segmented kernel of ``csrc/segmented.cuh``
on the packed stream, with the launch of :func:`~repro_torch.kernels.
mttkrp_cuda.ttmc_geometry`; the MTTKRP still runs the shared tile of
``csrc/tile.cuh``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Sequence

import torch

from repro_torch.core.linearized import Linearized

from . import _build
from .mttkrp_cuda import SegmentedGeometry, ttmc_geometry

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_ORDER = 8


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("linearized")
    p, i, ip = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    lib.lin_launch.argtypes = [p, p, p, i, ctypes.POINTER(ctypes.c_void_p),
                               ip, i, ip, ip, i, i, p, p, i, i, i, i, i, i, i,
                               i, i, p]
    lib.lin_launch.restype = ctypes.c_int
    return lib


def _check_inputs(lin: Linearized, factors: Sequence[torch.Tensor],
                  mode: int, *, kronecker: bool
                  ) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """Raise on what the kernel does not take; returns the other modes and
    their ranks (one shared rank unless ``kronecker``)."""
    if mode != lin.sort_mode:
        raise ValueError(
            f"the linearized kernel runs on the workspace's sort mode "
            f"{lin.sort_mode} only, asked mode {mode}")
    dev = lin.vals.device
    if dev.type != "cuda":
        raise ValueError("linearized_cuda takes CUDA tensors; the plain "
                         "versions are kernels.ref.mttkrp_lin_ref and "
                         "ttmc_lin_ref")
    if not 2 <= lin.order <= _MAX_ORDER:
        raise ValueError(f"order {lin.order} is outside 2..{_MAX_ORDER}")
    if len(factors) != lin.order:
        raise ValueError(f"{len(factors)} factors for an order-{lin.order} "
                         "workspace")
    if lin.vals.dtype not in _DTYPES:
        raise TypeError(f"vals dtype {lin.vals.dtype} is not float32/bfloat16")
    other = tuple(m for m in range(lin.order) if m != mode)
    first = factors[other[0]]
    ranks = []
    for m in other:
        f = factors[m]
        if f.device != dev:
            raise ValueError(f"factor {m} is on {f.device}, workspace on {dev}")
        if f.dtype != first.dtype or f.dtype not in _DTYPES:
            raise TypeError("factors must share one dtype, float32 or bfloat16")
        rank = int((f if kronecker else first).shape[-1])
        if f.dim() != 2 or tuple(f.shape) != (lin.dims[m], rank):
            raise ValueError(f"factor {m} has shape {tuple(f.shape)}, expected "
                             f"{(lin.dims[m], rank)}")
        if not f.is_contiguous():
            raise ValueError(f"factor {m} is not contiguous")
        if kronecker and f.data_ptr() % 16:
            raise ValueError(f"factor {m} does not start on 16 bytes (the "
                             "TTMc kernel reads its rows in 16-byte loads)")
        ranks.append(rank)
    for name in ("hi", "lo", "vals", "block_tile"):
        x = getattr(lin, name)
        if x.device != dev or not x.is_contiguous():
            raise ValueError(f"workspace {name} must be contiguous on {dev}")
    for name in ("hi", "lo", "block_tile"):
        if getattr(lin, name).dtype != torch.int32:
            raise TypeError(f"workspace {name} must be int32")
    if lin.padded_nnz % lin.block:
        raise ValueError("padded nnz is not a multiple of the block")
    return other, tuple(ranks)


def _launch(lin: Linearized, factors: Sequence[torch.Tensor], mode: int, *,
            kronecker: bool) -> torch.Tensor:
    """Check the inputs and run the kernel on the sort mode; the
    (dims[sort_mode], width) result in the factors' dtype, accumulated in
    float32."""
    other, ranks = _check_inputs(lin, factors, mode, kronecker=kronecker)
    width = math.prod(ranks) if kronecker else ranks[0]
    lib = _library()
    fdtype = factors[other[0]].dtype
    out = torch.zeros((lin.num_rows, width), dtype=torch.float32,
                      device=lin.vals.device)
    ptrs = (ctypes.c_void_p * len(other))(
        *[factors[m].data_ptr() for m in other])
    c_ranks = (ctypes.c_int * len(other))(*ranks)
    offsets = (ctypes.c_int * lin.order)(*lin.offsets)
    widths = (ctypes.c_int * lin.order)(*lin.widths)
    geo = (ttmc_geometry(lin.padded_nnz, ranks) if kronecker
           else SegmentedGeometry(0, 0, 0, 0))
    stream = torch.cuda.current_stream(lin.vals.device).cuda_stream
    code = lib.lin_launch(
        lin.hi.data_ptr(), lin.lo.data_ptr(), lin.vals.data_ptr(),
        int(lin.vals.dtype == torch.bfloat16), ptrs, c_ranks,
        int(fdtype == torch.bfloat16), offsets, widths, lin.order,
        lin.sort_mode, lin.block_tile.data_ptr(), out.data_ptr(),
        lin.num_blocks, lin.block, lin.row_tile, lin.num_rows, int(kronecker),
        geo.cols_per_lane, geo.segment, geo.ctas, geo.slices, stream)
    _build.check(lib, code, "lin_launch kernel launch")
    return out if fdtype == torch.float32 else out.to(fdtype)


def mttkrp(lin: Linearized, factors: Sequence[torch.Tensor],
           mode: int) -> torch.Tensor:
    """MTTKRP for the workspace's sort mode ``mode``: (dims[mode], R), in
    the factors' dtype, accumulated in float32."""
    out = _launch(lin, factors, mode, kronecker=False)
    mttkrp.launches += 1
    return out


def ttmc(lin: Linearized, factors: Sequence[torch.Tensor],
         mode: int) -> torch.Tensor:
    """TTMc for the workspace's sort mode ``mode``: (dims[mode], prod of
    the other modes' ranks) in ``kron_chain``'s column order, in the
    factors' dtype, accumulated in float32."""
    out = _launch(lin, factors, mode, kronecker=True)
    ttmc.launches += 1
    return out


mttkrp.launches = 0
ttmc.launches = 0
