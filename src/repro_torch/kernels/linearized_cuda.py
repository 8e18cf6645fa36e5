"""Wrappers of the hand-written linearized kernel (``csrc/linearized.cu``):
MTTKRP and TTMc on every mode of the workspace.

Replaces ``src/repro/kernels/linearized_pallas.py`` (the TPU kernel with
the in-kernel row decode) in both its uses on the sort mode, and the decodes
and factor-row gathers (and for TTMc the Kronecker rows and all-ones
operand) its callers ran in XLA; on the other modes, where the reference
has no kernel, the jnp decode and scatter of ``core.mttkrp.
mttkrp_linearized`` and ``core.ttmc.ttmc_linearized``.  Every mode runs the
row-segmented kernel of ``csrc/segmented.cuh`` on the packed stream, with
the launch of :func:`~repro_torch.kernels.mttkrp_cuda.mttkrp_geometry` or
:func:`~repro_torch.kernels.mttkrp_cuda.ttmc_geometry`: the sort mode's
rows never decrease, so :func:`mttkrp` and :func:`ttmc` store a row when it
changes; the other modes' rows recur anywhere, so :func:`mttkrp_off_sort`
and :func:`ttmc_off_sort` add every run of equal rows with atomics.  The
design notes are at the top of the CUDA sources.  The plain versions are
:func:`repro_torch.kernels.ref.mttkrp_lin_ref` and :func:`~repro_torch.
kernels.ref.ttmc_lin_ref`, for any mode; these wrappers take CUDA tensors
only and launch or raise.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Sequence

import torch

from repro_torch.core.linearized import Linearized

from . import _build
from .mttkrp_cuda import mttkrp_geometry, ttmc_geometry

_DTYPES = (torch.float32, torch.bfloat16)
_MAX_ORDER = 8


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("linearized")
    p, i, ip = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    lib.lin_launch.argtypes = [p, p, p, i, ctypes.POINTER(ctypes.c_void_p),
                               ip, i, i, i, i, ip, ip, i, p,
                               ctypes.c_longlong, i, i, i, i, i, p]
    lib.lin_launch.restype = ctypes.c_int
    return lib


def stream_fields(lin: Linearized, mode: int
                  ) -> tuple[tuple[int, int], tuple[int, ...],
                             tuple[tuple[int, int], ...]]:
    """The kernel's view of the packed stream for target ``mode``: the
    (offset, width) field of its row, the other modes in ascending mode
    order (the sort mode among them when it is not the target), and their
    fields, in the order the factors are handed to the kernel."""
    other = tuple(m for m in range(lin.order) if m != mode)
    offsets, widths = lin.offsets, lin.widths
    return ((offsets[mode], widths[mode]), other,
            tuple((offsets[m], widths[m]) for m in other))


def _check_inputs(lin: Linearized, factors: Sequence[torch.Tensor],
                  mode: int, *, kronecker: bool) -> tuple[int, ...]:
    """Raise on what the kernel does not take; returns the other modes'
    ranks in ascending mode order (one shared rank unless ``kronecker``)."""
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
    other = [m for m in range(lin.order) if m != mode]
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
    for name in ("hi", "lo", "vals"):
        x = getattr(lin, name)
        if x.device != dev or not x.is_contiguous():
            raise ValueError(f"workspace {name} must be contiguous on {dev}")
    for name in ("hi", "lo"):
        if getattr(lin, name).dtype != torch.int32:
            raise TypeError(f"workspace {name} must be int32")
    return tuple(ranks)


def _launch(lin: Linearized, factors: Sequence[torch.Tensor], mode: int, *,
            kronecker: bool) -> torch.Tensor:
    """Check the inputs and run the kernel on ``mode``, the sorted flush on
    the sort mode and the atomic one on the others; the (dims[mode], width)
    result in the factors' dtype, accumulated in float32."""
    ranks = _check_inputs(lin, factors, mode, kronecker=kronecker)
    width = math.prod(ranks) if kronecker else ranks[0]
    lib = _library()
    (row_offset, row_width), other, fields = stream_fields(lin, mode)
    fdtype = factors[other[0]].dtype
    out = torch.zeros((lin.dims[mode], width), dtype=torch.float32,
                      device=lin.vals.device)
    n = len(other)
    ptrs = (ctypes.c_void_p * n)(*[factors[m].data_ptr() for m in other])
    c_ranks = (ctypes.c_int * n)(*ranks)
    offsets = (ctypes.c_int * n)(*[off for off, _ in fields])
    widths = (ctypes.c_int * n)(*[w for _, w in fields])
    geo = (ttmc_geometry(lin.padded_nnz, ranks) if kronecker
           else mttkrp_geometry(lin.padded_nnz, width))
    stream = torch.cuda.current_stream(lin.vals.device).cuda_stream
    code = lib.lin_launch(
        lin.hi.data_ptr(), lin.lo.data_ptr(), lin.vals.data_ptr(),
        int(lin.vals.dtype == torch.bfloat16), ptrs, c_ranks, n,
        int(fdtype == torch.bfloat16), row_offset, row_width, offsets, widths,
        int(mode == lin.sort_mode), out.data_ptr(), lin.padded_nnz,
        int(kronecker), geo.cols_per_lane, geo.segment, geo.ctas, geo.slices,
        stream)
    _build.check(lib, code, "lin_launch kernel launch")
    return out if fdtype == torch.float32 else out.to(fdtype)


def _on_sort_mode(lin: Linearized, mode: int) -> None:
    if mode != lin.sort_mode:
        raise ValueError(
            f"the linearized kernel runs on the workspace's sort mode "
            f"{lin.sort_mode} only, asked mode {mode} (the other modes: "
            "mttkrp_off_sort, ttmc_off_sort)")


def _off_sort_mode(lin: Linearized, mode: int) -> None:
    if not 0 <= mode < lin.order:
        raise ValueError(f"mode {mode} is outside 0..{lin.order - 1}")
    if mode == lin.sort_mode:
        raise ValueError(
            f"mode {mode} is the workspace's sort mode: the off-sort kernel "
            "takes the other modes (the sort mode: mttkrp, ttmc)")


def mttkrp(lin: Linearized, factors: Sequence[torch.Tensor],
           mode: int) -> torch.Tensor:
    """MTTKRP for the workspace's sort mode ``mode``: (dims[mode], R), in
    the factors' dtype, accumulated in float32."""
    _on_sort_mode(lin, mode)
    out = _launch(lin, factors, mode, kronecker=False)
    mttkrp.launches += 1
    return out


def ttmc(lin: Linearized, factors: Sequence[torch.Tensor],
         mode: int) -> torch.Tensor:
    """TTMc for the workspace's sort mode ``mode``: (dims[mode], prod of
    the other modes' ranks) in ``kron_chain``'s column order, in the
    factors' dtype, accumulated in float32."""
    _on_sort_mode(lin, mode)
    out = _launch(lin, factors, mode, kronecker=True)
    ttmc.launches += 1
    return out


def mttkrp_off_sort(lin: Linearized, factors: Sequence[torch.Tensor],
                    mode: int) -> torch.Tensor:
    """MTTKRP for a mode other than the workspace's sort mode: (dims[mode],
    R), in the factors' dtype, accumulated in float32 (every run added
    with atomics, so the last bits change from call to call)."""
    _off_sort_mode(lin, mode)
    out = _launch(lin, factors, mode, kronecker=False)
    mttkrp_off_sort.launches += 1
    return out


def ttmc_off_sort(lin: Linearized, factors: Sequence[torch.Tensor],
                  mode: int) -> torch.Tensor:
    """TTMc for a mode other than the workspace's sort mode: (dims[mode],
    prod of the other modes' ranks, the sort mode's among them) in
    ``kron_chain``'s column order, in the factors' dtype, accumulated in
    float32 with atomics."""
    _off_sort_mode(lin, mode)
    out = _launch(lin, factors, mode, kronecker=True)
    ttmc_off_sort.launches += 1
    return out


mttkrp.launches = 0
ttmc.launches = 0
mttkrp_off_sort.launches = 0
ttmc_off_sort.launches = 0
