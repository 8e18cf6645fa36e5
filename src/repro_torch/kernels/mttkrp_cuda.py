"""Wrappers of the hand-written CSF kernel (``csrc/mttkrp.cu``): MTTKRP
and TTMc.

Replaces ``src/repro/kernels/mttkrp_pallas.py`` (the TPU one-hot
segment-matmul kernel) in both its uses, and the factor-row gathers (and
for TTMc the Kronecker rows and all-ones operand) its callers ran in XLA.
The design notes (one CTA per block of non-zeros, a shared-memory tile,
atomics into a zeroed output, gathers inside the kernel, the width split
across CTAs) are at the top of the CUDA source.  The plain versions are
:func:`repro_torch.kernels.ref.mttkrp_ref` and :func:`~repro_torch.kernels.
ref.ttmc_ref`; these wrappers take CUDA tensors only and launch or raise.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Sequence

import torch

from repro_torch.core.csf import CSF

from . import _build

_DTYPES = (torch.float32, torch.bfloat16)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("mttkrp")
    p, i, ip = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    lib.csf_launch.argtypes = [p, p, p, i, ctypes.POINTER(ctypes.c_void_p),
                               ip, i, i, p, p, i, i, i, i, i, p]
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
        ranks.append(rank)
    for name in ("row_ids", "other_ids", "vals", "block_tile"):
        x = getattr(csf, name)
        if x.device != dev or not x.is_contiguous():
            raise ValueError(f"workspace {name} must be contiguous on {dev}")
    for name in ("row_ids", "other_ids", "block_tile"):
        if getattr(csf, name).dtype != torch.int32:
            raise TypeError(f"workspace {name} must be int32")
    if csf.padded_nnz % csf.block:
        raise ValueError("padded nnz is not a multiple of the block")
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
    stream = torch.cuda.current_stream(csf.vals.device).cuda_stream
    code = lib.csf_launch(
        csf.row_ids.data_ptr(), csf.other_ids.data_ptr(), csf.vals.data_ptr(),
        int(csf.vals.dtype == torch.bfloat16), ptrs, c_ranks, len(other),
        int(fdtype == torch.bfloat16), csf.block_tile.data_ptr(),
        out.data_ptr(), csf.num_blocks, csf.block, csf.row_tile,
        csf.num_rows, int(kronecker), stream)
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
