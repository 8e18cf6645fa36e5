"""Wrapper of the hand-written MTTKRP kernel (``csrc/mttkrp.cu``).

Replaces ``src/repro/kernels/mttkrp_pallas.py`` (the TPU one-hot
segment-matmul kernel) and the factor-row gathers its caller ran in XLA.
The design notes (one CTA per block of non-zeros, a shared-memory tile,
atomics into a zeroed output, gathers inside the kernel) are at the top of
the CUDA source.  The plain version is
:func:`repro_torch.kernels.ref.mttkrp_ref`; this wrapper takes CUDA
tensors only and launches or raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from repro_torch.core.csf import CSF

from . import _build

_DTYPES = (torch.float32, torch.bfloat16)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("mttkrp")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mttkrp_csf_launch.argtypes = [
        p, p, p, i, ctypes.POINTER(ctypes.c_void_p), i, i, p, p, i, i, i, i,
        i, p]
    lib.mttkrp_csf_launch.restype = ctypes.c_int
    return lib


def _check_inputs(csf: CSF, factors: Sequence[torch.Tensor]) -> None:
    dev = csf.vals.device
    if dev.type != "cuda":
        raise ValueError("mttkrp_cuda takes CUDA tensors; the plain version "
                         "is kernels.ref.mttkrp_ref")
    if len(factors) != csf.order:
        raise ValueError(f"{len(factors)} factors for an order-{csf.order} "
                         "workspace")
    if csf.vals.dtype not in _DTYPES:
        raise TypeError(f"vals dtype {csf.vals.dtype} is not float32/bfloat16")
    rank = int(factors[csf.other_modes[0]].shape[1])
    for m in csf.other_modes:
        f = factors[m]
        if f.device != dev:
            raise ValueError(f"factor {m} is on {f.device}, workspace on {dev}")
        if f.dtype != factors[csf.other_modes[0]].dtype or f.dtype not in _DTYPES:
            raise TypeError("factors must share one dtype, float32 or bfloat16")
        if f.dim() != 2 or tuple(f.shape) != (csf.dims[m], rank):
            raise ValueError(f"factor {m} has shape {tuple(f.shape)}, expected "
                             f"{(csf.dims[m], rank)}")
        if not f.is_contiguous():
            raise ValueError(f"factor {m} is not contiguous")
    for name in ("row_ids", "other_ids", "vals", "block_tile"):
        x = getattr(csf, name)
        if x.device != dev or not x.is_contiguous():
            raise ValueError(f"workspace {name} must be contiguous on {dev}")
    for name in ("row_ids", "other_ids", "block_tile"):
        if getattr(csf, name).dtype != torch.int32:
            raise TypeError(f"workspace {name} must be int32")
    if csf.padded_nnz % csf.block:
        raise ValueError("padded nnz is not a multiple of the block")


def mttkrp(csf: CSF, factors: Sequence[torch.Tensor]) -> torch.Tensor:
    """MTTKRP for the mode ``csf`` was built for: (num_rows, R), in the
    factors' dtype, accumulated in float32."""
    _check_inputs(csf, factors)
    lib = _library()
    fdtype = factors[csf.other_modes[0]].dtype
    rank = int(factors[csf.other_modes[0]].shape[1])
    out = torch.zeros((csf.num_rows, rank), dtype=torch.float32,
                      device=csf.vals.device)
    ptrs = (ctypes.c_void_p * len(csf.other_modes))(
        *[factors[m].data_ptr() for m in csf.other_modes])
    stream = torch.cuda.current_stream(csf.vals.device).cuda_stream
    code = lib.mttkrp_csf_launch(
        csf.row_ids.data_ptr(), csf.other_ids.data_ptr(), csf.vals.data_ptr(),
        int(csf.vals.dtype == torch.bfloat16), ptrs, len(csf.other_modes),
        int(fdtype == torch.bfloat16), csf.block_tile.data_ptr(),
        out.data_ptr(), csf.num_blocks, csf.block, csf.row_tile,
        csf.num_rows, rank, stream)
    _build.check(lib, code, "mttkrp kernel launch")
    mttkrp.launches += 1
    return out if fdtype == torch.float32 else out.to(fdtype)


mttkrp.launches = 0
