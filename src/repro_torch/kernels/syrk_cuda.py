"""Wrapper of the hand-written SYRK kernel (``csrc/syrk.cu``): G = A^T A.

Replaces ``src/repro/kernels/syrk_pallas.py``.  The design notes (row tiles
spread over CTAs, per-CTA partial Grams summed by a second pass in a fixed
order) are at the top of the CUDA source.  The plain version is
:func:`repro_torch.kernels.ref.syrk_ref`; this wrapper takes CUDA tensors
only and launches or raises.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

_DTYPES = (torch.float32, torch.bfloat16)
_TILE_ROWS = 64  # kTileRows in csrc/syrk.cu


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("syrk")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.syrk_launch.argtypes = [p, i, p, p, ctypes.c_longlong, i, i, p]
    lib.syrk_launch.restype = ctypes.c_int
    return lib


def syrk(a: torch.Tensor) -> torch.Tensor:
    """G = A^T A for a (rows, R) matrix: (R, R) float32."""
    if a.device.type != "cuda":
        raise ValueError("syrk_cuda takes CUDA tensors; the plain version is "
                         "kernels.ref.syrk_ref")
    if a.dtype not in _DTYPES:
        raise TypeError(f"dtype {a.dtype} is not float32/bfloat16")
    if a.dim() != 2 or not a.is_contiguous():
        raise ValueError("syrk takes a contiguous 2-D matrix")
    rows, rank = (int(s) for s in a.shape)
    lib = _library()
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    nparts = max(1, min(-(-rows // _TILE_ROWS), 2 * sms))
    partial = torch.empty((nparts, rank * rank), dtype=torch.float32,
                          device=a.device)
    out = torch.empty((rank, rank), dtype=torch.float32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    code = lib.syrk_launch(a.data_ptr(), int(a.dtype == torch.bfloat16),
                           partial.data_ptr(), out.data_ptr(), rows, rank,
                           nparts, stream)
    _build.check(lib, code, "syrk kernel launch")
    syrk.launches += 1
    return out


syrk.launches = 0
