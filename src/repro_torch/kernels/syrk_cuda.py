"""Wrapper of the hand-written SYRK kernel (``csrc/syrk.cu``): G = A^T A.

Replaces ``src/repro/kernels/syrk_pallas.py``.  The design notes (one
launch, row tiles split over about one CTA per SM, the upper triangle in
4 x 4 register blocks, the last CTA summing the partials in a fixed order)
are at the top of the CUDA source; the launch geometry is picked here, in
:func:`syrk_geometry`.  The plain version is
:func:`repro_torch.kernels.ref.syrk_ref`; this wrapper takes CUDA tensors
only and launches or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from . import _build

_DTYPES = (torch.float32, torch.bfloat16)
THREADS = 256            # kThreads in csrc/syrk.cu
BLOCK = 4                # kBlk: a thread's BLOCK x BLOCK block of G
SMEM_BYTES = 48 * 1024   # kSmemBytes: the CTA's shared memory, at most


@dataclasses.dataclass(frozen=True)
class SyrkGeometry:
    """One launch: ``nparts`` CTAs along the rows (each loops over tiles
    of ``tile_rows`` rows), ``slices`` along the ``pairs`` blocks of G's
    upper triangle; their partials are summed in ``groups`` of ``group``
    CTAs along the rows, then the group sums."""

    tile_rows: int
    nparts: int
    slices: int
    pairs: int
    group: int

    @property
    def groups(self) -> int:
        return -(-self.nparts // self.group)

    @property
    def partial_floats(self) -> int:
        """Floats of the scratch: every CTA's partial blocks, then every
        group's sum."""
        return (self.nparts + self.groups) * self.pairs * BLOCK * BLOCK

    @property
    def tickets(self) -> int:
        """Counters of the scratch: one a group, one for the groups."""
        return self.groups + 1


@functools.lru_cache(maxsize=256)
def syrk_geometry(rows: int, rank: int, sms: int) -> SyrkGeometry:
    """The launch for a (rows, rank) matrix on a card with ``sms`` SMs.

    At most one CTA along the rows per SM, each looping over the fewest
    tiles that fit its share of the rows in the shared memory; tile rows are
    a multiple of 8 (so every tile starts on 16 bytes, in float32 and
    bfloat16) where the tile allows it.  The partials are summed in groups
    of ceil(sqrt(CTAs)), so each of the two levels of the sum reads about
    as many partials."""
    if rows < 0 or rank < 1 or sms < 1:
        raise ValueError(f"no SYRK launch for rows={rows}, rank={rank}, "
                         f"sms={sms}")
    nb = -(-rank // BLOCK)
    fit = SMEM_BYTES // (4 * nb * BLOCK)
    if fit < 1:
        raise ValueError(f"rank {rank} is too wide for one row of the "
                         f"{SMEM_BYTES}-byte shared tile")
    fit8 = fit // 8 * 8 if fit >= 8 else fit
    per_cta = -(-rows // sms)
    tiles_per = max(1, -(-per_cta // fit8))
    share = -(-per_cta // tiles_per)
    tile_rows = min(fit8, max(8, -(-share // 8) * 8))
    pairs = nb * (nb + 1) // 2
    nparts = max(1, min(sms, -(-rows // tile_rows)))
    return SyrkGeometry(tile_rows=tile_rows, nparts=nparts,
                        slices=-(-pairs // THREADS), pairs=pairs,
                        group=math.isqrt(nparts - 1) + 1)


@functools.cache
def _library() -> ctypes.CDLL:
    lib = _build.load("syrk")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.syrk_launch.argtypes = [p, i, p, p, p, ctypes.c_longlong, i, i, i, i,
                                i, p]
    lib.syrk_launch.restype = ctypes.c_int
    return lib


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


class _Scratch:
    """What the launches on one stream of one device share, in stream
    order: the ticket counters (zeroed here, left at 0 by the CTAs that
    draw the last tickets) and the partials buffer, each grown when a launch
    needs more."""

    def __init__(self, index: int) -> None:
        self.device = torch.device("cuda", index)
        self.tickets = torch.zeros(0, dtype=torch.int32, device=self.device)
        self.partial = torch.empty(0, dtype=torch.float32, device=self.device)

    def pointers(self, geo: SyrkGeometry) -> tuple[int, int]:
        """The partials and the tickets for a launch of ``geo``."""
        if self.partial.numel() < geo.partial_floats:
            self.partial = torch.empty(geo.partial_floats,
                                       dtype=torch.float32, device=self.device)
        if self.tickets.numel() < geo.tickets:
            self.tickets = torch.zeros(geo.tickets, dtype=torch.int32,
                                       device=self.device)
        return self.partial.data_ptr(), self.tickets.data_ptr()


@functools.cache
def _scratch(index: int, stream: int) -> _Scratch:
    return _Scratch(index)


def syrk(a: torch.Tensor) -> torch.Tensor:
    """G = A^T A for a (rows, R) matrix: (R, R) float32."""
    if not a.is_cuda:
        raise ValueError("syrk_cuda takes CUDA tensors; the plain version is "
                         "kernels.ref.syrk_ref")
    if a.dtype not in _DTYPES:
        raise TypeError(f"dtype {a.dtype} is not float32/bfloat16")
    if a.dim() != 2 or not a.is_contiguous():
        raise ValueError("syrk takes a contiguous 2-D matrix")
    rows, rank = a.shape
    index = a.get_device()
    geo = syrk_geometry(rows, rank, _sm_count(index))
    lib = _library()
    # PyTorch's current stream on the device, as a raw cudaStream_t
    stream = torch._C._cuda_getCurrentRawStream(index)
    scratch = _scratch(index, stream)
    partial, tickets = scratch.pointers(geo)
    out = torch.empty((rank, rank), dtype=torch.float32,
                      device=scratch.device)
    code = lib.syrk_launch(a.data_ptr(), a.dtype == torch.bfloat16, partial,
                           tickets, out.data_ptr(), rows, rank, geo.tile_rows,
                           geo.nparts, geo.slices, geo.group, stream)
    _build.check(lib, code, "syrk kernel launch")
    syrk.launches += 1
    return out


syrk.launches = 0
