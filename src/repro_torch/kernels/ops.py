"""The kernels' public entry points.

On a CUDA tensor each one launches its hand-written kernel (and raises if it
cannot be built or launched); on a CPU tensor it runs the plain version in
``ref``.  There is no other fallback.  Unlike the JAX package's wrappers
there is no rank padding: the 128-lane rule was the TPU's layout.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core.csf import CSF
from repro_torch.core.linearized import Linearized
from repro_torch.core.mttkrp import mttkrp_linearized
from repro_torch.core.ttmc import ttmc_linearized

from . import linearized_cuda, mttkrp_cuda, ref, syrk_cuda


def mttkrp(csf: CSF, factors: Sequence[torch.Tensor]) -> torch.Tensor:
    """MTTKRP for the mode ``csf`` was built for: (num_rows, R) in the
    factors' dtype."""
    if csf.vals.is_cuda:
        return mttkrp_cuda.mttkrp(csf, factors)
    return ref.mttkrp_ref(csf, factors).to(factors[csf.other_modes[0]].dtype)


def mttkrp_lin(lin: Linearized, factors: Sequence[torch.Tensor],
               mode: int) -> torch.Tensor:
    """MTTKRP for any mode from the linearized workspace: (dims[mode], R)
    in the factors' dtype.

    On a CUDA tensor every mode runs the kernel: the sort mode's stream is
    ordered by its output row (``linearized_cuda.mttkrp``), the other
    modes' is not (``linearized_cuda.mttkrp_off_sort``, which adds every
    run with atomics).  On a CPU tensor the sort mode runs the kernel's
    plain version and the other modes the plain decode and ``index_add_``
    of ``core.mttkrp.mttkrp_linearized``, as the reference computes them
    outside its kernel."""
    if lin.vals.is_cuda:
        if mode == lin.sort_mode:
            return linearized_cuda.mttkrp(lin, factors, mode)
        return linearized_cuda.mttkrp_off_sort(lin, factors, mode)
    if mode != lin.sort_mode:
        return mttkrp_linearized(lin, factors, mode)
    dtype = factors[next(m for m in range(lin.order) if m != mode)].dtype
    return ref.mttkrp_lin_ref(lin, factors, mode).to(dtype)


def ttmc(csf: CSF, factors: Sequence[torch.Tensor]) -> torch.Tensor:
    """TTMc for the mode ``csf`` was built for: (num_rows, prod of the
    other modes' ranks) in the factors' dtype."""
    if csf.vals.is_cuda:
        return mttkrp_cuda.ttmc(csf, factors)
    return ref.ttmc_ref(csf, factors).to(factors[csf.other_modes[0]].dtype)


def ttmc_lin(lin: Linearized, factors: Sequence[torch.Tensor],
             mode: int) -> torch.Tensor:
    """TTMc for any mode from the linearized workspace: (dims[mode], prod
    of the other modes' ranks) in the factors' dtype.  On a CUDA tensor
    every mode runs the kernel (``linearized_cuda.ttmc`` on the sort mode,
    ``ttmc_off_sort`` on the others); on a CPU tensor the sort mode runs
    its plain version and the others ``core.ttmc.ttmc_linearized``, as
    :func:`mttkrp_lin` does."""
    if lin.vals.is_cuda:
        if mode == lin.sort_mode:
            return linearized_cuda.ttmc(lin, factors, mode)
        return linearized_cuda.ttmc_off_sort(lin, factors, mode)
    if mode != lin.sort_mode:
        return ttmc_linearized(lin, factors, mode)
    dtype = factors[next(m for m in range(lin.order) if m != mode)].dtype
    return ref.ttmc_lin_ref(lin, factors, mode).to(dtype)


def syrk(a: torch.Tensor) -> torch.Tensor:
    """G = A^T A: (R, R) in ``a``'s dtype, accumulated in float32."""
    g = syrk_cuda.syrk(a) if a.is_cuda else ref.syrk_ref(a)
    return g if a.dtype == torch.float32 else g.to(a.dtype)
