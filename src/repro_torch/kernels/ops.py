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

from . import mttkrp_cuda, ref, syrk_cuda


def mttkrp(csf: CSF, factors: Sequence[torch.Tensor]) -> torch.Tensor:
    """MTTKRP for the mode ``csf`` was built for: (num_rows, R) in the
    factors' dtype."""
    if csf.vals.is_cuda:
        return mttkrp_cuda.mttkrp(csf, factors)
    return ref.mttkrp_ref(csf, factors).to(factors[csf.other_modes[0]].dtype)


def syrk(a: torch.Tensor) -> torch.Tensor:
    """G = A^T A: (R, R) in ``a``'s dtype, accumulated in float32."""
    if a.is_cuda:
        return syrk_cuda.syrk(a).to(a.dtype)
    return ref.syrk_ref(a).to(a.dtype)
