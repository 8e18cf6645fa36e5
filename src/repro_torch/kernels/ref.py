"""Plain PyTorch versions of the hand-written kernels.

They are what ``kernels.ops`` runs on a CPU tensor, what the CPU tests hold
against the JAX package, and what ``chip_smoke.py`` holds each kernel to on
the card.  All accumulate in float32, as the kernels do.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from repro_torch.core.csf import CSF
from repro_torch.core.linearized import Linearized
from repro_torch.core.ttmc import _kron_ids_csf, _kron_sum


def mttkrp_ref(csf: CSF, factors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Gather, multiply, scatter-add over the unified workspace; float32
    result of shape (num_rows, R).

    Padding entries carry val == 0 and point at a valid row inside their
    tile, so they add exact zeros; the sum does not rely on the row sort.
    """
    prod = csf.vals[:, None].float()
    for i, m in enumerate(csf.other_modes):
        prod = prod * factors[m][csf.other_ids[:, i]].float()
    out = torch.zeros((csf.num_rows, prod.shape[1]), dtype=torch.float32,
                      device=prod.device)
    return out.index_add_(0, csf.row_ids, prod)


def mttkrp_lin_ref(lin: Linearized, factors: Sequence[torch.Tensor],
                   mode: int) -> torch.Tensor:
    """Decode, gather, multiply, scatter-add over the linearized workspace,
    for any mode; float32 result of shape (dims[mode], R)."""
    prod = lin.vals[:, None].float()
    for m in range(lin.order):
        if m != mode:
            prod = prod * factors[m][lin.decode(m)].float()
    out = torch.zeros((lin.dims[mode], prod.shape[1]), dtype=torch.float32,
                      device=prod.device)
    return out.index_add_(0, lin.decode(mode), prod)


def ttmc_ref(csf: CSF, factors: Sequence[torch.Tensor], *,
             chunk: Optional[int] = None) -> torch.Tensor:
    """Gather, Kronecker product, scatter-add over the CSF workspace,
    ``chunk`` stored entries at a time (sized by ``core.ttmc.
    TTMC_CHUNK_BYTES`` when None, so the extra memory stays bounded at any
    width); float32 result of shape (num_rows, prod of the other ranks)."""
    return _kron_sum(csf.vals, csf.row_ids, _kron_ids_csf(csf), factors,
                     csf.num_rows, dtype=torch.float32, chunk=chunk)


def ttmc_lin_ref(lin: Linearized, factors: Sequence[torch.Tensor],
                 mode: int, *, chunk: Optional[int] = None) -> torch.Tensor:
    """Decode, gather, Kronecker product, scatter-add over the linearized
    workspace, for any mode, in chunks as :func:`ttmc_ref`; float32 result
    of shape (dims[mode], prod of the other ranks)."""
    ids = [(m, lin.decode(m)) for m in range(lin.order) if m != mode]
    return _kron_sum(lin.vals, lin.decode(mode), ids, factors,
                     lin.dims[mode], dtype=torch.float32, chunk=chunk)


def syrk_ref(a: torch.Tensor) -> torch.Tensor:
    """G = A^T A in float32."""
    af = a.float()
    return af.T @ af
