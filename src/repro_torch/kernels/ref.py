"""Plain PyTorch versions of the hand-written kernels.

They are what ``kernels.ops`` runs on a CPU tensor, what the CPU tests hold
against the JAX package, and what ``chip_smoke.py`` holds each kernel to on
the card.  Both accumulate in float32, as the kernels do.
"""
from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.core.csf import CSF


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


def syrk_ref(a: torch.Tensor) -> torch.Tensor:
    """G = A^T A in float32."""
    af = a.float()
    return af.T @ af
