"""Carry state across from the JAX package, as numpy arrays.

The two packages draw different random numbers from the same seed, so a
comparison hands both the same tensor, workspace and initial factors by
value.  These helpers take numpy arrays (``np.asarray`` of the JAX
package's arrays) and build the port's containers on ``device`` (the card
when None); nothing here imports the JAX package.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.core.coo import DeviceLike, SparseTensor, resolve_device
from repro_torch.core.cpals import CPALSState, CPDecomp
from repro_torch.core.csf import CSF


def sparse_tensor_from_numpy(inds, vals, dims: Sequence[int], nnz: int,
                             device: DeviceLike = None) -> SparseTensor:
    return SparseTensor(np.array(inds), np.array(vals), dims, nnz,
                        device=device)


def csf_from_numpy(mode: int, row_ids, other_ids, vals, block_tile,
                   dims: Sequence[int], nnz: int, block: int, row_tile: int,
                   device: DeviceLike = None) -> CSF:
    dev = resolve_device(device)

    def ids(a):
        return torch.as_tensor(np.array(a), device=dev).to(torch.int32)

    return CSF(mode=int(mode), row_ids=ids(row_ids),
               other_ids=ids(other_ids),
               vals=torch.as_tensor(np.array(vals), device=dev),
               block_tile=ids(block_tile),
               dims=tuple(int(d) for d in dims), nnz=int(nnz),
               block=int(block), row_tile=int(row_tile))


def cpals_state_from_numpy(factors, lmbda, fit, fit_prev, iteration: int,
                           device: DeviceLike = None) -> CPALSState:
    """A CP-ALS state; ``iteration=0`` hands in initial factors."""
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.array(a), device=dev)

    return CPALSState(tuple(t(a) for a in factors), t(lmbda), t(fit),
                      t(fit_prev), torch.tensor(int(iteration),
                                                dtype=torch.int32))


def decomp_to_numpy(decomp: CPDecomp):
    """``(factors, lmbda, fit)`` as numpy arrays and a python float."""
    return ([a.detach().cpu().numpy() for a in decomp.factors],
            decomp.lmbda.detach().cpu().numpy(), float(decomp.fit))
