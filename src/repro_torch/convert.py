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
from repro_torch.core.linearized import Linearized
from repro_torch.ingest.relabel import Relabeling
from repro_torch.methods.registry import DecompState, make_state
from repro_torch.methods.tucker_hooi import TuckerDecomp


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


def linearized_from_numpy(hi, lo, vals, block_tile, dims: Sequence[int],
                          nnz: int, block: int, row_tile: int,
                          sort_mode: int, device: DeviceLike = None
                          ) -> Linearized:
    """A linearized workspace from the packed words as numpy uint32 (or
    int32) arrays; the port keeps the same bits as int32."""
    dev = resolve_device(device)

    def words(a):
        a = np.ascontiguousarray(np.array(a))
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.as_tensor(a, device=dev).to(torch.int32)

    return Linearized(hi=words(hi), lo=words(lo),
                      vals=torch.as_tensor(np.array(vals), device=dev),
                      block_tile=words(block_tile),
                      dims=tuple(int(d) for d in dims), nnz=int(nnz),
                      block=int(block), row_tile=int(row_tile),
                      sort_mode=int(sort_mode))


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


def tucker_state_from_numpy(factors, fit, iteration: int,
                            device: DeviceLike = None) -> DecompState:
    """A Tucker HOOI state (``aux`` is empty); ``iteration=0`` hands in
    initial factors, as the reference's ``tucker_hooi(state=...)`` takes
    them."""
    dev = resolve_device(device)
    fit_t = torch.as_tensor(np.array(fit), device=dev)
    return make_state(
        [torch.as_tensor(np.array(a), device=dev) for a in factors], {},
        fit_t, fit_t, int(iteration))


def tucker_decomp_to_numpy(decomp: TuckerDecomp):
    """``(core, factors, fit)`` as numpy arrays and a python float."""
    return (decomp.core.detach().cpu().numpy(),
            [a.detach().cpu().numpy() for a in decomp.factors],
            float(decomp.fit))


def relabeling_from_numpy(new_of_old, old_of_new, dims_old: Sequence[int],
                          dims_new: Sequence[int], entry_perm=None,
                          linearized_mode=None,
                          device: DeviceLike = None) -> Relabeling:
    """A relabeling from its per-mode maps (and entry permutation) as numpy
    arrays, each held as int32 on ``device``."""
    dev = resolve_device(device)

    def ids(a):
        return torch.as_tensor(np.array(a, dtype=np.int32), device=dev)

    return Relabeling(
        new_of_old=tuple(ids(a) for a in new_of_old),
        old_of_new=tuple(ids(a) for a in old_of_new),
        dims_old=tuple(int(d) for d in dims_old),
        dims_new=tuple(int(d) for d in dims_new),
        entry_perm=None if entry_perm is None else ids(entry_perm),
        linearized_mode=(None if linearized_mode is None
                         else int(linearized_mode)))
