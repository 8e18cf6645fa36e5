"""TTMc (chain-of-modes tensor-times-matrix) for sparse Tucker: the impl
registry.

Counterpart of ``repro.core.ttmc``.  Where MTTKRP contracts a sparse tensor
against the Khatri-Rao product of the other modes' factors, HOOI needs the
Kronecker one:

    Y_(n)[i, :] = sum_{stored entries with i_n == i} x * kron_{m != n} U_m[i_m, :]

an (I_n, prod_{m != n} R_m) matrix whose leading left singular subspace
gives the updated factor (``repro_torch.methods.tucker_hooi``).  Every
MTTKRP strategy carries over with the Hadamard row product replaced by the
Kronecker one:

==================  =========================================================
impl                what it runs
==================  =========================================================
``gather_scatter``  Kronecker rows + ``index_add_`` (COO or CSF input).
``segment``         Kronecker rows + sorted segment reduction over the CSF.
``cuda``            K1 at Kronecker width (kernels/csrc/mttkrp.cu, the rows
                    formed inside the kernel), in the ``pallas`` slot; its
                    plain version on a CPU tensor.
``linearized``      the one linearized workspace: segment reduction on the
                    sort mode, decode + ``index_add_`` on the others.
``linearized_cuda`` K3 at Kronecker width (kernels/csrc/linearized.cu), in
                    the ``linearized_pallas`` slot: every mode on a CUDA
                    tensor; on a CPU tensor the sort mode's plain version
                    and the other modes as ``linearized``.
``dense``           dense einsum oracle (tests only).
==================  =========================================================

Kronecker column order, the contract every impl keeps: ascending other
modes, row-major, so the output column at mode 0 of an order-3 tensor is
``r_1 * R_2 + r_2``.  ``tucker_hooi``'s core recovery relies on it.

The cost models are the MTTKRP ones scored at the Kronecker width
(``prod_{m != n} R_m``, the per-entry work multiplier), which the planner
passes as the mode's rank (``plan_decomposition(kernel="ttmc")``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from .coo import SparseTensor
from .csf import CSF
from .mttkrp import (ImplSpec, _cost_gather_scatter, _cost_linearized,
                     _cost_linearized_pallas, _cost_pallas, _cost_segment,
                     _require_csf, _require_lin, _segment_sum,
                     available_impls, get_impl)

Tensor = torch.Tensor


def kron_chain(rows: Sequence[Tensor]) -> Tensor:
    """Row-wise Kronecker product: [(n, R_a), (n, R_b), ...] -> (n, prod R),
    the first input the slowest axis (row-major).  The one column order of
    every TTMc impl, the kernels and their plain versions."""
    out = rows[0]
    for r in rows[1:]:
        out = (out[:, :, None] * r[:, None, :]).reshape(out.shape[0], -1)
    return out


# The plain impls (and the kernels' plain versions, kernels/ref.py) run
# over the stored entries in chunks, each chunk's Kronecker rows at most
# this many bytes, so the extra memory stays near 1 GB at any width (one
# pass over full yelp at width 256 would hold 8 GB in each temporary).
TTMC_CHUNK_BYTES = 1 << 28


def _kron_sum(vals: Tensor, rows: Tensor, ids, factors: Sequence[Tensor],
              num_rows: int, *, dtype: torch.dtype, sorted_rows: bool = False,
              chunk: Optional[int] = None) -> Tensor:
    """sum over stored entries n of vals[n] * kron_chain(F_m[ids_m[n]])
    into output row rows[n], in ``dtype``; ``ids`` pairs each other mode,
    ascending, with its index vector.  ``chunk`` entries at a time (sized
    by ``TTMC_CHUNK_BYTES`` when None).  With ``sorted_rows`` each chunk is
    a sorted segment reduction, else ``index_add_``."""
    width = 1
    for m, _ in ids:
        width *= factors[m].shape[1]
    if chunk is None:
        chunk = max(1, TTMC_CHUNK_BYTES // (4 * width))
    out = torch.zeros((num_rows, width), dtype=dtype, device=vals.device)
    for s in range(0, vals.shape[0], chunk):
        e = s + chunk
        prod = vals[s:e, None].to(dtype) * kron_chain(
            [factors[m][i[s:e]].to(dtype) for m, i in ids])
        if sorted_rows:
            out += _segment_sum(prod, rows[s:e], num_rows)
        else:
            out.index_add_(0, rows[s:e], prod)
    return out


def _kron_ids_csf(csf: CSF):
    """The CSF workspace's other modes and their id vectors (padding
    entries have value 0: zero rows)."""
    return [(m, csf.other_ids[:, i]) for i, m in enumerate(csf.other_modes)]


def ttmc_dense(t: SparseTensor, factors: Sequence[Tensor],
               mode: int) -> Tensor:
    """Dense oracle: densify X and contract every other mode.  Tests only."""
    if isinstance(t, CSF):
        raise TypeError("dense oracle consumes COO (SparseTensor), not CSF")
    letters = "abcdefgh"[:t.order]
    ranks = "pqrstuvw"
    others = [m for m in range(t.order) if m != mode]
    terms = [f"{letters[m]}{ranks[j]}" for j, m in enumerate(others)]
    eq = (f"{letters}," + ",".join(terms)
          + f"->{letters[mode]}{ranks[:len(others)]}")
    out = torch.einsum(eq, t.to_dense(), *[factors[m] for m in others])
    return out.reshape(t.dims[mode], -1)


def ttmc_gather_scatter(t, factors: Sequence[Tensor], mode: int) -> Tensor:
    """Flat gather + Kronecker rows + ``index_add_`` (COO or CSF input)."""
    dtype = factors[0].dtype
    if isinstance(t, CSF):
        _require_csf(t, "gather_scatter", mode)
        return _kron_sum(t.vals, t.row_ids, _kron_ids_csf(t), factors,
                         t.dims[mode], dtype=dtype)
    ids = [(m, t.inds[:, m]) for m in range(t.order) if m != mode]
    return _kron_sum(t.vals, t.inds[:, mode], ids, factors, t.dims[mode],
                     dtype=dtype)


def ttmc_segment(csf: CSF, factors: Sequence[Tensor],
                 mode: Optional[int] = None) -> Tensor:
    """Kronecker rows + sorted segment reduction over the CSF workspace."""
    csf = _require_csf(csf, "segment", mode)
    return _kron_sum(csf.vals, csf.row_ids, _kron_ids_csf(csf), factors,
                     csf.num_rows, dtype=factors[0].dtype, sorted_rows=True)


def ttmc_cuda(csf: CSF, factors: Sequence[Tensor],
              mode: Optional[int] = None) -> Tensor:
    """K1 at Kronecker width (its plain version on a CPU tensor:
    ``kernels.ops.ttmc``)."""
    csf = _require_csf(csf, "cuda", mode)
    from repro_torch.kernels import ops as kops  # kernels import core

    return kops.ttmc(csf, factors)


def ttmc_linearized(ws, factors: Sequence[Tensor], mode: int) -> Tensor:
    """Any mode from the one linearized workspace, in plain PyTorch: decode
    the coordinates, form the Kronecker rows, segment-sum on the sort mode
    and ``index_add_`` on the others."""
    lin = _require_lin(ws)
    ids = [(m, lin.decode(m)) for m in range(lin.order) if m != mode]
    return _kron_sum(lin.vals, lin.decode(mode), ids, factors,
                     lin.dims[mode], dtype=factors[0].dtype,
                     sorted_rows=mode == lin.sort_mode)


def ttmc_linearized_cuda(ws, factors: Sequence[Tensor], mode: int) -> Tensor:
    """K3 at Kronecker width, every mode on a CUDA tensor (on a CPU tensor
    the sort mode's plain version and :func:`ttmc_linearized` on the
    others): ``kernels.ops.ttmc_lin``."""
    lin = _require_lin(ws)
    from repro_torch.kernels import ops as kops  # kernels import core

    return kops.ttmc_lin(lin, factors, mode)


# ---------------------------------------------------------------------------
# the registry, scored by plan_decomposition(kernel="ttmc")
# ---------------------------------------------------------------------------

TTMC_REGISTRY: dict[str, ImplSpec] = {}


def register_ttmc_impl(spec: ImplSpec) -> ImplSpec:
    """Add (or replace) an implementation in the TTMc registry."""
    if spec.layout not in ("csf", "coo", "lin", "any"):
        raise ValueError(f"bad layout {spec.layout!r} for impl {spec.name!r}")
    TTMC_REGISTRY[spec.name] = spec
    return spec


def get_ttmc_impl(name: str) -> ImplSpec:
    return get_impl(name, registry=TTMC_REGISTRY)


def available_ttmc_impls(**kw) -> tuple[str, ...]:
    return available_impls(registry=TTMC_REGISTRY, **kw)


register_ttmc_impl(ImplSpec(
    name="gather_scatter", fn=ttmc_gather_scatter, layout="any",
    needs_sorted=False, supports_order_gt3=True,
    cost_model=_cost_gather_scatter))
register_ttmc_impl(ImplSpec(
    name="segment", fn=ttmc_segment, layout="csf",
    needs_sorted=True, supports_order_gt3=True,
    cost_model=_cost_segment))
register_ttmc_impl(ImplSpec(
    name="cuda", fn=ttmc_cuda, layout="csf",
    needs_sorted=True, supports_order_gt3=True, backend="cuda",
    cost_model=_cost_pallas))
register_ttmc_impl(ImplSpec(
    name="linearized", fn=ttmc_linearized, layout="lin",
    needs_sorted=True, supports_order_gt3=True,
    cost_model=_cost_linearized))
register_ttmc_impl(ImplSpec(
    name="linearized_cuda", fn=ttmc_linearized_cuda, layout="lin",
    needs_sorted=True, supports_order_gt3=True, backend="cuda",
    cost_model=_cost_linearized_pallas))
register_ttmc_impl(ImplSpec(
    name="dense", fn=ttmc_dense, layout="coo",
    needs_sorted=False, supports_order_gt3=True, oracle=True))

TTMC_IMPLS = tuple(TTMC_REGISTRY)


def ttmc(x, factors: Sequence[Tensor], mode: int, *,
         impl: str = "segment") -> Tensor:
    """Dispatch a TTMc on the registry; ``x`` is a SparseTensor (COO impls),
    the per-mode CSF workspace or the shared linearized workspace.  Returns
    (dims[mode], prod of the other modes' ranks)."""
    if impl == "auto":
        raise ValueError(
            "impl='auto' is a planner policy; resolve it with "
            "repro_torch.plan.plan_decomposition(kernel='ttmc') and "
            "dispatch on the per-mode plan")
    return get_ttmc_impl(impl).fn(x, factors, mode)
