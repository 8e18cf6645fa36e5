"""MTTKRP (matricized tensor times Khatri-Rao product): the impl registry.

Counterpart of ``repro.core.mttkrp``.  Each impl is an :class:`ImplSpec`
that declares its input layout, capabilities and a relative cost model, so
the planner (``repro_torch.plan``) can pick one per mode:

==================  =========================================================
impl                what it reproduces
==================  =========================================================
``rowloop``         the paper's Chapel-initial code: one non-zero at a time
                    (benchmarks only, deliberately slow).
``gather_scatter``  flat gather + ``index_add_`` scatter: the mutex/atomic
                    regime of the paper's section V-D.2.
``segment``         sorted segment reduction over the CSF workspace: SPLATT's
                    no-lock schedule.
``cuda``            the hand-written Hopper kernel (kernels/csrc/mttkrp.cu),
                    in the registry slot the TPU ``pallas`` impl holds; its
                    plain version on a CPU tensor.
``linearized``      the ALTO-style mode-agnostic workspace
                    (core/linearized.py): one bit-packed sorted index serves
                    every mode.  The sort mode runs the no-lock segment
                    reduction; other modes decode and ``index_add_``.
``linearized_cuda`` the linearized workspace on the hand-written kernel
                    (kernels/csrc/linearized.cu, decode inside the kernel),
                    in the ``linearized_pallas`` slot: on a CUDA tensor
                    every mode, the others over the entries re-sorted by
                    their row once per workspace; on a CPU tensor the
                    sort mode's plain version, the others as above.
``dense``           dense einsum oracle (tests only).
==================  =========================================================

The CSF impls take the per-mode :class:`~repro_torch.core.csf.CSF` (layout
``"csf"``), ``gather_scatter``/``rowloop``/``dense`` also run off COO, and
the ``linearized*`` impls take the one :class:`~repro_torch.core.linearized.
Linearized` workspace that every mode shares (layout ``"lin"``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from .coo import SparseTensor
from .csf import CSF
from .linearized import Linearized

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# oracles / references
# ---------------------------------------------------------------------------


def mttkrp_dense(t: SparseTensor, factors: Sequence[Tensor],
                 mode: int) -> Tensor:
    """Dense oracle: densify X and contract.  Tests only (small tensors)."""
    if isinstance(t, CSF):
        raise TypeError("dense oracle consumes COO (SparseTensor), not CSF")
    letters = "abcdefgh"[:t.order]
    terms = [f"{letters[m]}r" for m in range(t.order) if m != mode]
    eq = f"{letters}," + ",".join(terms) + f"->{letters[mode]}r"
    others = [factors[m] for m in range(t.order) if m != mode]
    return torch.einsum(eq, t.to_dense(), *others)


def mttkrp_rowloop(t: SparseTensor, factors: Sequence[Tensor],
                   mode: int) -> Tensor:
    """One non-zero at a time: the per-row-slice overhead regime of the
    paper's section V-D.1.  O(nnz) python steps; benchmarks only."""
    if isinstance(t, CSF):
        raise TypeError("rowloop consumes COO (SparseTensor), not CSF")
    rank = factors[0].shape[1]
    out = torch.zeros((t.dims[mode], rank), dtype=factors[0].dtype,
                      device=factors[0].device)
    inds = t.inds.tolist()
    for n, idx in enumerate(inds):
        acc = t.vals[n] * torch.ones(rank, dtype=out.dtype, device=out.device)
        for m in range(t.order):
            if m != mode:
                acc = acc * factors[m][idx[m]]
        out[idx[mode]] += acc
    return out


# ---------------------------------------------------------------------------
# the two reductions and the CSF check every CSF impl shares (the TTMc
# registry, core/ttmc.py, uses the segment sum and the check too)
# ---------------------------------------------------------------------------


def _segment_sum(prod: Tensor, rows: Tensor, num_rows: int) -> Tensor:
    """Sum of ``prod``'s rows by ``rows``, which must be sorted: each output
    row's contributions are contiguous, so no conflict resolution."""
    lengths = torch.bincount(rows, minlength=num_rows)
    return torch.segment_reduce(prod, "sum", lengths=lengths, axis=0,
                                unsafe=True)


def _scatter_sum(prod: Tensor, rows: Tensor, num_rows: int) -> Tensor:
    """Sum of ``prod``'s rows by ``rows`` in any order (``index_add_``)."""
    out = torch.zeros((num_rows, prod.shape[1]), dtype=prod.dtype,
                      device=prod.device)
    return out.index_add_(0, rows, prod)


def _require_csf(csf, impl: str, mode: Optional[int]) -> CSF:
    if not isinstance(csf, CSF):
        raise TypeError(f"{impl} impl needs a CSF workspace "
                        "(build_csf(t, mode))")
    if mode is not None and csf.mode != mode:
        raise ValueError(f"CSF is built for mode {csf.mode}, asked {mode}")
    return csf


# ---------------------------------------------------------------------------
# gather_scatter: vectorized, scatter-add collisions (COO or CSF input)
# ---------------------------------------------------------------------------


def _krp_rows(inds: Tensor, factors: Sequence[Tensor], mode: int,
              vals: Tensor) -> Tensor:
    """prod[n, r] = vals[n] * prod_{m != mode} A_m[inds[n, m], r]."""
    prod = vals[:, None].to(factors[0].dtype)
    for m in range(len(factors)):
        if m != mode:
            prod = prod * factors[m][inds[:, m]]
    return prod


def _krp_rows_csf(csf: CSF, factors: Sequence[Tensor]) -> Tensor:
    """:func:`_krp_rows` over the CSF workspace (padding gives zeros)."""
    prod = csf.vals[:, None].to(factors[0].dtype)
    for i, m in enumerate(csf.other_modes):
        prod = prod * factors[m][csf.other_ids[:, i]]
    return prod


def mttkrp_gather_scatter(t, factors: Sequence[Tensor], mode: int) -> Tensor:
    """Flat gather of factor rows, elementwise product, scatter-add: the
    atomic regime, where colliding output rows serialize.  Takes raw COO or
    the CSF workspace."""
    if isinstance(t, CSF):
        _require_csf(t, "gather_scatter", mode)
        return _scatter_sum(_krp_rows_csf(t, factors), t.row_ids,
                            t.dims[mode])
    return _scatter_sum(_krp_rows(t.inds, factors, mode, t.vals),
                        t.inds[:, mode], t.dims[mode])


# ---------------------------------------------------------------------------
# segment: sorted CSF, conflict-free segment reduction (no-lock path)
# ---------------------------------------------------------------------------


def mttkrp_segment(csf: CSF, factors: Sequence[Tensor],
                   mode: Optional[int] = None) -> Tensor:
    """Segment sum over the per-mode sorted workspace: each output row's
    contributions are contiguous (padding keeps ``row_ids`` sorted and adds
    zeros), so the reduction needs no conflict resolution."""
    csf = _require_csf(csf, "segment", mode)
    return _segment_sum(_krp_rows_csf(csf, factors), csf.row_ids,
                        csf.num_rows)


def mttkrp_cuda(csf: CSF, factors: Sequence[Tensor],
                mode: Optional[int] = None) -> Tensor:
    """The hand-written kernel over the unified workspace (its plain
    version on a CPU tensor: ``kernels.ops``)."""
    csf = _require_csf(csf, "cuda", mode)
    from repro_torch.kernels import ops as kops  # kernels import core.csf

    return kops.mttkrp(csf, factors)


# ---------------------------------------------------------------------------
# linearized: ALTO-style mode-agnostic bit-packed workspace (every mode from
# one resident buffer; see core/linearized.py for the format)
# ---------------------------------------------------------------------------


def _require_lin(ws) -> Linearized:
    if not isinstance(ws, Linearized):
        raise TypeError(
            "linearized impls need a Linearized workspace "
            "(build_linearized(t)); got " + type(ws).__name__)
    return ws


def mttkrp_linearized(ws, factors: Sequence[Tensor], mode: int) -> Tensor:
    """Any mode from the one linearized workspace, in plain PyTorch.

    Coordinates are decoded from the packed words.  On the sort mode the
    stream is ordered by the output row (padding keeps it non-decreasing),
    so a sorted segment reduction applies; the other modes scatter-add with
    ``index_add_`` (the atomic regime) at no extra memory and no re-sort."""
    lin = _require_lin(ws)
    prod = lin.vals[:, None].to(factors[0].dtype)
    for m in range(lin.order):
        if m != mode:
            prod = prod * factors[m][lin.decode(m)]
    rows = lin.decode(mode)
    if mode == lin.sort_mode:
        return _segment_sum(prod, rows, lin.dims[mode])
    return _scatter_sum(prod, rows, lin.dims[mode])


def mttkrp_linearized_cuda(ws, factors: Sequence[Tensor],
                           mode: int) -> Tensor:
    """The linearized workspace on the hand-written kernel, every mode on a
    CUDA tensor (on a CPU tensor the sort mode's plain version and the
    plain decode and scatter on the other modes): ``kernels.ops.
    mttkrp_lin``."""
    lin = _require_lin(ws)
    from repro_torch.kernels import ops as kops  # kernels import core

    return kops.mttkrp_lin(lin, factors, mode)


# ---------------------------------------------------------------------------
# cost models (relative per-iteration work; consumed by the planner)
# ---------------------------------------------------------------------------
#
# The same models and constants as the JAX package.  ``_MXU_SPEEDUP``
# prices the TPU kernel's one-hot matmul against a vector scatter; the
# ``cuda`` impl inherits it unchanged.  It has not been measured on the card.

_SCATTER_SERIALIZATION = 8.0   # relative cost of a serialized colliding add
_MXU_SPEEDUP = 4.0             # not yet measured for the CUDA kernel


def _padded_nnz(stats) -> float:
    return stats.nnz / max(1e-9, 1.0 - stats.padding_overhead)


def _cost_gather_scatter(stats, rank: int) -> float:
    gather = stats.nnz * rank * (stats.order - 1)
    scatter = stats.nnz * rank * (
        1.0 + _SCATTER_SERIALIZATION * stats.collision_rate)
    return gather + scatter


def _cost_segment(stats, rank: int) -> float:
    return _padded_nnz(stats) * rank * stats.order


def _cost_pallas(stats, rank: int) -> float:
    return _padded_nnz(stats) * rank * stats.order / _MXU_SPEEDUP


def _cost_rowloop(stats, rank: int) -> float:
    return stats.nnz * rank * stats.order * 1e3  # sequential; never chosen


# Integer shift/mask work per coordinate decode, relative to a float
# gather+multiply unit of the models above.  Strictly positive: on predicted
# costs the linearized impls price as their sorted/scatter counterparts plus
# the decode, so they win only through measured (calibrated) costs.
_DECODE_DISCOUNT = 0.25


def _cost_decode(stats, rank: int) -> float:
    return _DECODE_DISCOUNT * stats.nnz * stats.order


def _cost_linearized(stats, rank: int) -> float:
    # the sort mode runs the segment regime, other modes the scatter regime;
    # scored per mode, the cheaper of the two, plus the decode
    base = min(_cost_segment(stats, rank), _cost_gather_scatter(stats, rank))
    return base + _cost_decode(stats, rank)


def _cost_linearized_pallas(stats, rank: int) -> float:
    base = min(_cost_pallas(stats, rank), _cost_gather_scatter(stats, rank))
    return base + _cost_decode(stats, rank)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ImplSpec:
    """One MTTKRP strategy and its declared capabilities.

    layout:       "csf" (unified CSF), "coo" (raw SparseTensor), "lin"
                  (the shared linearized workspace) or "any" (CSF or COO).
    needs_sorted: whether the impl relies on the workspace's row sort.
    backend:      "any", or the device type ("cuda") the impl is native to;
                  the auto policy only picks it there.
    cost_model:   (stats, rank) -> relative per-iteration cost.
    """

    name: str
    fn: Callable[..., Tensor]
    layout: str
    needs_sorted: bool
    supports_order_gt3: bool
    backend: str = "any"
    benchmark_only: bool = False
    oracle: bool = False
    cost_model: Optional[Callable[..., float]] = None


REGISTRY: dict[str, ImplSpec] = {}


def register_impl(spec: ImplSpec) -> ImplSpec:
    """Add (or replace) an implementation in the registry."""
    if spec.layout not in ("csf", "coo", "lin", "any"):
        raise ValueError(f"bad layout {spec.layout!r} for impl {spec.name!r}")
    REGISTRY[spec.name] = spec
    return spec


def get_impl(name: str, *, registry: Optional[dict] = None) -> ImplSpec:
    """Look up an :class:`ImplSpec` by name."""
    registry = REGISTRY if registry is None else registry
    try:
        return registry[name]
    except KeyError:
        raise ValueError(
            f"unknown impl {name!r}; one of {tuple(registry)}") from None


def available_impls(*, order: int = 3, backend: Optional[str] = None,
                    include_benchmark: bool = False,
                    include_oracle: bool = False,
                    allow: Optional[Sequence[str]] = None,
                    registry: Optional[dict] = None) -> tuple[str, ...]:
    """Names of impls whose declared capabilities cover (order, backend):
    the planner's candidate filter."""
    registry = REGISTRY if registry is None else registry
    out = []
    for name, spec in registry.items():
        if allow is not None and name not in allow:
            continue
        if spec.benchmark_only and not include_benchmark:
            continue
        if spec.oracle and not include_oracle:
            continue
        if order > 3 and not spec.supports_order_gt3:
            continue
        if backend is not None and spec.backend not in ("any", backend):
            continue
        out.append(name)
    return tuple(out)


register_impl(ImplSpec(
    name="gather_scatter", fn=mttkrp_gather_scatter, layout="any",
    needs_sorted=False, supports_order_gt3=True,
    cost_model=_cost_gather_scatter))
register_impl(ImplSpec(
    name="segment", fn=mttkrp_segment, layout="csf",
    needs_sorted=True, supports_order_gt3=True,
    cost_model=_cost_segment))
register_impl(ImplSpec(
    name="cuda", fn=mttkrp_cuda, layout="csf",
    needs_sorted=True, supports_order_gt3=True, backend="cuda",
    cost_model=_cost_pallas))
register_impl(ImplSpec(
    name="linearized", fn=mttkrp_linearized, layout="lin",
    needs_sorted=True, supports_order_gt3=True,
    cost_model=_cost_linearized))
register_impl(ImplSpec(
    name="linearized_cuda", fn=mttkrp_linearized_cuda, layout="lin",
    needs_sorted=True, supports_order_gt3=True, backend="cuda",
    cost_model=_cost_linearized_pallas))
register_impl(ImplSpec(
    name="rowloop", fn=mttkrp_rowloop, layout="coo",
    needs_sorted=False, supports_order_gt3=True, benchmark_only=True,
    cost_model=_cost_rowloop))
register_impl(ImplSpec(
    name="dense", fn=mttkrp_dense, layout="coo",
    needs_sorted=False, supports_order_gt3=True, oracle=True))

# the registered names at import, the JAX package's legacy tuple
IMPLS = tuple(REGISTRY)


# ---------------------------------------------------------------------------
# dispatcher
# ---------------------------------------------------------------------------


def mttkrp(x, factors: Sequence[Tensor], mode: int, *,
           impl: str = "segment") -> Tensor:
    """Dispatch on the registry; ``x`` is a SparseTensor (COO impls), the
    per-mode CSF workspace or the shared linearized workspace.
    ``impl="auto"`` is a planner policy, resolved by
    ``repro_torch.plan.plan_decomposition`` before this point."""
    if impl == "auto":
        raise ValueError(
            "impl='auto' is a planner policy; resolve it with "
            "repro_torch.plan.plan_decomposition (or call cp_als(impl="
            "'auto')) and dispatch on the per-mode plan")
    return get_impl(impl).fn(x, factors, mode)
