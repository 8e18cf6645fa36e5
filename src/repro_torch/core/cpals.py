"""CP-ALS iteration machinery: Algorithm 1 of the paper.

Counterpart of ``repro.core.cpals``.  Per iteration, for each mode n:

    V      = hadamard_{m != n} (A_m^T A_m)          Mat A^TA
    M      = MTTKRP(X, factors, n)                  MTTKRP
    A_n    = M V^{-1}  (Cholesky)                   Inverse
    A_n, l = column-normalize(A_n)                  Mat norm (max-norm on
                                                    iteration 0, 2-norm after)
    G_n    = A_n^T A_n
    fit    = 1 - ||X - X_hat|| / ||X||              CPD fit (last mode)

PyTorch runs eagerly, so the JAX package's jitted iteration and its buffer
donation have no counterpart here: the "fused" epilogue is the same chain of
calls as the per-routine one, timed under one key.  With ``timers=`` the
driver times each routine with a device synchronisation around it
(``_iteration_timed``), reproducing the paper's Table III breakdown.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import torch

from .coo import (DeviceLike, GeneratorLike, SparseTensor, make_generator,
                  resolve_device)
from .csf import build_csf
from .linearized import build_linearized
from .gram import (gram, hadamard_grams, kruskal_fit, normalize,
                   solve_cholesky, solve_gram)
from .mttkrp import mttkrp

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True, eq=False)
class CPDecomp:
    """Result: X ~ sum_r lambda_r * outer(A_1[:,r], ..., A_N[:,r])."""

    factors: tuple[Tensor, ...]
    lmbda: Tensor
    fit: Tensor

    @property
    def rank(self) -> int:
        return int(self.factors[0].shape[1])

    def values_at(self, inds: Tensor) -> Tensor:
        """Reconstructed entries at a coordinate list (n, order)."""
        prod = self.lmbda[None, :].expand(inds.shape[0], -1)
        for m, a in enumerate(self.factors):
            prod = prod * a[inds[:, m]]
        return torch.sum(prod, dim=1)

    def to_dense(self) -> Tensor:
        """Densify (tests only)."""
        letters = "abcdefgh"[:len(self.factors)]
        eq = ",".join(f"{c}r" for c in letters) + ",r->" + letters
        return torch.einsum(eq, *self.factors, self.lmbda)


@dataclasses.dataclass(frozen=True, eq=False)
class CPALSState:
    """Checkpointable mid-run state of the ALS loop."""

    factors: tuple[Tensor, ...]
    lmbda: Tensor
    fit: Tensor
    fit_prev: Tensor
    iteration: Tensor  # int32 scalar


# ---------------------------------------------------------------------------
# workspace: per-mode prebuilt layouts (the paper's "Sort" stage)
# ---------------------------------------------------------------------------


def resolve_plan(t: SparseTensor, impl: str, plan, *, rank: int = 16,
                 block: int = 512, row_tile: int = 128):
    """``plan`` wins when given; otherwise the planner runs with ``impl`` as
    the policy (a concrete name skips the stats pass)."""
    if plan is not None:
        return plan
    from repro_torch.plan import plan_decomposition

    return plan_decomposition(t, impl, rank=rank, block=block,
                              row_tile=row_tile, with_stats=impl == "auto")


def build_workspace(t: SparseTensor, plan, *, block: int = 512,
                    row_tile: int = 128) -> list:
    """One prebuilt structure per mode (SPLATT's ALLMODE policy): the CSF
    workspace for a "csf" mode, the COO tensor itself for a "coo" mode.
    All "lin" modes share ONE linearized workspace: the format's point is a
    single resident buffer and a single sort for every mode.  ``plan`` is a
    DecompPlan or an impl name."""
    if isinstance(plan, str):
        from repro_torch.plan import plan_decomposition

        plan = plan_decomposition(t, plan, block=block, row_tile=row_tile,
                                  with_stats=plan == "auto")
    lin = None
    ws = []
    for p in plan.modes:
        if p.layout == "csf":
            ws.append(build_csf(t, p.mode, block=p.block,
                                row_tile=p.row_tile))
        elif p.layout == "lin":
            if lin is None:
                lin = build_linearized(t, block=p.block, row_tile=p.row_tile)
            ws.append(lin)
        elif p.layout == "coo":
            ws.append(t)
        else:
            raise ValueError(f"unknown workspace layout {p.layout!r}")
    return ws


# ---------------------------------------------------------------------------
# single-mode update + iteration
# ---------------------------------------------------------------------------


def init_factors(dims: Sequence[int], rank: int, gen: GeneratorLike, *,
                 dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None) -> tuple[Tensor, ...]:
    """Uniform [0, 1) factors, one (dim, rank) matrix per mode, drawn on
    ``device`` (the card when None) from ``gen``."""
    dev = resolve_device(device)
    g = make_generator(gen, dev)
    return tuple(torch.rand((int(d), rank), generator=g, device=dev,
                            dtype=dtype) for d in dims)


def _nan(like: Tensor) -> Tensor:
    return torch.tensor(float("nan"), dtype=like.dtype, device=like.device)


def _mode_epilogue(m_mat, factors, grams, norm_x_sq, *, mode: int,
                   norm_kind: str, with_fit: bool):
    """Everything after one mode's MTTKRP: the gram hadamard, the Cholesky
    solve, the column normalization, the gram refresh and, on the last mode
    (``with_fit``), the work-free fit.  Returns the full updated
    ``(factors, grams, lam, fit)``; fit is NaN when it was not computed."""
    v = hadamard_grams(grams, mode)
    a_new, lam = normalize(solve_gram(m_mat, v), kind=norm_kind)
    g_new = gram(a_new)
    factors = tuple(a_new if m == mode else f for m, f in enumerate(factors))
    grams = tuple(g_new if m == mode else g for m, g in enumerate(grams))
    if with_fit:
        fit = kruskal_fit(norm_x_sq, lam, grams, m_mat, factors[-1])
    else:
        fit = _nan(factors[0])
    return factors, grams, lam, fit


# Eager PyTorch has nothing to fuse: the JAX package's jitted epilogue is
# the same chain of calls here.
fused_mode_epilogue = _mode_epilogue


def _iteration(ws, factors, grams, norm_x_sq, *, impls, norm_kind,
               with_fit=True):
    """One ALS iteration; ``impls`` is the plan's per-mode impl tuple."""
    factors = tuple(factors)
    grams = tuple(grams)
    lam = None
    fit = _nan(factors[0])
    order = len(factors)
    for n in range(order):
        m_mat = mttkrp(ws[n], factors, n, impl=impls[n])
        factors, grams, lam, fit = _mode_epilogue(
            m_mat, factors, grams, norm_x_sq, mode=n, norm_kind=norm_kind,
            with_fit=with_fit and n == order - 1)
    return factors, grams, lam, fit


# ---------------------------------------------------------------------------
# timed per-routine path (paper Table III)
# ---------------------------------------------------------------------------

ROUTINES = ("sort", "mttkrp", "ata", "inverse", "norm", "fit")
# the fused path times ata/inverse/norm/fit together under one key
ROUTINES_FUSED = ("sort", "mttkrp", "epilogue")
# the routines that make up the per-mode post-MTTKRP chain
EPILOGUE_ROUTINES = ("ata", "inverse", "norm", "fit")


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _timed(timers, key, fn, *args, **kwargs):
    """Run ``fn`` and add its wall time to ``timers[key]``; the card is
    synchronised before and after, so the time is the routine's own."""
    _sync()
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    _sync()
    timers[key] = timers.get(key, 0.0) + (time.perf_counter() - t0)
    return out


def _iteration_timed(ws, factors, grams, norm_x_sq, timers, *, impls,
                     norm_kind, with_fit=True, fused=False):
    """Per-routine timed iteration (paper Table III).

    ``fused=False`` times each routine on its own (solving with
    :func:`solve_cholesky`, the routine-by-routine "Inverse");
    ``fused=True`` times the MTTKRP per mode and the whole post-MTTKRP chain
    under the ``"epilogue"`` key."""
    order = len(factors)
    if fused:
        factors = tuple(factors)
        grams = tuple(grams)
        lam = None
        fit = _nan(factors[0])
        for n in range(order):
            m_mat = _timed(timers, "mttkrp", mttkrp, ws[n], factors, n,
                           impl=impls[n])
            factors, grams, lam, fit = _timed(
                timers, "epilogue", fused_mode_epilogue, m_mat, factors,
                grams, norm_x_sq, mode=n, norm_kind=norm_kind,
                with_fit=with_fit and n == order - 1)
        return factors, grams, lam, fit
    factors = list(factors)
    grams = list(grams)
    lam = m_last = None
    for n in range(order):
        v = _timed(timers, "ata", hadamard_grams, tuple(grams), n)
        m_mat = _timed(timers, "mttkrp", mttkrp, ws[n], tuple(factors), n,
                       impl=impls[n])
        a_new = _timed(timers, "inverse", solve_cholesky, m_mat, v)
        a_new, lam = _timed(timers, "norm", normalize, a_new, kind=norm_kind)
        grams[n] = _timed(timers, "ata", gram, a_new)
        factors[n] = a_new
        m_last = m_mat
    if with_fit:
        fit = _timed(timers, "fit", kruskal_fit, norm_x_sq, lam,
                     tuple(grams), m_last, factors[-1])
    else:
        fit = _nan(factors[0])
    return tuple(factors), tuple(grams), lam, fit
