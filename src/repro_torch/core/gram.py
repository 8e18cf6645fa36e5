"""Dense rank-R linear algebra for CP-ALS (the paper's non-MTTKRP routines).

Counterpart of ``repro.core.gram``:

  * ``gram``            A^T A             ("Mat A^TA"; ``impl="cuda"`` runs
                                           the hand-written SYRK kernel)
  * ``hadamard_grams``  V = hadamard of the other modes' Grams
  * ``solve_cholesky``  A = M V^-1        ("Inverse", potrf/potrs)
  * ``solve_gram``      the same solve, inverse-then-GEMM
  * ``normalize``       column norms -> lambda ("Mat norm")
  * ``kruskal_fit``     decomposition fit  ("CPD fit")

The reference factors the upper Cholesky factor U (``cho_factor(lower=
False)``, V = U^T U); ``torch.linalg.cholesky`` returns the lower factor
L = U^T.  Both give the same solve of V X^T = M^T.
"""
from __future__ import annotations

from typing import Sequence

import torch

# Ridge added to V's diagonal before Cholesky, as in the JAX package.
CHOLESKY_RIDGE = 1e-12


def gram(a: torch.Tensor, *, impl: str = "torch") -> torch.Tensor:
    """G = A^T A.  ``impl="cuda"`` sends it through the SYRK kernel (the
    plain product on a CPU tensor)."""
    if impl == "cuda":
        from repro_torch.kernels import ops as kops

        return kops.syrk(a)
    if impl != "torch":
        raise ValueError(f"unknown gram impl {impl!r}; one of ('torch', "
                         "'cuda')")
    return a.T @ a


def hadamard_grams(grams: Sequence[torch.Tensor],
                   skip_mode: int) -> torch.Tensor:
    """V = hadamard_{m != skip_mode} G_m  (lines 4/7/10 of Alg. 1)."""
    out = None
    for m, g in enumerate(grams):
        if m == skip_mode:
            continue
        out = g if out is None else out * g
    if out is None:
        raise ValueError("hadamard_grams needs at least two modes")
    return out


def _cholesky(v: torch.Tensor) -> torch.Tensor:
    eye = torch.eye(v.shape[0], dtype=v.dtype, device=v.device)
    return torch.linalg.cholesky(v + CHOLESKY_RIDGE * eye)


def solve_cholesky(m_mat: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """A = M V^{-1} via Cholesky: solve V X^T = M^T with two triangular
    solves (potrf + potrs), not an explicit inverse."""
    return torch.cholesky_solve(m_mat.T, _cholesky(v)).T


def solve_gram(m_mat: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """A = M V^{-1} for tall M: invert the R x R matrix through its
    Cholesky factor, then apply it as one GEMM.  Same result as
    :func:`solve_cholesky`."""
    eye = torch.eye(v.shape[0], dtype=v.dtype, device=v.device)
    return m_mat @ torch.cholesky_solve(eye, _cholesky(v))


def column_norms(a: torch.Tensor, *, kind: str) -> torch.Tensor:
    """kind='max' (SPLATT's first-iteration norm) or '2' (subsequent)."""
    if kind == "max":
        return torch.clamp(torch.amax(torch.abs(a), dim=0), min=1.0)
    if kind == "2":
        return torch.sqrt(torch.sum(a * a, dim=0))
    raise ValueError(f"unknown norm kind {kind!r}")


def normalize(a: torch.Tensor, *,
              kind: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Column-normalize; returns (A_normalized, lambda).  Zero-safe."""
    lam = column_norms(a, kind=kind)
    safe = torch.where(lam == 0.0, torch.ones_like(lam), lam)
    return a / safe[None, :], lam


def kruskal_norm_sq(lmbda: torch.Tensor,
                    grams: Sequence[torch.Tensor]) -> torch.Tensor:
    """||X_hat||^2 = sum( (lambda lambda^T) . hadamard_m G_m )."""
    had = None
    for g in grams:
        had = g if had is None else had * g
    return torch.sum((lmbda[:, None] * lmbda[None, :]) * had)


def kruskal_inner(m_last: torch.Tensor, a_last: torch.Tensor,
                  lmbda: torch.Tensor) -> torch.Tensor:
    """<X, X_hat> = sum_r lambda_r sum_i M_last[i,r] A_last[i,r] (SPLATT's
    p_tt_inner: no extra pass over X)."""
    return torch.sum(torch.sum(m_last * a_last, dim=0) * lmbda)


def kruskal_fit(norm_x_sq: torch.Tensor, lmbda: torch.Tensor,
                grams: Sequence[torch.Tensor], m_last: torch.Tensor,
                a_last: torch.Tensor) -> torch.Tensor:
    """fit = 1 - sqrt(max(||X||^2 + ||X_hat||^2 - 2<X,X_hat>, 0)) / ||X||."""
    norm_z_sq = kruskal_norm_sq(lmbda, grams)
    inner = kruskal_inner(m_last, a_last, lmbda)
    resid_sq = torch.clamp(norm_x_sq + norm_z_sq - 2.0 * inner, min=0.0)
    return 1.0 - torch.sqrt(resid_sq) / torch.sqrt(norm_x_sq)
