"""Nonnegative CP via hierarchical ALS (HALS) on the MTTKRP registry.

Counterpart of ``repro.methods.cp_nn_hals``.  HALS replaces CP-ALS's joint
Cholesky solve per mode with R sequential column updates, each a
closed-form nonnegative projection:

    a_r  <-  [ (M[:, r] - sum_{s != r} a_s V[s, r]) / V[r, r] ]_+

where M is the same per-mode MTTKRP the planner schedules for CP-ALS and V
the same Hadamard product of Grams, so the sparse kernel work per
iteration is CP-ALS's: ``impl="cuda"`` launches K1 on every mode and
``impl="linearized_cuda"`` K3 on the sort mode and the off-sort kernel on
the others.  Only the small dense (I_n x R) update changes, and it runs
eagerly, column by column.

Factors stay elementwise >= 0 (uniform-positive init, every update clamps
at 0), and the returned :class:`~repro_torch.core.cpals.CPDecomp` is
2-normalized column-wise at the end, so ``lmbda`` is nonnegative too.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch

from repro_torch.core.coo import GeneratorLike
from repro_torch.core.cpals import CPDecomp, _timed, init_factors
from repro_torch.core.gram import gram, hadamard_grams, kruskal_fit, normalize
from repro_torch.core.mttkrp import mttkrp
from repro_torch.obs import trace as obs_trace

from .cp_als import _full_f32_matmul, plan_and_build, resolve_ingested
from .iteration import IterationRecorder
from .registry import DecompState, MethodSpec, make_state, register_method

__all__ = ["cp_nn_hals"]

Tensor = torch.Tensor

# Floor on the column's curvature V[r, r] before dividing: a collapsed
# (all-zero) column has V[r, r] == 0 and must stay zero, not inf/NaN.
_HALS_EPS = 1e-12


def _hals_mode_epilogue(m_mat, factors, grams, norm_x_sq, *, mode: int,
                        with_fit: bool):
    """One mode's post-MTTKRP HALS update: the rank-one column loop in place
    of the Cholesky solve, the Gram refresh, and on the last mode the fit
    with unit lambda (the HALS factors carry their own scale).  Returns the
    full updated ``(factors, grams, fit)``; fit is NaN when not computed.
    The caller's factor is not written: the loop updates a copy."""
    v = hadamard_grams(grams, mode)
    a = factors[mode].clone()
    rank = a.shape[1]
    for r in range(rank):
        # M[:, r] - A V[:, r] + a_r V[r, r]  ==  M[:, r] - sum_{s != r} ...
        resid = m_mat[:, r] - a @ v[:, r] + a[:, r] * v[r, r]
        a[:, r] = torch.clamp(resid / torch.clamp(v[r, r], min=_HALS_EPS),
                              min=0.0)
    factors = tuple(a if m == mode else f for m, f in enumerate(factors))
    grams = tuple(gram(a) if m == mode else g for m, g in enumerate(grams))
    if with_fit:
        ones = torch.ones((rank,), dtype=a.dtype, device=a.device)
        fit = kruskal_fit(norm_x_sq, ones, grams, m_mat, factors[-1])
    else:
        fit = torch.tensor(float("nan"), dtype=a.dtype, device=a.device)
    return factors, grams, fit


def _hals_iteration(ws, factors, grams, norm_x_sq, *, impls, timers=None):
    """One HALS sweep (every mode, every column), each mode's MTTKRP and
    epilogue inside spans of those names.  With ``timers`` they are timed
    apart (``"mttkrp"``, ``"epilogue"``), the card synchronised around
    each."""
    factors, grams = tuple(factors), tuple(grams)
    order = len(factors)
    fit = None
    for n in range(order):
        epilogue = functools.partial(_hals_mode_epilogue, mode=n,
                                     with_fit=n == order - 1)
        with obs_trace.span("mttkrp", mode=n, impl=impls[n]):
            if timers is None:
                m_mat = mttkrp(ws[n], factors, n, impl=impls[n])
            else:
                m_mat = _timed(timers, "mttkrp", mttkrp, ws[n], factors, n,
                               impl=impls[n])
        with obs_trace.span("epilogue", mode=n):
            if timers is None:
                factors, grams, fit = epilogue(m_mat, factors, grams,
                                               norm_x_sq)
            else:
                factors, grams, fit = _timed(timers, "epilogue", epilogue,
                                             m_mat, factors, grams, norm_x_sq)
    return factors, grams, fit


def cp_nn_hals(
    t,
    rank: int,
    *,
    niters: int = 50,
    tol: float = 0.0,
    impl: str = "segment",
    plan=None,
    generator: GeneratorLike | None = None,
    block: int | None = None,
    row_tile: int | None = None,
    timers: dict | None = None,
    verbose: bool = False,
    state: DecompState | None = None,
    checkpoint_cb: Callable[[DecompState], None] | None = None,
    monitor=None,
) -> CPDecomp:
    """Nonnegative CP decomposition via HALS on ``t``'s device.

    The planner interface of :func:`~repro_torch.methods.cp_als.cp_als`
    (``impl`` policy, a prebuilt ``plan``, ``Ingested`` handles whose
    factors come back in the original labels); ``generator`` (an int seed
    or a ``torch.Generator`` on ``t``'s device; seed 0 when None) draws the
    uniform-positive initial factors unless ``state`` hands them in
    (``iteration=0``) or resumes a run.  ``timers=`` adds seconds under
    ``"sort"``, ``"mttkrp"`` and ``"epilogue"``, as does an active tracer
    with ``routines="split"``; any other tracer leaves the plain path's
    spans unsynchronised.  Returns elementwise
    nonnegative factors with unit 2-norm columns and a nonnegative
    ``lmbda``.
    """
    ing, t, block, row_tile = resolve_ingested(t, "cp_nn_hals", block=block,
                                               row_tile=row_tile)
    build = functools.partial(plan_and_build, ing, t, impl, plan,
                              rank=rank, block=block, row_tile=row_tile)
    # HALS's epilogue is one call, so a split tracer gets the timed path's
    # mttkrp / epilogue split
    if timers is None and obs_trace.split_routines():
        timers = {}
    with obs_trace.span("sort"):
        plan, ws = build() if timers is None else _timed(timers, "sort",
                                                         build)
    impls = plan.impls

    dtype, dev = t.vals.dtype, t.device
    norm_x_sq = torch.sum(t.vals.float() ** 2)
    if state is None:
        factors = init_factors(t.dims, rank,
                               0 if generator is None else generator,
                               dtype=dtype, device=dev)
        fit = torch.tensor(0.0, dtype=dtype, device=dev)
        fit_prev = fit
        start_iter = 0
    else:
        factors = tuple(state.factors)
        # compare the next fit against the last COMPUTED one (see cp_als)
        fit, fit_prev = state.fit, state.fit
        start_iter = int(state.iteration)

    with _full_f32_matmul():
        grams = tuple(gram(a) for a in factors)
        recorder = IterationRecorder("cp_nn_hals", monitor=monitor,
                                     verbose=verbose)
        for it in range(start_iter, niters):
            with recorder.iteration(it):
                factors, grams, fit = _hals_iteration(
                    ws, factors, grams, norm_x_sq, impls=impls,
                    timers=timers)
            delta = recorder.progress(it, fit, fit_prev)
            if checkpoint_cb is not None:
                checkpoint_cb(make_state(factors, {}, fit, fit_prev, it + 1))
            if tol > 0.0 and it > 0 and abs(delta) < tol:
                fit_prev = fit
                break
            fit_prev = fit

        # Kruskal form: unit 2-norm nonnegative columns, the scale in lmbda
        # (collapsed columns keep lmbda == 0)
        normed, lams = zip(*(normalize(a, kind="2") for a in factors))
    lmbda = torch.ones((rank,), dtype=dtype, device=dev)
    for lam in lams:
        lmbda = lmbda * lam
    decomp = CPDecomp(factors=tuple(normed), lmbda=lmbda, fit=fit)
    return decomp if ing is None else ing.restore(decomp)


register_method(MethodSpec(
    name="cp_nn_hals",
    fn=cp_nn_hals,
    family="cp",
    kernel="mttkrp",
    supports_dist=False,
    supports_streaming=False,
    nonnegative=True,
    supports_order_gt3=True,
    monotone_fit=True,
    description="nonnegative CP via hierarchical ALS: rank-one column "
                "updates with nonnegative projection over the planned "
                "MTTKRP registry",
))
