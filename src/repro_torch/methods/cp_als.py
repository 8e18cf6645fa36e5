"""CP-ALS (the paper's Algorithm 1) behind the method registry.

Counterpart of ``repro.methods.cp_als``: the driver loop (plan -> sort ->
iterate -> checkpoint / early stop) over the iteration machinery of
``repro_torch.core.cpals``.  It runs on the device of the tensor it is
given.
"""
from __future__ import annotations

import contextlib
from typing import Callable

import torch

from repro_torch.core.coo import GeneratorLike, SparseTensor
from repro_torch.core.cpals import (CPALSState, CPDecomp, _iteration,
                                    _iteration_timed, _timed,
                                    build_workspace, init_factors,
                                    resolve_plan)
from repro_torch.core.gram import gram

from .iteration import IterationRecorder
from .registry import DecompState, MethodSpec, register_method

__all__ = ["cp_als", "cpals_state_to_decomp", "resolve_ingested"]


@contextlib.contextmanager
def _full_f32_matmul():
    """Keep TF32 out of the fit's matmuls on the card, since the reference's
    float32 products are full float32; restore the caller's setting after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _as_cpals_state(state) -> CPALSState | None:
    """Accept either a CPALSState or the shared DecompState."""
    if state is None or isinstance(state, CPALSState):
        return state
    if isinstance(state, DecompState):
        return CPALSState(tuple(state.factors), state.aux["lmbda"],
                          state.fit, state.fit_prev, state.iteration)
    raise TypeError(
        f"state must be a CPALSState or repro_torch.methods.DecompState, "
        f"got {type(state).__name__}")


def cpals_state_to_decomp(state: CPALSState) -> DecompState:
    """CPALSState -> the shared protocol (lmbda rides in ``aux``)."""
    return DecompState(tuple(state.factors), {"lmbda": state.lmbda},
                       state.fit, state.fit_prev, state.iteration)


def resolve_ingested(t, name: str, *, block, row_tile):
    """Driver preamble: ``(None, tensor, block, row_tile)`` with the tile
    defaults filled in.  Ingested handles are not ported yet."""
    if not isinstance(t, SparseTensor):
        raise NotImplementedError(
            f"{name} takes a repro_torch SparseTensor; ingested handles "
            f"are not ported yet (got {type(t).__name__})")
    return None, t, (block if block is not None else 512), (
        row_tile if row_tile is not None else 128)


def cp_als(
    t,
    rank: int,
    *,
    niters: int = 20,
    tol: float = 0.0,
    impl: str = "segment",
    plan=None,
    generator: GeneratorLike | None = None,
    block: int | None = None,
    row_tile: int | None = None,
    timers: dict | None = None,
    verbose: bool = False,
    first_norm: str = "max",
    with_fit: bool = True,
    fused_epilogue: bool = False,
    state: CPALSState | DecompState | None = None,
    checkpoint_cb: Callable[[CPALSState], None] | None = None,
    monitor=None,
) -> CPDecomp:
    """Run CP-ALS per Algorithm 1 on ``t``'s device.

    tol == 0 reproduces the paper's fixed-iteration runs; tol > 0 stops
    when |fit - fit_prev| < tol.  ``impl`` is a planner policy ("auto" picks
    per mode; a registered name pins every mode; ``"cuda"`` is the
    hand-written kernel); ``plan`` skips planning.  ``generator`` (a
    ``torch.Generator`` on ``t``'s device, or an int seed; seed 0 when None)
    draws the initial factors unless ``state`` resumes a run: a state with
    ``iteration=0`` hands in the initial factors.  ``timers=`` takes the
    per-routine timed path (Table III), with the post-MTTKRP chain under one
    ``"epilogue"`` key when ``fused_epilogue``.  ``with_fit=False`` skips
    the fit; the returned fit is then the last computed one (a restored
    state's, else NaN).  ``monitor`` receives each iteration's wall time.
    The Gram matrices are ``A.T @ A``, as in the reference driver, with
    TF32 off for the fit and the caller's setting restored after it.
    """
    if not with_fit and tol > 0.0:
        raise ValueError("tol > 0 needs the fit; drop with_fit=False")
    state = _as_cpals_state(state)
    _, t, block, row_tile = resolve_ingested(t, "cp_als", block=block,
                                             row_tile=row_tile)

    def _plan_and_build():
        p = resolve_plan(t, impl, plan, rank=rank, block=block,
                         row_tile=row_tile)
        return p, build_workspace(t, p)

    if timers is not None:
        plan, ws = _timed(timers, "sort", _plan_and_build)
    else:
        plan, ws = _plan_and_build()
    impls = plan.impls

    dtype, dev = t.vals.dtype, t.device
    norm_x_sq = torch.sum(t.vals.float() ** 2)
    if state is None:
        factors = init_factors(t.dims, rank,
                               0 if generator is None else generator,
                               dtype=dtype, device=dev)
        lmbda = torch.ones((rank,), dtype=dtype, device=dev)
        fit = torch.tensor(0.0 if with_fit else float("nan"), dtype=dtype,
                           device=dev)
        fit_prev = torch.tensor(0.0, dtype=dtype, device=dev)
        start_iter = 0
    else:
        factors = tuple(state.factors)
        lmbda, fit = state.lmbda, state.fit
        # the tol check compares against the last COMPUTED fit
        fit_prev = state.fit
        start_iter = int(state.iteration)

    with _full_f32_matmul():
        grams = tuple(gram(a) for a in factors)

        recorder = IterationRecorder("cp_als", monitor=monitor,
                                     verbose=verbose)
        for it in range(start_iter, niters):
            norm_kind = first_norm if it == 0 else "2"
            with recorder.iteration(it):
                if timers is not None:
                    factors, grams, lmbda, fit_new = _iteration_timed(
                        ws, factors, grams, norm_x_sq, timers, impls=impls,
                        norm_kind=norm_kind, with_fit=with_fit,
                        fused=fused_epilogue)
                else:
                    factors, grams, lmbda, fit_new = _iteration(
                        ws, factors, grams, norm_x_sq, impls=impls,
                        norm_kind=norm_kind, with_fit=with_fit)
                if with_fit:
                    fit = fit_new
            delta = recorder.progress(it, fit, fit_prev)
            if checkpoint_cb is not None:
                checkpoint_cb(CPALSState(
                    tuple(factors), lmbda, fit, fit_prev,
                    torch.tensor(it + 1, dtype=torch.int32)))
            if tol > 0.0 and it > 0 and abs(delta) < tol:
                fit_prev = fit
                break
            fit_prev = fit

    return CPDecomp(factors=tuple(factors), lmbda=lmbda, fit=fit)


register_method(MethodSpec(
    name="cp_als",
    fn=cp_als,
    family="cp",
    kernel="mttkrp",
    supports_dist=False,
    supports_streaming=False,
    nonnegative=False,
    supports_order_gt3=True,
    monotone_fit=True,
    state_aux=("lmbda",),
    description="SPLATT-style CP-ALS (paper Algorithm 1): Cholesky solve "
                "per mode over the planned MTTKRP registry",
))
