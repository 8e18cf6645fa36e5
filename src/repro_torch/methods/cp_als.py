"""CP-ALS (the paper's Algorithm 1) behind the method registry.

Counterpart of ``repro.methods.cp_als``: the driver loop (plan -> sort ->
iterate -> checkpoint / early stop) over the iteration machinery of
``repro_torch.core.cpals``.  It runs on the device of the tensor it is
given.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Callable

import torch

from repro_torch.core.coo import GeneratorLike, SparseTensor
from repro_torch.core.cpals import (CPALSState, CPDecomp, _iteration,
                                    _iteration_timed, _timed,
                                    build_workspace, init_factors,
                                    resolve_plan)
from repro_torch.core.gram import gram
from repro_torch.ingest.api import Ingested
from repro_torch.kernels.linearized_cuda import prepare_off_sort
from repro_torch.obs import trace as obs_trace

from .iteration import IterationRecorder
from .registry import DecompState, MethodSpec, register_method

__all__ = ["cp_als", "cpals_state_to_decomp", "plan_and_build",
           "resolve_ingested"]


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
    """Driver preamble: unwrap an ``Ingested`` handle into
    ``(ingested_or_None, tensor, block, row_tile)`` with the tile defaults
    filled in.  The ingest-time tile geometry is authoritative: an explicit
    request that conflicts with it raises."""
    ing = None
    if not isinstance(t, SparseTensor):
        if not isinstance(t, Ingested):
            raise TypeError(
                f"{name} takes a SparseTensor or repro_torch.ingest."
                f"Ingested, got {type(t).__name__}")
        ing = t
        t = ing.tensor
        for pname, asked, have in (("block", block, ing.block),
                                   ("row_tile", row_tile, ing.row_tile)):
            if asked is not None and asked != have:
                raise ValueError(
                    f"{name} was asked for {pname}={asked} but this tensor "
                    f"was ingested with {pname}={have}; re-ingest with "
                    "tile=(block, row_tile) instead")
        block, row_tile = ing.block, ing.row_tile
    return ing, t, (block if block is not None else 512), (
        row_tile if row_tile is not None else 128)


def plan_and_build(ing, t, impl: str, plan, *, rank, block: int,
                   row_tile: int):
    """The paper's Sort stage for the CP methods: ``(plan, workspaces)``.
    An ingested handle plans with its ingest-time stats and serves its
    cached workspaces; a tensor is planned and sorted here.  The streams
    that ``linearized_cuda`` runs off the sort mode are ordered here too."""
    if ing is not None:
        p = plan if plan is not None else ing.plan(impl, rank=rank)
        ws = ing.workspace(p)
    else:
        p = resolve_plan(t, impl, plan, rank=rank, block=block,
                         row_tile=row_tile)
        ws = build_workspace(t, p)
    with obs_trace.span("sort.streams"):
        prepare_off_sort(ws, p.impls)
    return p, ws


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
    ``"epilogue"`` key when ``fused_epilogue``.  An active enabled tracer
    leaves the plain path as it is (its spans add no synchronisation),
    unless it asks for ``routines="split"``: then the split timed path
    runs.  ``with_fit=False`` skips
    the fit; the returned fit is then the last computed one (a restored
    state's, else NaN).  ``monitor`` receives each iteration's wall time.
    The Gram matrices are ``A.T @ A``, as in the reference driver, with
    TF32 off for the fit and the caller's setting restored after it.

    ``t`` may be an :class:`~repro_torch.ingest.Ingested` handle: the plan
    then reuses the stats measured at ingest, the workspaces come from its
    cache when warm (no Sort), and the factors come back in the tensor's
    original labels (``state``/``checkpoint_cb`` act in the relabeled
    space).
    """
    if not with_fit and tol > 0.0:
        raise ValueError("tol > 0 needs the fit; drop with_fit=False")
    state = _as_cpals_state(state)
    ing, t, block, row_tile = resolve_ingested(t, "cp_als", block=block,
                                               row_tile=row_tile)
    build = functools.partial(plan_and_build, ing, t, impl, plan,
                              rank=rank, block=block, row_tile=row_tile)
    if timers is None and obs_trace.split_routines():
        timers, fused_epilogue = {}, False
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

    decomp = CPDecomp(factors=tuple(factors), lmbda=lmbda, fit=fit)
    return decomp if ing is None else ing.restore(decomp)


register_method(MethodSpec(
    name="cp_als",
    fn=cp_als,
    family="cp",
    kernel="mttkrp",
    supports_dist=True,
    supports_streaming=False,
    nonnegative=False,
    supports_order_gt3=True,
    monotone_fit=True,
    state_aux=("lmbda",),
    description="SPLATT-style CP-ALS (paper Algorithm 1): Cholesky solve "
                "per mode over the planned MTTKRP registry",
))
