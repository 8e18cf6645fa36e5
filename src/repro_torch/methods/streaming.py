"""Streaming CP-ALS: chunked MTTKRP accumulation, no full COO in memory.

Counterpart of ``repro.methods.streaming``.  The method consumes a chunk
source (``repro_torch.ingest.reader.open_chunk_source``: a ``.tnsb`` memory
map, a re-streamed ``.tns``, or an in-memory split) and rebuilds each
mode's MTTKRP as a sum of per-chunk partials:

    M_n  =  sum_chunks  MTTKRP(chunk, factors, n)

Each chunk owns a disjoint subset of the non-zeros at the full dims, so
with ``decay=1`` (the default) an iteration is the batch ALS iteration up
to summation order.  The dense updates (Hadamard product of Grams,
Cholesky solve, normalize, fit) are the batch driver's routines.

``decay < 1`` makes the fold exponentially weighted: ``acc <- decay * acc
+ MTTKRP(chunk)`` as chunks arrive, so a chunk ``k`` positions from the end
of the stream enters with weight ``decay**k`` (online CP for time-ordered
streams).  The fold lives within one pass, so a resume needs no
accumulator state.

Chunks go to the device one at a time; there is no CSF sort (chunks
arrive unsorted), so the COO-consuming ``gather_scatter`` impl is the
local reduction.  I/O: ``order`` passes over the source per iteration.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.coo import DeviceLike, GeneratorLike
from repro_torch.core.cpals import CPDecomp, init_factors
from repro_torch.core.gram import (gram, hadamard_grams, kruskal_fit,
                                   normalize, solve_cholesky)
from repro_torch.core.mttkrp import mttkrp
from repro_torch.ingest.reader import open_chunk_source

from .cp_als import _full_f32_matmul
from .iteration import IterationRecorder
from .registry import DecompState, MethodSpec, make_state, register_method

__all__ = ["cp_als_streaming"]

Tensor = torch.Tensor

# Chunks are padded to a multiple of this, as in the JAX package (where it
# bounds the number of compiled shapes); padding entries add exact zeros.
_CHUNK_PAD = 4096

# COO-consuming impls only: chunks arrive unsorted and are never CSF-built.
_STREAM_IMPLS = ("gather_scatter",)


def cp_als_streaming(
    source,
    rank: int,
    *,
    niters: int = 20,
    tol: float = 0.0,
    impl: str = "gather_scatter",
    plan=None,
    decay: float = 1.0,
    chunk_nnz: int = 1 << 20,
    n_chunks: Optional[int] = None,
    dims=None,
    generator: GeneratorLike | None = None,
    verbose: bool = False,
    first_norm: str = "max",
    state: DecompState | None = None,
    checkpoint_cb: Callable[[DecompState], None] | None = None,
    monitor=None,
    device: DeviceLike = None,
) -> CPDecomp:
    """Online CP-ALS over a chunk source.

    ``source``: a ``.tns``/``.tnsb`` path (its chunks go to ``device``, the
    card when None), a :class:`~repro_torch.core.coo.SparseTensor` (split
    into ``n_chunks`` / ``chunk_nnz``-sized pieces on its own device), or a
    list of same-dims chunks.  ``dims`` forwards to the text reader (it
    skips the scan pass).

    ``decay``: per-chunk exponential weight of the MTTKRP fold (1 = the
    plain sum, the batch iteration; < 1 discounts older chunks).
    ``generator`` draws the initial factors (seed 0 when None) unless
    ``state`` hands them in or resumes; ``tol``/``checkpoint_cb`` as in
    :func:`~repro_torch.methods.cp_als.cp_als`.
    """
    if not 0.0 < decay <= 1.0:
        raise ValueError(f"decay must be in (0, 1], got {decay}")
    if impl not in _STREAM_IMPLS:
        raise ValueError(
            f"cp_als_streaming executes COO chunk reductions only "
            f"({_STREAM_IMPLS}); impl {impl!r} needs a sorted workspace, "
            "which streaming never builds")
    if plan is not None and not set(plan.impls) <= set(_STREAM_IMPLS):
        raise ValueError(
            f"cp_als_streaming cannot execute plan {plan.summary()!r}: "
            f"chunk reductions express only {_STREAM_IMPLS}")

    src = open_chunk_source(source, dims=dims, chunk_nnz=chunk_nnz,
                            n_chunks=n_chunks, device=device)
    dims = src.dims
    order = len(dims)

    # one accumulation pass for ||X||^2 (values only)
    norm_x_sq = 0.0
    dtype = dev = None
    for chunk in src:
        norm_x_sq += float(torch.sum(chunk.vals.float() ** 2))
        dtype, dev = chunk.vals.dtype, chunk.device
    if dev is None:
        raise ValueError("chunk source yielded no chunks")
    norm_x_sq = torch.tensor(norm_x_sq, dtype=torch.float32, device=dev)

    if state is None:
        factors = init_factors(dims, rank,
                               0 if generator is None else generator,
                               dtype=dtype, device=dev)
        lmbda = torch.ones((rank,), dtype=dtype, device=dev)
        fit = torch.tensor(0.0, dtype=dtype, device=dev)
        fit_prev = fit
        start_iter = 0
    else:
        factors = tuple(state.factors)
        lmbda = state.aux["lmbda"]
        # compare the next fit against the last COMPUTED one (see cp_als)
        fit, fit_prev = state.fit, state.fit
        start_iter = int(state.iteration)

    factors = list(factors)

    def mode_mttkrp(n: int) -> Tensor:
        """The exponentially weighted fold of per-chunk partials for mode
        ``n`` (one source pass): acc <- decay * acc + partial."""
        acc = None
        for chunk in src:
            part = mttkrp(chunk.pad_to(_CHUNK_PAD), tuple(factors), n,
                          impl="gather_scatter")
            if acc is None:
                acc = part
            elif decay == 1.0:
                acc = acc + part
            else:
                acc = decay * acc + part
        return acc

    with _full_f32_matmul():
        grams = [gram(a) for a in factors]
        recorder = IterationRecorder("cp_als_streaming", monitor=monitor,
                                     verbose=verbose)
        for it in range(start_iter, niters):
            norm_kind = first_norm if it == 0 else "2"
            with recorder.iteration(it):
                m_last = None
                for n in range(order):
                    m_new = mode_mttkrp(n)
                    v = hadamard_grams(tuple(grams), n)
                    a_new, lmbda = normalize(solve_cholesky(m_new, v),
                                             kind=norm_kind)
                    grams[n] = gram(a_new)
                    factors[n] = a_new
                    m_last = m_new
                fit = kruskal_fit(norm_x_sq, lmbda, tuple(grams), m_last,
                                  factors[-1])
            delta = recorder.progress(it, fit, fit_prev)
            if checkpoint_cb is not None:
                checkpoint_cb(make_state(factors, {"lmbda": lmbda}, fit,
                                         fit_prev, it + 1))
            if tol > 0.0 and it > 0 and abs(delta) < tol:
                fit_prev = fit
                break
            fit_prev = fit

    return CPDecomp(factors=tuple(factors), lmbda=lmbda, fit=fit)


register_method(MethodSpec(
    name="cp_als_streaming",
    fn=cp_als_streaming,
    family="cp",
    kernel="mttkrp",
    supports_dist=False,
    supports_streaming=True,
    nonnegative=False,
    supports_order_gt3=True,
    monotone_fit=True,     # for decay == 1 (the batch-exact fold)
    state_aux=("lmbda",),
    description="online CP-ALS over ingest.reader chunk batches with "
                "exponentially weighted MTTKRP accumulators",
))
