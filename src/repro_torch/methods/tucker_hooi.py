"""Sparse Tucker decomposition via HOOI on the TTMc registry.

Counterpart of ``repro.methods.tucker_hooi``.  HOOI (higher-order
orthogonal iteration) alternates, for each mode n:

    Y_(n)  =  mode-n TTMc of X against every other mode's factor
              (``repro_torch.core.ttmc``, planned per mode by
              ``plan_decomposition(kernel="ttmc")``)
    U_n    =  leading R_n left singular vectors of Y_(n)
              (:func:`leading_left_vectors`: from the float64 Gram of Y's
              smaller side and its eigenvectors)

and recovers the core from the final TTMc, with no extra pass over X:

    G_(N-1)  =  U_{N-1}^T Y_(N-1)

With orthonormal factors ``||X - Xhat||^2 = ||X||^2 - ||G||^2``, so the fit
comes from the core too, and it does not fall across sweeps.  The
truncation needs only Y's leading R_n-dimensional subspace, not its whole
thin SVD: the W x W Gram ``Y^T Y`` (W the Kronecker width, I x I ``Y Y^T``
where the mode is the shorter side) is accumulated in float64 from row
blocks of Y, its top R_n eigenpairs give ``U = Y V Lambda^{-1/2}``, and one
Cholesky-QR pass in float64 makes U orthonormal again.  Where Y's shape
leaves no such cut, the Gram is numerically rank-deficient or the Cholesky
factorisation fails, the thin SVD decides, as the reference's does.  These
and the small products around
them are dense library calls (cuBLAS, cuSOLVER on the card), as the
reference leaves them to XLA; the TTMc is the sparse kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from repro_torch.core.coo import DeviceLike, GeneratorLike, make_generator
from repro_torch.core.cpals import _timed, build_workspace
from repro_torch.core.ttmc import ttmc
from repro_torch.kernels.linearized_cuda import prepare_off_sort
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.metrics import get_registry

from .cp_als import _full_f32_matmul, resolve_ingested
from .iteration import IterationRecorder
from .registry import DecompState, MethodSpec, make_state, register_method

__all__ = ["TuckerDecomp", "leading_left_vectors", "tucker_hooi"]

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True, eq=False)
class TuckerDecomp:
    """Result: X ~ core x_1 U_1 x_2 U_2 ... (orthonormal U_m)."""

    core: Tensor                 # (R_0, ..., R_{N-1})
    factors: tuple[Tensor, ...]  # per-mode (I_m, R_m), orthonormal columns
    fit: Tensor

    @property
    def ranks(self) -> tuple[int, ...]:
        return tuple(int(a.shape[1]) for a in self.factors)

    def values_at(self, inds: Tensor) -> Tensor:
        """Reconstructed entries at a coordinate list (n, order)."""
        letters = "abcdefgh"[:len(self.factors)]
        eq = letters + "," + ",".join(f"n{c}" for c in letters) + "->n"
        rows = [a[inds[:, m]] for m, a in enumerate(self.factors)]
        return torch.einsum(eq, self.core, *rows)

    def to_dense(self) -> Tensor:
        """Densify (tests only)."""
        order = len(self.factors)
        letters = "abcdefgh"[:order]
        ranks = "pqrstuvw"[:order]
        eq = (ranks + "," + ",".join(f"{l}{r}" for l, r in zip(letters, ranks))
              + "->" + letters)
        return torch.einsum(eq, self.core, *self.factors)


def _resolve_ranks(rank, dims: Sequence[int]) -> tuple[int, ...]:
    """An int broadcasts (capped at each mode length); a sequence is taken
    per mode and validated."""
    if isinstance(rank, (int, float)):
        return tuple(min(int(rank), int(d)) for d in dims)
    ranks = tuple(int(r) for r in rank)
    if len(ranks) != len(dims):
        raise ValueError(
            f"rank={ranks} names {len(ranks)} modes, tensor has {len(dims)}")
    bad = [m for m, (r, d) in enumerate(zip(ranks, dims)) if r > int(d)]
    if bad:
        raise ValueError(
            f"Tucker rank exceeds mode length in mode(s) {bad} "
            f"(ranks={ranks}, dims={tuple(dims)})")
    return ranks


def _kron_widths(ranks: Sequence[int]) -> tuple[int, ...]:
    """Per-mode TTMc output width prod_{m != n} R_m: what the planner's
    cost models score for the ``ttmc`` kernel."""
    out = []
    for n in range(len(ranks)):
        w = 1
        for m, r in enumerate(ranks):
            if m != n:
                w *= r
        out.append(w)
    return tuple(out)


def _init_orthonormal(dims: Sequence[int], ranks: Sequence[int],
                      generator: GeneratorLike, dtype: torch.dtype,
                      device: DeviceLike) -> tuple[Tensor, ...]:
    """One (dim, R) factor with orthonormal columns per mode: the Q of a QR
    of standard normals drawn on ``device`` from ``generator``, row-major
    (the kernels take contiguous factors; LAPACK's Q is column-major)."""
    dev = torch.device(device)
    g = make_generator(generator, dev)
    return tuple(
        torch.linalg.qr(torch.randn((int(d), int(r)), generator=g,
                                    dtype=dtype, device=dev))[0].contiguous()
        for d, r in zip(dims, ranks))


# The Gram route gives way to the SVD where the R-th eigenvalue of the
# float64 Gram is at most this share of the first.  The Gram's own rounding
# is about W * eps64 * lambda_1 (2.8e-14 lambda_1 at W = 256), and the
# eigenvector error that U = Y V Lambda^{-1/2} carries into U's columns
# grows as eps64 * lambda_1 / lambda_R: at 1e-10 it is about 1e-6, which the
# Cholesky-QR pass takes out; much below, the Gram no longer resolves the
# R-th direction (an exactly rank-deficient float32 Y puts its surplus
# eigenvalues at the rounding level, near 1e-15 lambda_1).
RANK_DEFICIENT = 1e-10
# elements of Y converted to float64 at a time: 64 MB blocks, so no float64
# copy of a whole Y (154 MB for yelp's mode 2 at W = 256) is made, and few
# blocks to launch (three there; at 16 MB the blocks' launches held the
# card idle)
_BLOCK_ELEMENTS = 1 << 23


def _svd_left(y: Tensor, rank: int) -> Tensor:
    """The leading ``rank`` left singular vectors of ``y`` from its thin
    SVD, row-major (LAPACK's U is column-major, its leading columns a
    strided view, and the kernels take contiguous factors)."""
    return torch.linalg.svd(y, full_matrices=False)[0][:, :rank].contiguous()


def _row_blocks(a: Tensor):
    """``a``'s rows a block at a time (each converted to float64 by its
    caller, one block alive at a time)."""
    step = max(1, _BLOCK_ELEMENTS // max(1, a.shape[1]))
    for i in range(0, a.shape[0], step):
        yield i, a[i:i + step]


def _gram64(a: Tensor) -> Tensor:
    """``a^T a`` accumulated in float64."""
    g = torch.zeros((a.shape[1], a.shape[1]), dtype=torch.float64,
                    device=a.device)
    for _, rows in _row_blocks(a):
        block = rows.double()
        g.addmm_(block.T, block)
        del block  # before the next block is converted
    return g


def _cholesky_qr(y: Tensor, v: Tensor, lam: Tensor) -> tuple[Tensor, Tensor]:
    """``U = Y V Lambda^{-1/2}`` in float64, then one Cholesky-QR pass
    (``U L^{-T}``, L the Cholesky factor of ``U^T U``), which keeps
    ``U^T U`` at the identity however far lambda_R lies below lambda_1;
    with the factorisation's ``info`` (0 where it succeeded), unread."""
    scale = v / torch.sqrt(lam)
    u = torch.empty((y.shape[0], v.shape[1]), dtype=torch.float64,
                    device=y.device)
    for i, rows in _row_blocks(y):
        torch.mm(rows.double(), scale, out=u[i:i + rows.shape[0]])
    chol, info = torch.linalg.cholesky_ex(u.T @ u)
    return torch.linalg.solve_triangular(chol.T, u, upper=True,
                                         left=False), info


def leading_left_vectors(y: Tensor, rank: int) -> tuple[Tensor, str]:
    """An orthonormal basis of the leading ``rank``-dimensional left
    singular subspace of ``y`` (I x W), as a contiguous (I, rank) tensor of
    ``y``'s dtype, and the path that gave it: ``"gram"`` or ``"svd"``.

    ``"gram"``: the Gram of ``y``'s smaller side in float64 and its top
    eigenpairs; where I >= W, U from :func:`_cholesky_qr`; where I < W,
    the eigenvectors of ``Y Y^T`` are U.  ``"svd"``: the thin SVD, where
    the shape leaves no cut (W < rank or I <= rank: U is then what the SVD
    gives, as in the reference), the Gram is numerically rank-deficient
    (lambda_R <= ``RANK_DEFICIENT`` lambda_1, a zero Y among them) or the
    Cholesky factorisation fails.  The spectrum and the factorisation are
    read in one synchronisation.  Counted in the process registry as
    ``tucker.truncation.gram`` / ``tucker.truncation.svd``."""
    rows, width = y.shape
    if width >= rank and rows > rank:
        # the Gram of the smaller side: where W >> I a W x W Gram would
        # outgrow Y (order 4 at ranks 32: W = 32 768, 8.6 GB in float64)
        tall = rows >= width
        # eigh on Y's device: at W = 256 an H100 takes 2.1-2.3 ms, its
        # host (four threads) 10-14 ms with the copies
        lam, v = torch.linalg.eigh(_gram64(y if tall else y.T))
        lam, v = lam[-rank:].flip(0), v[:, -rank:].flip(1)
        resolved = lam[-1] > RANK_DEFICIENT * lam[0]
        u = v
        if tall:
            u, info = _cholesky_qr(y, v, lam)
            resolved &= info == 0
        if bool(resolved):
            get_registry().counter("tucker.truncation.gram").inc()
            return u.to(y.dtype).contiguous(), "gram"
    get_registry().counter("tucker.truncation.svd").inc()
    return _svd_left(y, rank), "svd"


def _hooi_mode(ws_n, factors, *, mode: int, impl: str, out_rank: int,
               timers: Optional[dict]):
    """TTMc + truncation for one mode: (U_mode, Y_(mode)), U row-major.
    The truncation (:func:`leading_left_vectors`) runs in an ``svd`` span
    that carries the ``path`` it took."""
    if timers is None:
        y = ttmc(ws_n, factors, mode, impl=impl)
    else:
        y = _timed(timers, "ttmc", ttmc, ws_n, factors, mode, impl=impl)
    with obs_trace.span("svd", mode=mode) as sp:
        if timers is None:
            u, path = leading_left_vectors(y, out_rank)
        else:
            u, path = _timed(timers, "svd", leading_left_vectors, y,
                             out_rank)
        sp.annotate(path=path)
    return u, y


def _core_from_last(u_last: Tensor, y_last: Tensor,
                    ranks: Sequence[int]) -> Tensor:
    """G from the final mode's TTMc: G_(N-1) = U^T Y, un-matricized.

    Y's columns are row-major over the other modes in ascending order, so
    the reshape puts the last mode's rank axis first and a moveaxis restores
    mode order."""
    order = len(ranks)
    core = (u_last.T @ y_last).reshape((ranks[-1],) + tuple(ranks[:-1]))
    return torch.movedim(core, 0, order - 1)


def _fit_from_core(core: Tensor, norm_x_sq: Tensor) -> Tensor:
    # orthonormal factors: ||X - Xhat||^2 = ||X||^2 - ||G||^2
    resid_sq = torch.clamp(norm_x_sq - torch.sum(core * core), min=0.0)
    return 1.0 - torch.sqrt(resid_sq) / torch.sqrt(norm_x_sq)


def tucker_hooi(
    t,
    rank,
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
    state: DecompState | None = None,
    checkpoint_cb: Callable[[DecompState], None] | None = None,
    monitor=None,
) -> TuckerDecomp:
    """Sparse Tucker via HOOI on ``t``'s device.

    ``rank`` is a per-mode tuple of core ranks (an int broadcasts, capped
    at each mode length).  ``impl`` is the planner policy, scored against
    the TTMc registry with each mode's Kronecker width as its rank;
    ``"cuda"`` runs K1 at Kronecker width, ``"linearized_cuda"`` K3 on every
    mode of the one workspace.  ``generator`` (a ``torch.Generator`` on ``t``'s
    device, or an int seed; seed 0 when None) draws the initial orthonormal
    factors unless ``state`` hands them in (``iteration=0``) or resumes a
    run.  ``timers=`` synchronises the card around each routine and adds
    its seconds under ``"sort"`` (plan + workspace build, with the
    ordered streams of ``linearized_cuda``'s off-sort modes), ``"ttmc"``,
    ``"svd"`` and ``"fit"``, as does an active tracer with
    ``routines="split"``; any other tracer leaves the plain path, whose
    ``ttmc`` (the TTMc and its ``svd`` child) and ``fit`` spans add no
    synchronisation.  An :class:`~repro_torch.ingest.Ingested`
    ``t`` plans with its ingest-time stats, uses its cached workspaces and
    gets its factors back in the original labels.
    """
    ing, t, block, row_tile = resolve_ingested(t, "tucker_hooi", block=block,
                                               row_tile=row_tile)
    ranks = _resolve_ranks(rank, t.dims)
    widths = _kron_widths(ranks)

    def _plan_and_build():
        p = plan
        if ing is not None:
            if p is None:
                p = ing.plan(impl, rank=widths, kernel="ttmc",
                             factor_ranks=ranks)
            ws = ing.workspace(p)
        else:
            if p is None:
                from repro_torch.plan import plan_decomposition

                p = plan_decomposition(t, impl, rank=widths, block=block,
                                       row_tile=row_tile, kernel="ttmc",
                                       with_stats=impl == "auto",
                                       factor_ranks=ranks)
            ws = build_workspace(t, p)
        # the off-sort modes' ordered streams count under the Sort
        with obs_trace.span("sort.streams"):
            prepare_off_sort(ws, p.impls)
        return p, ws

    if timers is None and obs_trace.split_routines():
        timers = {}
    if timers is not None:
        plan, ws = _timed(timers, "sort", _plan_and_build)
    else:
        plan, ws = _plan_and_build()
    impls = plan.impls

    dtype, dev = t.vals.dtype, t.device
    norm_x_sq = torch.sum(t.vals.float() ** 2)
    if state is None:
        factors = _init_orthonormal(t.dims, ranks,
                                    0 if generator is None else generator,
                                    dtype, dev)
        fit = torch.tensor(0.0, dtype=dtype, device=dev)
        fit_prev = fit
        start_iter = 0
    else:
        factors = tuple(state.factors)
        # compare the next fit against the last COMPUTED one (see cp_als)
        fit, fit_prev = state.fit, state.fit
        start_iter = int(state.iteration)

    order = t.order
    core = y_last = None
    recorder = IterationRecorder("tucker_hooi", monitor=monitor,
                                 verbose=verbose)
    with _full_f32_matmul():
        for it in range(start_iter, niters):
            with recorder.iteration(it):
                factors = list(factors)
                for n in range(order):
                    # the TTMc and, in a child span, its truncation
                    with obs_trace.span("ttmc", mode=n, impl=impls[n]):
                        factors[n], y_last = _hooi_mode(
                            ws[n], tuple(factors), mode=n, impl=impls[n],
                            out_rank=ranks[n], timers=timers)
                factors = tuple(factors)
                with obs_trace.span("fit"):
                    if timers is None:
                        core = _core_from_last(factors[-1], y_last, ranks)
                        fit = _fit_from_core(core, norm_x_sq)
                    else:
                        core = _timed(timers, "fit", _core_from_last,
                                      factors[-1], y_last, ranks)
                        fit = _timed(timers, "fit", _fit_from_core, core,
                                     norm_x_sq)
            delta = recorder.progress(it, fit, fit_prev)
            if checkpoint_cb is not None:
                checkpoint_cb(make_state(factors, {}, fit, fit_prev, it + 1))
            if tol > 0.0 and it > 0 and abs(delta) < tol:
                fit_prev = fit
                break
            fit_prev = fit

        if y_last is None:
            # resumed at (or past) niters: recover the core with one more
            # TTMc
            y_last = ttmc(ws[order - 1], tuple(factors), order - 1,
                          impl=impls[order - 1])
            core = _core_from_last(factors[-1], y_last, ranks)
            fit = _fit_from_core(core, norm_x_sq)

    decomp = TuckerDecomp(core=core, factors=tuple(factors), fit=fit)
    return decomp if ing is None else ing.restore(decomp)


register_method(MethodSpec(
    name="tucker_hooi",
    fn=tucker_hooi,
    family="tucker",
    kernel="ttmc",
    supports_dist=False,
    supports_streaming=False,
    nonnegative=False,
    supports_order_gt3=True,
    monotone_fit=True,
    description="sparse Tucker via HOOI: per-mode chain-of-modes TTMc + "
                "truncation to the leading left singular subspace; core "
                "recovered from the final TTMc",
))
