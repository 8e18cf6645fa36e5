"""Medium-grained distributed CP-ALS over ``torch.distributed``
(counterpart of ``repro.core.distributed``).

SPLATT's medium-grained distributed algorithm [Smith & Karypis, IPDPS'16],
the paper's named future work, on a grid of ranks
(``repro_torch.dist.collectives.Mesh``):

  * the (I x J x K) tensor is partitioned over the 2-D grid (rows of
    mode-0 over the row axes x rows of mode-1 over ``'model'``): rank
    (r, c) owns the non-zeros with i in I-block_r and j in J-block_c;
  * factor A is row-sharded over the row axes, B over ``'model'``, C
    replicated (or, with ``shard_c``, row-sharded over the whole grid);
  * each mode-n update does a LOCAL MTTKRP on the owned non-zeros, then an
    ``all_reduce`` over the ranks that hold partial rows (mode-0:
    ``'model'``; mode-1: the row axes; mode-2: both);
  * Gram matrices / column norms / fit are tiny (R x R, R) reductions.

Every rank runs the same loop on its own blocks (what the reference's
``shard_map`` body does on each device); the local MTTKRP is the plain
``gather_scatter`` (``index_add_``) or ``segment`` (a sorted segment sum)
reduction on the rank's device, the only two the reference's body can
express (:data:`DIST_IMPLS`), so this path launches none of the port's
hand-written kernels.  :func:`build_dist_cpals_lowered` gives the dry-run
(``repro_torch.launch.dryrun``) the same body on ``meta`` blocks.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.dist.collectives import (Mesh, cpals_axes, gather_rows,
                                          pgram, pnormalize_columns, psum,
                                          scatter_rows, shard_map)
from repro_torch.obs import trace as obs_trace

from .coo import GeneratorLike, SparseTensor
from .gram import (column_norms, kruskal_fit, kruskal_norm_sq,
                   solve_cholesky)

Tensor = torch.Tensor

# the local MTTKRP reductions the iteration body can express: the
# candidate set every dist-facing planner/validator must respect
DIST_IMPLS = ("gather_scatter", "segment")


# ---------------------------------------------------------------------------
# host-side partitioner
# ---------------------------------------------------------------------------

def partition_tensor(t: SparseTensor, n_row: int, n_col: int,
                     *, pad_factor: float = 1.05):
    """Partition non-zeros over an (n_row x n_col) grid by (mode-0 block,
    mode-1 block), on the host.  Returns numpy (inds (n_row, n_col, L, 3),
    vals (n_row, n_col, L), padded dims), entry for entry the reference's:
    within a block the entries keep their order in ``t``, and padding
    entries have val 0 and point at the block's first local rows."""
    assert t.order == 3, "medium-grained partitioner is 3rd-order (like SPLATT)"
    inds = t.inds[: t.nnz].cpu().numpy()
    vals = t.vals[: t.nnz].cpu().numpy()
    i_p = -(-t.dims[0] // n_row) * n_row
    j_p = -(-t.dims[1] // n_col) * n_col
    bi, bj = i_p // n_row, j_p // n_col
    di = inds[:, 0] // bi
    dj = inds[:, 1] // bj

    counts = np.zeros((n_row, n_col), dtype=np.int64)
    np.add.at(counts, (di, dj), 1)
    cap = int(np.ceil(counts.max() * pad_factor)) if counts.max() else 1

    out_i = np.zeros((n_row, n_col, cap, 3), dtype=np.int32)
    out_v = np.zeros((n_row, n_col, cap), dtype=vals.dtype)
    # default padding coordinates: block-local row 0 of each mode block
    for r in range(n_row):
        out_i[r, :, :, 0] = r * bi
    for c in range(n_col):
        out_i[:, c, :, 1] = c * bj

    # the reference fills entry by entry in lexsort order; the slot of an
    # entry is its rank within its block in that order
    order = np.lexsort((dj, di))
    blk = di[order] * n_col + dj[order]
    starts = np.concatenate([[0], np.cumsum(counts.reshape(-1))[:-1]])
    slot = np.arange(order.size) - starts[blk]
    out_i[di[order], dj[order], slot] = inds[order]
    out_v[di[order], dj[order], slot] = vals[order]
    return out_i, out_v, (i_p, j_p, t.dims[2])


# ---------------------------------------------------------------------------
# one distributed ALS iteration (the per-rank body)
# ---------------------------------------------------------------------------

def _local_mttkrp(inds: Tensor, vals: Tensor, rows_local: int, fa: Tensor,
                  fb: Tensor, fc: Tensor, num_rows: int,
                  impl: str = "scatter",
                  lengths: Optional[Tensor] = None) -> Tensor:
    """Local MTTKRP over this rank's non-zeros.
    rows_local: which column of inds indexes the OUTPUT rows (local ids);
    fa/fb/fc are the gather sources for the three modes (local or global).
    ``impl``: "scatter" (``index_add_``: the atomic analogue) or "segment"
    (a segment sum over entries sorted by output row: the no-lock
    reduction); both are exact, the planner chooses by regime.
    ``lengths``: the entries per output row when ``inds`` is already
    sorted by it (:func:`local_block`); without it "segment" sorts first."""
    prod = vals[:, None].to(fa.dtype)
    sources = (fa, fb, fc)
    for m in range(3):
        if m == rows_local:
            continue
        prod = prod * sources[m][inds[:, m]]
    rows = inds[:, rows_local]
    if impl == "segment":
        if lengths is None:
            perm = torch.argsort(rows, stable=True)
            prod = prod[perm]
            lengths = torch.bincount(rows, minlength=num_rows)
        return torch.segment_reduce(prod, "sum", lengths=lengths, axis=0,
                                    unsafe=True)
    out = torch.zeros((num_rows, prod.shape[1]), dtype=prod.dtype,
                      device=prod.device)
    return out.index_add_(0, rows, prod)


def _local_impls_of(plan) -> tuple[str, str, str]:
    """Map a DecompPlan's per-mode impls onto what the body can express
    (sorted workspaces don't survive the per-rank partitioning, so
    'segment' means a local segment reduction, everything else
    scatter-add)."""
    return tuple("segment" if p.impl == "segment" else "scatter"
                 for p in plan.modes)


@dataclasses.dataclass(frozen=True, eq=False)
class LocalBlock:
    """This rank's non-zeros, prepared once per fit: per mode, the
    localized indices (rows into the rank's factor blocks) and values that
    mode's MTTKRP reads, sorted by the mode's row for a ``segment`` mode,
    with the entries per row (None for a ``scatter`` mode)."""

    inds: tuple[Tensor, ...]
    vals: tuple[Tensor, ...]
    lengths: tuple[Optional[Tensor], ...]


def local_block(inds: Tensor, vals: Tensor, mesh: Mesh, dims_p,
                local_impls: tuple[str, str, str]) -> LocalBlock:
    """Prepare this rank's block (inds (1, 1, L, 3), vals (1, 1, L), what
    the reference's ``shard_map`` hands its body) for the iterations, once
    where the reference's body works on every call: drop the zero-valued
    entries (the partitioner's padding, all on the block's first rows: a
    segment that long serialises the segment sum, and a zero adds nothing
    to any sum), localize the indices into the block-sharded factors and,
    for each ``segment`` mode, sort the entries by that mode's row."""
    ax = cpals_axes(mesh)
    i_p, j_p, k_dim = dims_p
    bi, bj = i_p // ax.n_row, j_p // ax.n_col
    inds, vals = inds[0, 0], vals[0, 0]
    keep = vals != 0
    inds, vals = inds[keep], vals[keep]
    li = inds[:, 0] - mesh.axis_index(ax.row) * bi
    lj = inds[:, 1] - mesh.axis_index(ax.col) * bj
    linds = torch.stack([li, lj, inds[:, 2]], dim=1)
    per_mode = []
    for m, (impl, rows) in enumerate(zip(local_impls, (bi, bj, k_dim))):
        if impl == "segment":
            perm = torch.argsort(linds[:, m], stable=True)
            per_mode.append((linds[perm], vals[perm], torch.bincount(
                linds[:, m], minlength=rows)))
        else:
            per_mode.append((linds, vals, None))
    return LocalBlock(*(tuple(x) for x in zip(*per_mode)))


def make_dist_iteration(mesh: Mesh, dims_p, rank: int, *,
                        norm_kind: str = "2", shard_c: bool = False,
                        local_impls: tuple[str, str, str] = ("scatter",) * 3):
    """The per-rank single-iteration body: ``body(block, a_blk, b_blk, c,
    norm_x_sq) -> (a, b, c, lam, fit)`` on this rank's blocks: its
    non-zeros as a :func:`local_block`, A's row block, B's row block, C
    whole or, with ``shard_c``, this rank's block of it (what the
    reference's ``shard_map`` hands its body).  Every rank must call it
    each iteration.

    ``local_impls``: the plan's per-mode local MTTKRP strategy (see
    ``_local_mttkrp``).

    ``shard_c``: the optimized mode-2 layout.  The baseline replicates C
    and its dense solve/gram on every rank (faithful to SPLATT's
    medium-grained layout for the shortest mode); shard_c row-shards C
    over the WHOLE grid, replaces the mode-2 all-reduce with a
    reduce-scatter (half the wire), solves only local rows, and
    all-gathers C once per iteration.
    """
    ax = cpals_axes(mesh)
    row_ax, col_ax, all_ax = ax.row, ax.col, ax.all_axes
    i_p, j_p, k_dim = dims_p
    bi, bj = i_p // ax.n_row, j_p // ax.n_col
    if shard_c:
        assert k_dim % ax.n_all == 0, (k_dim, ax.n_all)

    def local(block: LocalBlock, mode: int, fa, fb, fc, num_rows: int):
        return _local_mttkrp(block.inds[mode], block.vals[mode], mode, fa,
                             fb, fc, num_rows, impl=local_impls[mode],
                             lengths=block.lengths[mode])

    def body(block, a_blk, b_blk, c_in, norm_x_sq):
        if shard_c:
            # rebuild the full C for the mode-0/1 gathers: the exact
            # inverse of the reduce-scatter order below
            c_full = gather_rows(c_in, mesh, (row_ax, col_ax))
        else:
            c_full = c_in

        ga = pgram(a_blk, mesh, row_ax)
        gb = pgram(b_blk, mesh, col_ax)
        gc = pgram(c_in, mesh, all_ax) if shard_c else c_full.T @ c_full

        # ---- mode 0: partials summed over the 'model' axis ----
        v0 = gb * gc
        m0 = local(block, 0, a_blk, b_blk, c_full, bi)
        m0 = psum(m0, mesh, col_ax)
        a_new = solve_cholesky(m0, v0)
        a_new, lam = pnormalize_columns(a_new, mesh, row_ax, kind=norm_kind)
        ga = pgram(a_new, mesh, row_ax)

        # ---- mode 1: partials summed over the row axes ----
        v1 = ga * gc
        m1 = local(block, 1, a_new, b_blk, c_full, bj)
        m1 = psum(m1, mesh, row_ax)
        b_new = solve_cholesky(m1, v1)
        b_new, lam = pnormalize_columns(b_new, mesh, col_ax, kind=norm_kind)
        gb = pgram(b_new, mesh, col_ax)

        # ---- mode 2 ----
        v2 = ga * gb
        m2 = local(block, 2, a_new, b_new, c_full, k_dim)
        if shard_c:
            # optimized: half-wire reduce+scatter, local dense solve
            m2_blk = scatter_rows(m2, mesh, (row_ax, col_ax))
            c_new = solve_cholesky(m2_blk, v2)
            c_new, lam = pnormalize_columns(c_new, mesh, all_ax,
                                            kind=norm_kind)
            gc = pgram(c_new, mesh, all_ax)
            # blockwise fit: <X,Xhat> from local rows, summed over the grid
            inner = psum(torch.sum(torch.sum(m2_blk * c_new, dim=0)
                                   * lam).reshape(1), mesh, all_ax)[0]
            norm_z_sq = kruskal_norm_sq(lam, (ga, gb, gc))
            resid = torch.clamp(norm_x_sq + norm_z_sq - 2.0 * inner,
                                min=0.0)
            fit = 1.0 - torch.sqrt(resid) / torch.sqrt(norm_x_sq)
            return a_new, b_new, c_new, lam, fit

        m2 = psum(m2, mesh, all_ax)
        c_new = solve_cholesky(m2, v2)
        lam_c = column_norms(c_new, kind=norm_kind)
        safe = torch.where(lam_c == 0.0, torch.ones_like(lam_c), lam_c)
        c_new, lam = c_new / safe[None, :], lam_c
        gc = c_new.T @ c_new

        fit = kruskal_fit(norm_x_sq, lam, (ga, gb, gc), m2, c_new)
        return a_new, b_new, c_new, lam, fit

    return body


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def dist_cp_als(t, rank: int, mesh: Mesh, *, niters: int = 10,
                generator: GeneratorLike | None = None,
                verbose: bool = False, shard_c: bool = False,
                init: tuple | None = None, mode_order: str = "natural",
                monitor=None, impl: str = "auto", plan=None,
                method: str = "cp_als"):
    """Distributed CP-ALS; numerically equivalent to the shared-memory path
    (modulo float32 reduction order).  Every rank of ``mesh`` calls it with
    the same arguments.  Returns (factors, lmbda, fit), the same on every
    rank, on ``mesh.device``.

    ``mode_order='auto'``: partition the two LONGEST modes over the grid and
    exchange the SHORTEST (the mode-2 scatter/gather wire is proportional to
    its length).

    ``impl``/``plan``: the planner interface of :func:`cp_als`:
    ``impl="auto"`` (default) measures per-mode statistics and picks each
    mode's local MTTKRP strategy; a concrete name pins all modes; a
    prebuilt :class:`~repro_torch.plan.DecompPlan` skips planning.  The
    candidate set is restricted to :data:`DIST_IMPLS`.

    ``generator`` (a ``torch.Generator`` on the mesh's device type, or an
    int seed; seed 0 when None) draws the initial factors over the padded
    dims unless ``init`` hands them in (unpadded; the padding rows are
    zero either way).

    ``monitor``: an optional :class:`repro_torch.dist.StragglerMonitor`;
    each iteration's wall time is recorded for every rank (exchanged by
    ``repro_torch.dist.straggler.record_step_times``).

    ``t`` may be a :class:`repro_torch.ingest.Ingested` handle: planning
    reuses the ingest-time stats and the returned factors are mapped back
    to the original labels.

    ``method``: a name from the method registry; a method whose
    :class:`~repro_torch.methods.MethodSpec` declares ``supports_dist=False``
    is rejected with the capability listing."""
    from repro_torch.api.executor import require_capability

    from .cpals import init_factors

    # the one capability gate: same error text here and in
    # Session.fit(executor="dist")
    require_capability(method, "dist")

    ing = None
    if not isinstance(t, SparseTensor):
        from repro_torch.ingest import Ingested

        if not isinstance(t, Ingested):
            raise TypeError(
                f"dist_cp_als takes a SparseTensor or repro_torch.ingest."
                f"Ingested, got {type(t).__name__}")
        ing = t
        t = ing.tensor
    if plan is None:
        if impl != "auto" and impl not in DIST_IMPLS:
            raise ValueError(
                f"dist_cp_als cannot execute impl {impl!r}: the iteration "
                f"body expresses only {DIST_IMPLS} as local reductions")
        if ing is not None:
            plan = ing.plan(impl, rank=rank, allow=DIST_IMPLS)
        else:
            from repro_torch.plan import plan_decomposition

            plan = plan_decomposition(t, impl, rank=rank, allow=DIST_IMPLS,
                                      with_stats=impl == "auto")
    elif not set(plan.impls) <= set(DIST_IMPLS):
        raise ValueError(
            f"dist_cp_als cannot execute plan {plan.summary()!r}: the "
            f"iteration body expresses only {DIST_IMPLS} as local "
            "reductions")

    if mode_order == "auto":
        # longest modes over the grid, shortest on the wire
        perm = tuple(sorted(range(3), key=lambda m: -t.dims[m]))
        tp = SparseTensor(t.inds[:, list(perm)], t.vals,
                          tuple(t.dims[m] for m in perm), t.nnz,
                          device=t.device)
        if init is not None:
            init = tuple(init[m] for m in perm)
        pplan = dataclasses.replace(plan, modes=tuple(
            dataclasses.replace(plan.modes[m], mode=pos)
            for pos, m in enumerate(perm)))
        factors, lam, fit = dist_cp_als(
            tp, rank, mesh, niters=niters, generator=generator,
            verbose=verbose, shard_c=shard_c, init=init,
            mode_order="natural", monitor=monitor, impl=impl, plan=pplan,
            method=method)
        inv = [0] * 3
        for pos, m in enumerate(perm):
            inv[m] = pos
        factors = tuple(factors[inv[m]] for m in range(3))
        if ing is not None:
            factors = ing.restore_factors(factors)
        return factors, lam, fit

    local_impls = _local_impls_of(plan)
    ax = cpals_axes(mesh)
    dev = mesh.device
    inds_np, vals_np, dims_p = partition_tensor(t, ax.n_row, ax.n_col)
    inds = torch.from_numpy(inds_np).to(dev)
    vals = torch.from_numpy(vals_np).to(dev)
    i_p, j_p, k_dim = dims_p
    if shard_c:
        k_dim = -(-k_dim // ax.n_all) * ax.n_all
        dims_p = (i_p, j_p, k_dim)
    dtype = t.vals.dtype
    if init is not None:
        full = []
        for f, dp in zip(init, dims_p):
            f = torch.as_tensor(f, dtype=dtype).to(dev)
            z = torch.zeros((dp, rank), dtype=dtype, device=dev)
            z[: f.shape[0]] = f
            full.append(z)
    else:
        full = list(init_factors(dims_p, rank,
                                 0 if generator is None else generator,
                                 dtype=dtype, device=dev))
    # zero padded factor rows so grams match the unpadded computation
    for f, d in zip(full, t.dims):
        f[d:] = 0.0
    norm_x_sq = torch.sum(vals.float() ** 2)

    it_first = make_dist_iteration(mesh, dims_p, rank, norm_kind="max",
                                   shard_c=shard_c, local_impls=local_impls)
    it_rest = make_dist_iteration(mesh, dims_p, rank, norm_kind="2",
                                  shard_c=shard_c, local_impls=local_impls)

    def run(inds, vals, a, b, c, norm_x_sq):
        block = local_block(inds, vals, mesh, dims_p, local_impls)
        lam = torch.ones((rank,), dtype=dtype, device=dev)
        fit = torch.zeros((), dtype=dtype, device=dev)
        traced = obs_trace.tracing()
        for i in range(niters):
            fn = it_first if i == 0 else it_rest
            t0 = time.time()
            # the span's device_ms is the iteration's time on the card;
            # tracing adds no synchronisation
            with obs_trace.span("iteration", method="dist_cp_als", i=i):
                a, b, c, lam, fit = fn(block, a, b, c, norm_x_sq)
            if monitor is not None:
                from repro_torch.dist.straggler import record_step_times

                _sync(dev)
                record_step_times(monitor, time.time() - t0)
                flags = monitor.check()
                if flags and verbose:
                    print(f"  dist its={i + 1} stragglers: {flags}")
            if traced:
                from repro_torch.obs.recorder import record_event

                record_event("dist.iteration", i=int(i), fit=float(fit),
                             ms=(time.time() - t0) * 1e3)
            if verbose:
                print(f"  dist its={i + 1} fit={float(fit):.6f}")
        return a, b, c, lam, fit

    c_spec = ax.all_spec() if shard_c else ()
    fn = shard_map(run, mesh=mesh,
                   in_specs=(ax.grid_spec(), ax.grid_spec(), ax.row_spec(),
                             ax.col_spec(), c_spec, ()),
                   out_specs=(ax.row_spec(), ax.col_spec(), c_spec, (), ()))
    from repro_torch.methods.cp_als import _full_f32_matmul

    with _full_f32_matmul():
        a, b, c, lam, fit = fn(inds, vals, *full, norm_x_sq)
    factors = (a[: t.dims[0]], b[: t.dims[1]], c[: t.dims[2]])
    if ing is not None:
        factors = ing.restore_factors(factors)
    return factors, lam, fit


def build_dist_cpals_lowered(workload: str, mesh: Mesh, *,
                             shard_c: bool = False,
                             mode_order: str = "natural",
                             local_impls: tuple[str, str, str] = ("scatter",) * 3):
    """One distributed ALS iteration of a paper workload on this rank's
    ``meta`` blocks, the CP-ALS entry of the dry-run matrix (the
    counterpart of the reference's abstract lowering).  Returns
    ``(iteration, info)``: ``iteration()`` runs :func:`make_dist_iteration`'s
    body once, unchanged, and ``iteration.args`` are its arguments.

    As in the reference, a rank holds ``cap`` entries (its even share of
    the non-zeros, 20% over) and no pruning happens: the block is built as
    :func:`local_block` leaves it, at ``cap`` entries, with each
    ``segment`` mode's sorted copy and its (``meta``) entries per row."""
    from repro_torch.configs import CPALS_WORKLOADS

    dims, nnz, rank = CPALS_WORKLOADS[workload]
    if mode_order == "auto":
        dims = tuple(sorted(dims, reverse=True))
    ax = cpals_axes(mesh)
    n_row, n_col, n_all = ax.n_row, ax.n_col, ax.n_all
    i_p = -(-dims[0] // n_row) * n_row
    j_p = -(-dims[1] // n_col) * n_col
    cap = int(np.ceil(nnz / (n_row * n_col) * 1.2))
    k_p = -(-dims[2] // n_all) * n_all if shard_c else dims[2]
    dims_p = (i_p, j_p, k_p)
    bi, bj = i_p // n_row, j_p // n_col

    meta = torch.device("meta")
    f32 = dict(dtype=torch.float32, device=meta)
    linds = torch.empty((cap, 3), dtype=torch.int32, device=meta)
    vals = torch.empty((cap,), **f32)
    per_mode = []
    for impl, rows in zip(local_impls, (bi, bj, k_p)):
        if impl == "segment":
            per_mode.append((torch.empty_like(linds), torch.empty_like(vals),
                             torch.empty((rows,), dtype=torch.int64,
                                         device=meta)))
        else:
            per_mode.append((linds, vals, None))
    block = LocalBlock(*(tuple(x) for x in zip(*per_mode)))
    a = torch.empty((bi, rank), **f32)
    b = torch.empty((bj, rank), **f32)
    c = torch.empty((k_p // n_all if shard_c else k_p, rank), **f32)
    nx = torch.empty((), **f32)

    body = make_dist_iteration(mesh, dims_p, rank, shard_c=shard_c,
                               local_impls=local_impls)
    iteration = functools.partial(body, block, a, b, c, nx)
    # MTTKRP flops: ~5 R nnz per mode (2R gather-products, R scatter-add,
    # 2R for the Khatri-Rao partial) x 3 modes, plus small dense terms.
    info = {"workload": workload, "dims": dims, "nnz": nnz, "rank": rank,
            "local_cap": cap, "shard_c": shard_c, "mode_order": mode_order,
            "local_impls": list(local_impls),
            "model_flops": 3 * 5.0 * rank * nnz}
    return iteration, info
