"""Mode relabelings and locality-aware non-zero reorderings.

Counterpart of ``repro.ingest.relabel``.  Every transform is an invertible
:class:`Relabeling`:

* it relabels each mode's index space (``new_of_old`` / ``old_of_new``
  maps, ``-1`` marking slices that compaction dropped),
* optionally reorders the non-zero list (``entry_perm``),
* composes (:meth:`Relabeling.then`) and inverts (:meth:`Relabeling.invert`)
  exactly, and
* maps factor matrices both ways (:meth:`apply_factors` /
  :meth:`restore_factors`), so a decomposition computed in the relabeled
  space is reported in the tensor's original labels.

Builders: ``compact`` (drop empty slices), ``degree_sort`` (hot rows first
per mode, then entries round-robined over the mode with the most reducible
measured intra-block collision), ``random_block`` (shuffled row blocks and
entries, the locality-destroying baseline) and ``identity``.

The builders are host-side numpy, the same calls as the JAX package's, so
their maps and permutations are the reference's integer for integer; the
maps are int32 tensors on the tensor's device.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.coo import DeviceLike, SparseTensor, resolve_device
from repro_torch.core.csf import DEFAULT_BLOCK
from repro_torch.plan.stats import measured_block_collision

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True, eq=False)
class Relabeling:
    """An invertible per-mode relabeling and optional entry reordering.

    new_of_old[m][old] = new index of slice ``old`` in mode ``m`` (-1 when
                         compaction dropped it; only empty slices are);
    old_of_new[m][new] = original index (total and injective);
    entry_perm:          new storage order, ``new_list[i] = old_list[p[i]]``
                         (None: order kept);
    linearized_mode:     the mode the entry reordering round-robins over
                         (None when the entry order is kept or shuffled).
    """

    new_of_old: tuple[Tensor, ...]
    old_of_new: tuple[Tensor, ...]
    dims_old: tuple[int, ...]
    dims_new: tuple[int, ...]
    entry_perm: Optional[Tensor] = None
    linearized_mode: Optional[int] = None

    @property
    def order(self) -> int:
        return len(self.dims_old)

    @property
    def is_identity(self) -> bool:
        if self.entry_perm is not None or self.dims_old != self.dims_new:
            return False
        return all(torch.equal(m, torch.arange(m.shape[0], dtype=m.dtype,
                                               device=m.device))
                   for m in self.new_of_old)

    # -- tensors -----------------------------------------------------------
    def apply(self, t: SparseTensor) -> SparseTensor:
        """Relabel (and reorder) ``t`` on its device.  Padding entries are
        dropped: relabeling is a build-time step; pad again downstream."""
        if t.dims != self.dims_old:
            raise ValueError(f"tensor dims {t.dims} != relabeling "
                             f"dims_old {self.dims_old}")
        inds = t.inds[: t.nnz].long()
        vals = t.vals[: t.nnz]
        cols = [self.new_of_old[m].to(t.device)[inds[:, m]]
                for m in range(self.order)]
        new_inds = torch.stack(cols, dim=1).to(torch.int32)
        if self.entry_perm is not None:
            perm = self.entry_perm.to(t.device).long()
            new_inds = new_inds[perm]
            vals = vals[perm]
        return SparseTensor(new_inds, vals, self.dims_new, t.nnz,
                            device=t.device)

    def invert(self) -> "Relabeling":
        perm = None
        if self.entry_perm is not None:
            perm = torch.argsort(self.entry_perm.long()).to(torch.int32)
        return Relabeling(
            new_of_old=self.old_of_new, old_of_new=self.new_of_old,
            dims_old=self.dims_new, dims_new=self.dims_old,
            entry_perm=perm, linearized_mode=None)

    def then(self, other: "Relabeling") -> "Relabeling":
        """Composition: ``self`` first, then ``other`` (which acts in
        ``self``'s new index space)."""
        if self.dims_new != other.dims_old:
            raise ValueError(f"cannot compose: dims_new {self.dims_new} != "
                             f"next dims_old {other.dims_old}")
        new_of_old = []
        for m in range(self.order):
            a = self.new_of_old[m]
            nxt = other.new_of_old[m][a.clamp(min=0).long()]
            new_of_old.append(torch.where(a >= 0, nxt, -1).to(torch.int32))
        old_of_new = tuple(self.old_of_new[m][other.old_of_new[m].long()]
                           for m in range(self.order))
        if self.entry_perm is None:
            perm = other.entry_perm
        elif other.entry_perm is None:
            perm = self.entry_perm
        else:
            perm = self.entry_perm[other.entry_perm.long()]
        lin = (other.linearized_mode if other.linearized_mode is not None
               else self.linearized_mode)
        return Relabeling(tuple(new_of_old), old_of_new, self.dims_old,
                          other.dims_new, perm, lin)

    # -- factors -----------------------------------------------------------
    def apply_factors(self, factors: Sequence[Tensor]) -> tuple[Tensor, ...]:
        """Original-label factors -> relabeled space (a row gather)."""
        return tuple(f[self.old_of_new[m].to(f.device).long()]
                     for m, f in enumerate(factors))

    def restore_factors(self, factors: Sequence[Tensor]) -> tuple[Tensor, ...]:
        """Relabeled-space factors -> original labels.  Rows of slices that
        compaction dropped (necessarily empty) come back as zeros."""
        out = []
        for m, f in enumerate(factors):
            full = f.new_zeros((self.dims_old[m],) + tuple(f.shape[1:]))
            full[self.old_of_new[m].to(f.device).long()] = f
            out.append(full)
        return tuple(out)


def identity_relabeling(dims: Sequence[int],
                        device: DeviceLike = None) -> Relabeling:
    """The no-op relabeling, its maps on ``device`` (the card when None)."""
    dev = resolve_device(device)
    dims = tuple(int(d) for d in dims)
    maps = tuple(torch.arange(d, dtype=torch.int32, device=dev)
                 for d in dims)
    return Relabeling(maps, maps, dims, dims)


def _row_maps(dims: Sequence[int], orders: list[np.ndarray]) -> list[np.ndarray]:
    """Per-mode ``new_of_old`` from ``old_of_new`` row orders (each an
    injective array of old ids; old ids not listed map to -1)."""
    fwds = []
    for d, order in zip(dims, orders):
        fwd = np.full(int(d), -1, dtype=np.int32)
        fwd[order] = np.arange(order.shape[0], dtype=np.int32)
        fwds.append(fwd)
    return fwds


def _from_row_orders(t: SparseTensor, orders: list[np.ndarray],
                     dims_new: tuple[int, ...], *,
                     entry_perm: Optional[np.ndarray] = None,
                     linearized_mode: Optional[int] = None) -> Relabeling:
    """A Relabeling on ``t``'s device from host row orders."""
    def dev(a: np.ndarray) -> Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(
            t.device)

    return Relabeling(
        tuple(dev(f) for f in _row_maps(t.dims, orders)),
        tuple(dev(o) for o in orders), t.dims, dims_new,
        None if entry_perm is None else dev(entry_perm), linearized_mode)


def _mode_counts(t: SparseTensor) -> list[np.ndarray]:
    inds = t.inds[: t.nnz].cpu().numpy()
    return [np.bincount(inds[:, m], minlength=t.dims[m])
            for m in range(t.order)]


# ---------------------------------------------------------------------------
# transform builders
# ---------------------------------------------------------------------------

def identity(t: SparseTensor, **_) -> Relabeling:
    return identity_relabeling(t.dims, t.device)


def compact(t: SparseTensor, **_) -> Relabeling:
    """Drop empty slices per mode (relative order kept)."""
    orders = [np.flatnonzero(c > 0).astype(np.int32)
              for c in _mode_counts(t)]
    dims_new = tuple(int(o.shape[0]) for o in orders)
    return _from_row_orders(t, orders, dims_new)


def degree_sort(t: SparseTensor, *, block: int = DEFAULT_BLOCK,
                **_) -> Relabeling:
    """Hot rows first per mode, and a contention-aware entry reordering.

    Each mode's slices are renumbered by descending non-zero count
    (stable).  Then, of all modes, the one with the largest reducible
    measured intra-block collision (measured minus the ``1 - rows/block``
    floor no ordering beats) orders the entries by (occurrence within the
    row, row): each row's k-th entry lands in the k-th wave.
    """
    counts = _mode_counts(t)
    orders = [np.argsort(-c, kind="stable").astype(np.int32) for c in counts]
    fwds = _row_maps(t.dims, orders)

    inds = t.inds[: t.nnz].cpu().numpy()
    new_cols = [fwds[m][inds[:, m]] for m in range(t.order)]

    reducible = []
    for m in range(t.order):
        floor = max(0.0, 1.0 - t.dims[m] / block)
        reducible.append(
            measured_block_collision(new_cols[m], block) - floor)
    lin_mode = int(np.argmax(reducible))

    rows = new_cols[lin_mode]
    occ = _occurrence_within_row(rows)
    entry_perm = np.lexsort((rows, occ)).astype(np.int32)
    return _from_row_orders(t, orders, t.dims, entry_perm=entry_perm,
                            linearized_mode=lin_mode)


def _occurrence_within_row(rows: np.ndarray) -> np.ndarray:
    """occ[n] = how many earlier entries share rows[n]'s row (a grouped
    cumulative count, vectorized)."""
    n = rows.shape[0]
    perm = np.argsort(rows, kind="stable")
    sr = rows[perm]
    first = np.ones(n, dtype=bool)
    first[1:] = sr[1:] != sr[:-1]
    starts = np.flatnonzero(first)
    group = np.cumsum(first) - 1
    occ_sorted = np.arange(n) - starts[group]
    occ = np.empty(n, dtype=np.int64)
    occ[perm] = occ_sorted
    return occ


def random_block(t: SparseTensor, *, seed: int = 0, block_rows: int = 128,
                 **_) -> Relabeling:
    """Shuffle each mode's row blocks and the non-zero order (the
    locality-destroying baseline), from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    orders = []
    for d in t.dims:
        n_blocks = -(-d // block_rows)
        blocks = rng.permutation(n_blocks)
        order = np.concatenate(
            [np.arange(b * block_rows, min(d, (b + 1) * block_rows))
             for b in blocks]).astype(np.int32)
        orders.append(order)
    perm = rng.permutation(t.nnz).astype(np.int32)
    return _from_row_orders(t, orders, t.dims, entry_perm=perm)


REORDERINGS = {
    "identity": identity,
    "degree_sort": degree_sort,
    "random_block": random_block,
}


def make_reorder(t: SparseTensor, name: str, *, block: int = DEFAULT_BLOCK,
                 seed: int = 0) -> Relabeling:
    """Build the named reordering for ``t`` (registry: ``REORDERINGS``)."""
    try:
        fn = REORDERINGS[name]
    except KeyError:
        raise ValueError(
            f"unknown reorder {name!r}; one of {tuple(REORDERINGS)}") from None
    return fn(t, block=block, seed=seed)
