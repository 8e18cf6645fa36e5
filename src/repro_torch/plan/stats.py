"""Per-mode tensor statistics: the planner's evidence.

A copy of ``repro.plan.stats`` (host-side numpy over the COO indices):

* ``collision_rate``: expected fraction of entries in a random block of
  ``block`` non-zeros that share their output row with another entry of the
  block, from the row histogram: E[unique rows in a k-sample] =
  sum_i (1 - (1 - c_i/nnz)^k).
* ``block_collision_rate``: the same fraction measured over consecutive
  ``block``-sized chunks of the storage order.
* ``padding_overhead``: the padding fraction the tiled CSF workspace would
  have for this mode, computed without building it.
* ``skew`` / ``hot_row_share``: max-row concentration.

``stats_digest`` hashes the measured stats into the autotune store's key.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

from repro_torch.core.coo import SparseTensor

# collision_rate above this puts a mode in the paper's mutex/atomic
# contention regime; below it the mode is collision-light ("no-lock").
CONTENTION_THRESHOLD = 0.5


@dataclasses.dataclass(frozen=True)
class ModeStats:
    """Measured per-mode statistics for one candidate workspace geometry."""

    mode: int
    order: int
    rows: int
    nnz: int
    avg_nnz_per_row: float
    max_nnz_per_row: int
    skew: float             # max_nnz_per_row / avg_nnz_per_row
    hot_row_share: float    # max_nnz_per_row / nnz
    collision_rate: float   # expected intra-block colliding fraction
    padding_overhead: float  # padding fraction of the tiled CSF workspace
    block: int
    row_tile: int
    block_collision_rate: float = 0.0

    @property
    def regime(self) -> str:
        """The paper's section V-D regime for scatter-style impls."""
        return ("contention" if self.collision_rate > CONTENTION_THRESHOLD
                else "no-lock")


def _collision_rate(counts: np.ndarray, nnz: int, block: int) -> float:
    """1 - E[unique rows in a uniform k-sample] / k, k = min(block, nnz)."""
    if nnz <= 1:
        return 0.0
    k = min(block, nnz)
    p = counts[counts > 0].astype(np.float64) / float(nnz)
    expected_unique = float(np.sum(1.0 - np.power(1.0 - p, k)))
    return float(max(0.0, 1.0 - expected_unique / k))


def measured_block_collision(idx: np.ndarray, block: int) -> float:
    """1 - unique rows per consecutive size-``block`` chunk / chunk size,
    over the output rows in storage order."""
    idx = np.asarray(idx)
    n = int(idx.shape[0])
    if n <= 1:
        return 0.0
    chunk = (np.arange(n, dtype=np.int64) // block)
    key = chunk * (int(idx.max()) + 1) + idx.astype(np.int64)
    unique_per_chunk_total = np.unique(key).shape[0]
    return float(max(0.0, 1.0 - unique_per_chunk_total / n))


def _padding_overhead(rows_sorted_counts_per_tile: np.ndarray, nnz: int,
                      block: int) -> float:
    blocks_per = np.maximum(1, -(-rows_sorted_counts_per_tile // block))
    pnnz = int(blocks_per.sum()) * block
    return 1.0 - nnz / max(1, pnnz)


def mode_stats(t: SparseTensor, mode: int, *, block: int,
               row_tile: int) -> ModeStats:
    """Measure one mode of ``t`` against a (block, row_tile) workspace."""
    if not 0 <= mode < t.order:
        raise ValueError(f"mode {mode} out of range for order-{t.order} tensor")
    rows = int(t.dims[mode])
    nnz = int(t.nnz)
    idx = t.inds[:nnz, mode].cpu().numpy()
    counts = np.bincount(idx, minlength=rows)
    max_c = int(counts.max()) if nnz else 0
    avg = nnz / max(1, rows)

    n_tiles = -(-rows // row_tile)
    tile_counts = np.bincount(idx // row_tile, minlength=n_tiles)

    return ModeStats(
        mode=mode,
        order=t.order,
        rows=rows,
        nnz=nnz,
        avg_nnz_per_row=avg,
        max_nnz_per_row=max_c,
        skew=max_c / max(avg, 1e-12),
        hot_row_share=max_c / max(1, nnz),
        collision_rate=_collision_rate(counts, nnz, block),
        padding_overhead=_padding_overhead(tile_counts, nnz, block),
        block=block,
        row_tile=row_tile,
        block_collision_rate=measured_block_collision(idx, block),
    )


def tensor_stats(t: SparseTensor, *, block: int,
                 row_tile: int) -> list[ModeStats]:
    """One :class:`ModeStats` per mode (the planner's full evidence set)."""
    return [mode_stats(t, m, block=block, row_tile=row_tile)
            for m in range(t.order)]


def stats_digest(stats) -> str:
    """Short content digest over measured :class:`ModeStats`: part of the
    autotune store's calibration key, so two tensors whose bytes hash alike
    but whose measured per-mode statistics differ never share timings."""
    h = hashlib.sha256()
    for s in stats:
        h.update(repr(dataclasses.astuple(s)).encode())
    return h.hexdigest()[:16]
