"""CSF: the per-mode sorted, row-tile-aligned, block-padded workspace.

Counterpart of ``repro.core.csf``, with the same layout contract, entry for
entry:

  * non-zeros are sorted by the output-row index, then by the remaining
    modes for fiber locality (SPLATT's no-lock schedule);
  * entries are grouped by output row tile (``row // row_tile``) and each
    group is padded to a multiple of ``block``, so every block of ``block``
    non-zeros writes into exactly one ``row_tile x R`` output tile and the
    block -> tile map (``block_tile``) is non-decreasing;
  * every tile gets at least one block (an empty tile gets one block of
    padding);
  * padding entries carry value 0 and point at their tile's last real row
    (the tile's first row when the tile is empty), which keeps ``row_ids``
    globally non-decreasing.

The build is host-side numpy (the paper's "Sort" pre-processing stage); the
finished arrays are moved to the tensor's device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .coo import SparseTensor

# 512 non-zeros per block and 128 output rows per tile, as in the JAX package.
DEFAULT_BLOCK = 512
DEFAULT_ROW_TILE = 128


@dataclasses.dataclass(frozen=True, eq=False)
class CSF:
    """Per-mode sorted, row-tile-aligned, block-padded sparse workspace.

    mode:       the output mode this replica is sorted by.
    row_ids:    (pnnz,) int32 output row per entry, globally non-decreasing.
    other_ids:  (pnnz, order-1) int32 indices of the remaining modes, in
                ascending mode order (``other_modes`` gives the map).
    vals:       (pnnz,) values, 0 for padding.
    block_tile: (pnnz/block,) int32, non-decreasing block -> output tile map.
    """

    mode: int
    row_ids: torch.Tensor
    other_ids: torch.Tensor
    vals: torch.Tensor
    block_tile: torch.Tensor
    dims: tuple[int, ...]
    nnz: int
    block: int
    row_tile: int

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def order(self) -> int:
        return len(self.dims)

    @property
    def other_modes(self) -> tuple[int, ...]:
        return tuple(m for m in range(self.order) if m != self.mode)

    @property
    def num_rows(self) -> int:
        return self.dims[self.mode]

    @property
    def num_row_tiles(self) -> int:
        return -(-self.dims[self.mode] // self.row_tile)

    @property
    def padded_nnz(self) -> int:
        return int(self.vals.shape[0])

    @property
    def num_blocks(self) -> int:
        return self.padded_nnz // self.block

    @property
    def padding_overhead(self) -> float:
        """Fraction of entries that are padding (the layout's cost)."""
        return 1.0 - self.nnz / max(1, self.padded_nnz)


# The reference's names for the two historical layouts, now one type.
CSFFlat = CSF
CSFTiled = CSF


def _lexsort_perm(inds: np.ndarray, mode: int, other: tuple[int, ...]):
    """Sort permutation: primary key = mode index, then the remaining modes."""
    keys = tuple(inds[:, m] for m in reversed(other)) + (inds[:, mode],)
    return np.lexsort(keys)


def _finalize(rows: np.ndarray, oth: np.ndarray, v: np.ndarray,
              t: SparseTensor, mode: int, block: int, row_tile: int) -> CSF:
    """Tile-align and block-pad pre-sorted entries into a :class:`CSF`.

    Per-tile counts -> blocks per tile -> one scatter of the sorted entries
    into their padded positions.  Empty row tiles get one all-padding block.
    """
    order = t.order
    n = int(v.shape[0])
    n_tiles = -(-t.dims[mode] // row_tile)
    tile_of = rows // row_tile
    counts = np.bincount(tile_of, minlength=n_tiles)
    blocks_per = np.maximum(1, -(-counts // block))
    widths = blocks_per * block
    offsets = np.concatenate([[0], np.cumsum(widths)])[:-1]
    starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
    pnnz = int(widths.sum())

    tile_ids = np.arange(n_tiles, dtype=np.int32)
    # padding rows point at the tile's last real row (first row when empty)
    pad_row = (tile_ids * row_tile).astype(np.int32)
    if n:
        nz = counts > 0
        pad_row[nz] = rows[(starts + counts - 1)[nz]]
    out_rows = np.repeat(pad_row, widths)
    out_oth = np.zeros((pnnz, order - 1), dtype=np.int32)
    out_vals = np.zeros(pnnz, dtype=v.dtype)

    if n:
        pos = offsets[tile_of] + (np.arange(n) - starts[tile_of])
        out_rows[pos] = rows
        out_oth[pos] = oth
        out_vals[pos] = v
    block_tile = np.repeat(tile_ids, blocks_per)

    dev = t.device
    return CSF(
        mode=mode,
        row_ids=torch.from_numpy(out_rows).to(dev),
        other_ids=torch.from_numpy(out_oth).to(dev),
        vals=torch.from_numpy(out_vals).to(dev),
        block_tile=torch.from_numpy(block_tile).to(dev),
        dims=t.dims,
        nnz=t.nnz,
        block=block,
        row_tile=row_tile,
    )


def _host_coo(t: SparseTensor) -> tuple[np.ndarray, np.ndarray]:
    return t.inds[: t.nnz].cpu().numpy(), t.vals[: t.nnz].cpu().numpy()


def build_csf(
    t: SparseTensor,
    mode: int,
    *,
    block: int = DEFAULT_BLOCK,
    row_tile: int = DEFAULT_ROW_TILE,
) -> CSF:
    """Sort non-zeros by ``mode``, tile-align, and block-pad (one lexsort,
    flat gathers and one scatter, on the host)."""
    order = t.order
    if not 0 <= mode < order:
        raise ValueError(f"mode {mode} out of range for order-{order} tensor")
    other = tuple(m for m in range(order) if m != mode)
    inds, in_vals = _host_coo(t)
    perm = _lexsort_perm(inds, mode, other)
    rows = inds[perm, mode].astype(np.int32)
    oth = inds[perm][:, list(other)].astype(np.int32)
    return _finalize(rows, oth, in_vals[perm], t, mode, block, row_tile)


def build_csf_tiled(t: SparseTensor, mode: int, *,
                    block: int = DEFAULT_BLOCK,
                    row_tile: int = DEFAULT_ROW_TILE) -> CSF:
    """Deprecated alias of :func:`build_csf` (the layouts are unified), as
    in the JAX package."""
    return build_csf(t, mode, block=block, row_tile=row_tile)


def build_all_modes(
    t: SparseTensor, *, block: int = DEFAULT_BLOCK,
    row_tile: int = DEFAULT_ROW_TILE,
) -> list[CSF]:
    """One sorted replica per mode: SPLATT's ALLMODE storage policy."""
    return [build_csf(t, m, block=block, row_tile=row_tile)
            for m in range(t.order)]


def build_csf_loop_reference(t: SparseTensor, mode: int) -> CSF:
    """Deliberately naive build (a stable argsort per key, a python copy
    loop): the 'Chapel-initial' analogue of the paper's Fig. 1.  Matches
    :func:`build_csf` entry for entry; the tile-align/pad step is shared."""
    order = t.order
    if not 0 <= mode < order:
        raise ValueError(f"mode {mode} out of range for order-{order} tensor")
    inds, vals = _host_coo(t)
    other = tuple(m for m in range(order) if m != mode)
    perm = np.arange(inds.shape[0])
    for m in reversed(other):
        perm = perm[np.argsort(inds[perm, m], kind="stable")]
    perm = perm[np.argsort(inds[perm, mode], kind="stable")]
    rows, oth, v = [], [], []
    for p in perm:
        rows.append(int(inds[p, mode]))
        oth.append([int(inds[p, m]) for m in other])
        v.append(float(vals[p]))
    rows = np.asarray(rows, dtype=np.int32)
    oth = (np.asarray(oth, dtype=np.int32).reshape(len(rows), order - 1)
           if rows.size else np.zeros((0, order - 1), dtype=np.int32))
    v = np.asarray(v, dtype=vals.dtype)
    return _finalize(rows, oth, v, t, mode, DEFAULT_BLOCK, DEFAULT_ROW_TILE)
