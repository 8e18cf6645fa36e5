"""Linearized (ALTO-style) workspace: one bit-packed index serves every mode.

Counterpart of ``repro.core.linearized``, with the same packing, entry for
entry.  Every coordinate tuple is packed into one 64-bit integer with a bit
field per mode,

    lin(i_0, .., i_{N-1}) = sum_m  i_m << offset[m]

the non-zero stream is sorted once by that packed value, and any mode's
coordinate is recovered with a shift and a mask.  The **sort mode** owns the
most significant field, so the sorted stream is ordered by its output row
and is tile-aligned and block-padded like a CSF replica; every other mode
decodes its coordinates and scatter-adds.  Fields are ``max(1,
ceil(log2(dim)))`` bits wide, at most :data:`FIELD_BITS` each and
:data:`PACK_BITS` in all (``check_bit_budget``).

The packed stream is stored as two 32-bit words, ``hi`` and ``lo``.  They
are ``int32`` tensors holding the uint32 bits (PyTorch on the CPU has no
shifts on ``uint32``), so :func:`decode_field` masks every arithmetic
right shift before combining words; the CUDA kernel
(``kernels/csrc/linearized.cu``) reads the same storage as ``uint32``.

The build is host-side numpy with one stable argsort (the paper's "Sort"
stage, once for all modes); the finished arrays move to the tensor's
device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .coo import SparseTensor
from .csf import DEFAULT_BLOCK, DEFAULT_ROW_TILE

# Total bit budget of the packed index (stored as two 32-bit words).
PACK_BITS = 64
# Per-field budget: a field must decode with 32-bit operations.
FIELD_BITS = 32
# The mode whose field is most significant: the stream is sorted (and
# tile-aligned) by this mode's output row, so it gets the no-lock schedule.
DEFAULT_SORT_MODE = 0


def bit_widths(dims) -> tuple[int, ...]:
    """Per-mode field width: bits needed for the largest index (dim - 1),
    at least 1 so every mode owns a field even at dim == 1."""
    return tuple(max(1, int(int(d) - 1).bit_length()) for d in dims)


def check_bit_budget(dims) -> tuple[int, ...]:
    """Validate that ``dims`` fit the packed layout; returns the widths.

    Raises ``ValueError`` when the fields exceed :data:`PACK_BITS` total
    bits or any single field exceeds :data:`FIELD_BITS`."""
    widths = bit_widths(dims)
    total = sum(widths)
    if total > PACK_BITS:
        raise ValueError(
            f"dims {tuple(dims)} need {total} packed bits "
            f"({'+'.join(str(w) for w in widths)}), over the {PACK_BITS}-bit "
            "linearized-index budget")
    if max(widths) > FIELD_BITS:
        raise ValueError(
            f"dims {tuple(dims)} need a {max(widths)}-bit field, over the "
            f"{FIELD_BITS}-bit per-mode decode budget")
    return widths


def field_offsets(dims, sort_mode: int = DEFAULT_SORT_MODE
                  ) -> tuple[int, ...]:
    """Bit offset of each mode's field inside the packed index: the sort
    mode is most significant, the remaining modes fill the lower fields in
    ascending mode order."""
    widths = bit_widths(dims)
    offsets = [0] * len(widths)
    shift = sum(widths)
    for m in (sort_mode, *(m for m in range(len(widths)) if m != sort_mode)):
        shift -= widths[m]
        offsets[m] = shift
    return tuple(offsets)


def linearize_coords(inds: np.ndarray, dims,
                     sort_mode: int = DEFAULT_SORT_MODE) -> np.ndarray:
    """Pack an (n, order) int coordinate array into (n,) uint64 (host-side)."""
    check_bit_budget(dims)
    offsets = field_offsets(dims, sort_mode)
    inds = np.asarray(inds).astype(np.uint64)
    lin = np.zeros(inds.shape[0], dtype=np.uint64)
    for m, off in enumerate(offsets):
        lin |= inds[:, m] << np.uint64(off)
    return lin


def delinearize_coords(lin: np.ndarray, dims,
                       sort_mode: int = DEFAULT_SORT_MODE) -> np.ndarray:
    """Inverse of :func:`linearize_coords`: (n,) uint64 -> (n, order) int64."""
    widths = check_bit_budget(dims)
    offsets = field_offsets(dims, sort_mode)
    lin = np.asarray(lin, dtype=np.uint64)
    out = np.empty((lin.shape[0], len(widths)), dtype=np.int64)
    for m, (off, w) in enumerate(zip(offsets, widths)):
        mask = np.uint64((1 << w) - 1)
        out[:, m] = ((lin >> np.uint64(off)) & mask).astype(np.int64)
    return out


def decode_field(hi: torch.Tensor, lo: torch.Tensor, offset: int,
                 width: int) -> torch.Tensor:
    """Extract one static (offset, width) bit field from the int32 hi/lo
    word pair, as int32 (the reference's uint32 result, bit for bit).

    The words are int32, so ``>>`` sign-extends: every shifted word is
    masked to its field before it is combined.  A 32-bit-wide mask is -1."""
    mask = (1 << width) - 1 if width < 32 else -1
    if offset >= 32:
        return (hi >> (offset - 32)) & mask
    if offset + width <= 32:
        return (lo >> offset) & mask
    # the field straddles the 32-bit boundary: low part from lo, rest from hi
    low = (lo >> offset) & ((1 << (32 - offset)) - 1)
    return (low | (hi << (32 - offset))) & mask


@dataclasses.dataclass(frozen=True, eq=False)
class Linearized:
    """The mode-agnostic linearized workspace (one per tensor, not per mode).

    hi/lo:      (pnnz,) int32 holding the uint32 high/low words of the
                packed 64-bit index, sorted ascending as unsigned values
                (== sorted by the sort mode's output row), tile-aligned and
                block-padded for that mode like a CSF.
    vals:       (pnnz,) values, 0 for padding (padding packs the tile's last
                real sort-mode row with every other field 0).
    block_tile: (pnnz/block,) int32 non-decreasing block -> sort-mode output
                tile map.
    """

    hi: torch.Tensor
    lo: torch.Tensor
    vals: torch.Tensor
    block_tile: torch.Tensor
    dims: tuple[int, ...]
    nnz: int
    block: int
    row_tile: int
    sort_mode: int = DEFAULT_SORT_MODE

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def order(self) -> int:
        return len(self.dims)

    @property
    def widths(self) -> tuple[int, ...]:
        return bit_widths(self.dims)

    @property
    def offsets(self) -> tuple[int, ...]:
        return field_offsets(self.dims, self.sort_mode)

    @property
    def num_rows(self) -> int:
        return self.dims[self.sort_mode]

    @property
    def num_row_tiles(self) -> int:
        return -(-self.dims[self.sort_mode] // self.row_tile)

    @property
    def padded_nnz(self) -> int:
        return int(self.vals.shape[0])

    @property
    def num_blocks(self) -> int:
        return self.padded_nnz // self.block

    @property
    def padding_overhead(self) -> float:
        return 1.0 - self.nnz / max(1, self.padded_nnz)

    def decode(self, mode: int) -> torch.Tensor:
        """The mode's (pnnz,) int32 coordinates, two shifts and a mask away."""
        return decode_field(self.hi, self.lo, self.offsets[mode],
                            self.widths[mode])


def build_linearized(
    t: SparseTensor,
    *,
    block: int = DEFAULT_BLOCK,
    row_tile: int = DEFAULT_ROW_TILE,
    sort_mode: int = DEFAULT_SORT_MODE,
) -> Linearized:
    """Pack, sort once, tile-align and pad: the whole-tensor analogue of
    ``build_csf`` that every mode shares.

    Padding entries pack the tile's last real sort-mode row (the tile's
    first row when it is empty) with every other field 0 and value 0: they
    decode to in-range coordinates, add exact zeros on every mode, and keep
    the packed stream globally non-decreasing."""
    order = t.order
    if not 0 <= sort_mode < order:
        raise ValueError(
            f"sort_mode {sort_mode} out of range for order-{order} tensor")
    check_bit_budget(t.dims)
    offsets = field_offsets(t.dims, sort_mode)

    inds = t.inds[: t.nnz].cpu().numpy()
    in_vals = t.vals[: t.nnz].cpu().numpy()
    lin = linearize_coords(inds, t.dims, sort_mode)
    perm = np.argsort(lin, kind="stable")
    lin = lin[perm]
    v = in_vals[perm]
    rows = inds[perm, sort_mode].astype(np.int64)

    # tile-align + block-pad against the sort mode's row tiles (the same
    # counts -> blocks -> scatter scheme as csf._finalize)
    n = int(v.shape[0])
    n_tiles = -(-t.dims[sort_mode] // row_tile)
    tile_of = rows // row_tile
    counts = np.bincount(tile_of, minlength=n_tiles)
    blocks_per = np.maximum(1, -(-counts // block))
    tile_widths = blocks_per * block
    offs = np.concatenate([[0], np.cumsum(tile_widths)])[:-1]
    starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
    pnnz = int(tile_widths.sum())

    tile_ids = np.arange(n_tiles, dtype=np.int64)
    pad_row = tile_ids * row_tile
    if n:
        nz = counts > 0
        pad_row[nz] = rows[(starts + counts - 1)[nz]]
    out_lin = np.repeat(
        pad_row.astype(np.uint64) << np.uint64(offsets[sort_mode]),
        tile_widths)
    out_vals = np.zeros(pnnz, dtype=in_vals.dtype)
    if n:
        pos = offs[tile_of] + (np.arange(n) - starts[tile_of])
        out_lin[pos] = lin
        out_vals[pos] = v
    block_tile = np.repeat(tile_ids.astype(np.int32), blocks_per)

    def words(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a.astype(np.uint32).view(np.int32)).to(
            t.device)

    return Linearized(
        hi=words(out_lin >> np.uint64(32)),
        lo=words(out_lin & np.uint64(0xFFFFFFFF)),
        vals=torch.from_numpy(out_vals).to(t.device),
        block_tile=torch.from_numpy(block_tile).to(t.device),
        dims=t.dims,
        nnz=t.nnz,
        block=block,
        row_tile=row_tile,
        sort_mode=sort_mode,
    )
