"""The row-segmented kernel body (``csrc/segmented.cuh``) of K1 and K3-TTMc,
checked where the CPU can reach it.

The kernel itself has no CPU mode.  What it relies on is checked here:
the launch geometries cover every stored entry and every output column;
its decode of the packed words (a 64-bit shift and mask) gives the
workspace's coordinates, on a row field that straddles the two words too;
and over either stream (the CSF, or the linearized workspace's sort mode)
the rows never decrease, padding included, so that a row which starts and
ends inside a warp's range lies in no other range and its plain store races
with nothing.  A numpy model of the schedule then sums to the plain
versions.  This file imports no JAX.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.core import build_csf, build_linearized, random_sparse
from repro_torch.kernels import mttkrp_cuda, ref

from torch_yelp_cases import YELP, hot_yelp_tensor

LANES = mttkrp_cuda.LANES


# ---------------------------------------------------------------------------
# K1-MTTKRP's launch: lane l of slice y owns columns 32 K y + l + 32 k
# ---------------------------------------------------------------------------

# (rank, K, slices)
MTTKRP_GEOMETRY_CASES = [
    (3, 1, 1), (8, 1, 1), (35, 2, 1), (64, 2, 1), (128, 4, 1), (150, 8, 1),
    (256, 8, 1),
    # past the widest K: slices of 256 columns
    (257, 8, 2), (300, 8, 2), (1000, 8, 4),
]


@pytest.mark.parametrize("rank,k,slices", MTTKRP_GEOMETRY_CASES)
def test_mttkrp_geometry_columns_and_slices(rank, k, slices):
    geo = mttkrp_cuda.mttkrp_geometry(7_998_976, rank)
    assert (geo.cols_per_lane, geo.slices) == (k, slices)
    assert k in mttkrp_cuda.MTTKRP_COLS
    # the columns of every (slice, lane, k): each of the rank's columns
    # owned once, and no slice without one
    cols = np.array([[y * LANES * k + lane + LANES * j
                      for j in range(k) for lane in range(LANES)]
                     for y in range(slices)])
    owned = cols[cols < rank]
    assert np.array_equal(np.sort(owned), np.arange(rank))
    assert all((c < rank).any() for c in cols)
    # the least K of the set that covers the rank in one slice
    smaller = [c for c in mttkrp_cuda.MTTKRP_COLS if c < k]
    assert not smaller or LANES * max(smaller) < rank


@pytest.mark.parametrize("pnnz", [0, 1, 31, 511, 512, 513, 4095, 4096,
                                  4097, 40_960, 8_017_920, 8_078_848,
                                  8_153_088, 2**31 - 512])
def test_mttkrp_geometry_covers_every_entry(pnnz):
    """Every stored entry in some warp's range, no CTA without one, and the
    same ranges as the TTMc launch's (yelp's padded entry counts among
    them)."""
    geo = mttkrp_cuda.mttkrp_geometry(pnnz, 35)
    seg = geo.segment
    assert seg == mttkrp_cuda.SEGMENT and seg % LANES == 0
    assert geo.ctas >= 1 and geo.warps * seg >= pnnz
    assert (geo.warps - mttkrp_cuda.WARPS) * seg < max(pnnz, 1)
    assert geo.ctas == mttkrp_cuda.ttmc_geometry(pnnz, (16, 16)).ctas


@pytest.mark.parametrize("call", [
    lambda: mttkrp_cuda.mttkrp_geometry(100, 0),
    lambda: mttkrp_cuda.mttkrp_geometry(-1, 35),
    lambda: mttkrp_cuda.ttmc_geometry(-1, (16, 16)),
])
def test_geometries_refuse_empty_launches(call):
    with pytest.raises(ValueError, match="no (MTTKRP|TTMc) launch"):
        call()


# ---------------------------------------------------------------------------
# the streams the kernel walks, in numpy
# ---------------------------------------------------------------------------

def _words(lin):
    """The packed index as (pnnz,) uint64: the int32 words hold uint32
    bits."""
    hi = lin.hi.numpy().view(np.uint32).astype(np.uint64)
    lo = lin.lo.numpy().view(np.uint32).astype(np.uint64)
    return (hi << np.uint64(32)) | lo


def _kernel_decode(word, offset, width):
    """segmented.cuh::decode_field: the 64-bit word shifted and masked."""
    mask = np.uint64((1 << width) - 1)
    return ((word >> np.uint64(offset)) & mask).astype(np.int64)


@pytest.mark.parametrize("sort_mode,where", [(0, "straddles"), (1, "hi"),
                                             (2, "straddles")])
def test_lin_stream_decode_matches_the_workspace(sort_mode, where):
    t = random_sparse(YELP, 20_000, 30, skew=1.5, device="cpu")
    lin = build_linearized(t, sort_mode=sort_mode)
    word = _words(lin)
    for m in range(t.order):
        got = _kernel_decode(word, lin.offsets[m], lin.widths[m])
        np.testing.assert_array_equal(got, lin.decode(m).numpy())
    off, width = lin.offsets[sort_mode], lin.widths[sort_mode]
    assert where == ("hi" if off >= 32 else
                     "straddles" if off + width > 32 else "lo")


def _stream(t, mode, kind):
    """The kernel's view of a workspace on ``mode``: rows, the other modes'
    ids (ascending mode order) and values, padding included, each as the
    kernel reads or decodes it, with the plain version's function."""
    block, row_tile = 512, 128
    if kind == "csf":
        csf = build_csf(t, mode, block=block, row_tile=row_tile)
        ids = [csf.other_ids[:, i].numpy().astype(np.int64)
               for i in range(t.order - 1)]
        return (csf.row_ids.numpy().astype(np.int64), ids,
                csf.vals.double().numpy(), csf.num_rows, csf,
                lambda f: ref.mttkrp_ref(csf, f),
                lambda f: ref.ttmc_ref(csf, f))
    lin = build_linearized(t, block=block, row_tile=row_tile, sort_mode=mode)
    word = _words(lin)
    rows, *ids = [_kernel_decode(word, lin.offsets[m], lin.widths[m])
                  for m in (mode, *(m for m in range(t.order) if m != mode))]
    return (rows, ids, lin.vals.double().numpy(), t.dims[mode], lin,
            lambda f: ref.mttkrp_lin_ref(lin, f, mode),
            lambda f: ref.ttmc_lin_ref(lin, f, mode))


def _segment_schedule(rows, contrib, num_rows, segment):
    """The kernel's schedule in numpy: each warp range of ``segment``
    entries sums its runs of equal rows, stores a row that starts and ends
    inside it, and adds its first and last rows.  Asserts that the rows
    never decrease and that a stored row is touched by no other range;
    returns the output."""
    assert (np.diff(rows) >= 0).all()
    out = np.zeros((num_rows, contrib.shape[1]))
    touched = np.zeros(num_rows, dtype=np.int64)
    stored = []
    for s in range(0, rows.shape[0], segment):
        r = rows[s:s + segment]
        starts = np.flatnonzero(np.r_[True, r[1:] != r[:-1]])
        sums = np.add.reduceat(contrib[s:s + segment], starts)
        touched[r[starts]] += 1
        for i, (row, v) in enumerate(zip(r[starts], sums)):
            if row == r[0] or i == starts.shape[0] - 1:
                out[row] += v
            else:
                out[row] = v
                stored.append(row)
    assert stored and (touched[stored] == 1).all()
    return out


def _factors(dims, ranks, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.uniform(0.0, 1.0, (d, r))
                                  .astype(np.float32))
                 for d, r in zip(dims, ranks))


@pytest.mark.parametrize("segment", [32, 512])
@pytest.mark.parametrize("mapping", ["khatri_rao", "kronecker"])
@pytest.mark.parametrize("kind", ["csf", "lin"])
@pytest.mark.parametrize("mode", [0, 1])
@pytest.mark.parametrize("empty_tiles", [False, True])
def test_row_segmented_schedule_over_both_streams(empty_tiles, mode, kind,
                                                  mapping, segment):
    """Sort modes 0 (its row field straddles the words) and 1 (the high
    word), hot rows over several warp ranges, all-padding blocks: the rows
    never decrease and the schedule's stores and adds give the plain
    MTTKRP (every column of the rank) and TTMc (the Kronecker row)."""
    t = hot_yelp_tensor(empty_tiles=empty_tiles)
    rows, ids, vals, num_rows, ws, plain_mttkrp, plain_ttmc = _stream(
        t, mode, kind)
    if empty_tiles:  # row tile 1 is one block of padding, value 0
        pad = ws.block_tile.numpy() == 1
        assert pad.sum() == 1
        assert (vals.reshape(-1, ws.block)[pad] == 0).all()
    ranks = (5, 3, 4) if mapping == "kronecker" else (6, 6, 6)
    f = _factors(t.dims, ranks, 32)
    others = [f[m].double().numpy() for m in range(t.order) if m != mode]
    contrib = vals[:, None]
    for i, a in zip(ids, others):
        if mapping == "kronecker":
            contrib = (contrib[:, :, None] * a[i][:, None, :]).reshape(
                contrib.shape[0], -1)
        else:
            contrib = contrib * a[i]
    got = _segment_schedule(rows, contrib, num_rows, segment)
    want = plain_ttmc(f) if mapping == "kronecker" else plain_mttkrp(f)
    assert got.shape[1] == (math.prod(ranks[m] for m in range(3) if m != mode)
                            if mapping == "kronecker" else ranks[0])
    np.testing.assert_allclose(got, want.double().numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("mode", [0, 1])
def test_row_segmented_schedule_on_skewed_packed_streams(mode):
    """yelp's dims at skew 2.0: the hottest row holds more entries than
    one warp's range."""
    t = random_sparse(YELP, 30_000, 33, skew=2.0, device="cpu")
    rows, ids, vals, num_rows, lin, _, plain_ttmc = _stream(t, mode, "lin")
    assert np.bincount(rows[vals != 0]).max() > mttkrp_cuda.SEGMENT
    f = _factors(t.dims, (4, 4, 4), 34)
    others = [f[m].double().numpy() for m in range(t.order) if m != mode]
    contrib = vals[:, None]
    for i, a in zip(ids, others):
        contrib = (contrib[:, :, None] * a[i][:, None, :]).reshape(
            contrib.shape[0], -1)
    got = _segment_schedule(rows, contrib, num_rows, mttkrp_cuda.SEGMENT)
    np.testing.assert_allclose(got, plain_ttmc(f).double().numpy(),
                               rtol=1e-5, atol=1e-5)
