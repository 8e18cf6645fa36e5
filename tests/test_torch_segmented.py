"""The row-segmented kernel body (``csrc/segmented.cuh``) of K1 and K3,
checked where the CPU can reach it.

The kernel itself has no CPU mode.  What it relies on is checked here:
the launch geometries cover every stored entry and every output column;
its decode of the packed words (a 64-bit shift and mask), over the fields
the wrapper hands it for any target mode, gives the workspace's
coordinates, on a field that straddles the two words too; and over a
sorted stream (the CSF, or the linearized workspace's sort mode) the rows
never decrease, padding included, so that a row which starts and ends
inside a warp's range lies in no other range and its plain store races
with nothing.  Numpy models of the two flush policies (a plain store of
the rows a range owns; every run added with atomics on the workspace's
other modes) then sum to the plain versions.  This file imports no JAX.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.core import build_csf, build_linearized, random_sparse
from repro_torch.core import init_factors
from repro_torch.kernels import linearized_cuda, mttkrp_cuda, ref

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


def _stream(t, mode, kind, sort_mode=None):
    """The kernel's view of a workspace on ``mode``: rows, the other modes'
    ids (ascending mode order) and values, padding included, each as the
    kernel reads or decodes it, with the plain version's function.  The
    linearized workspace is sorted by ``sort_mode`` (``mode`` when None)
    and decoded over the fields the wrapper hands the kernel."""
    block, row_tile = 512, 128
    if kind == "csf":
        csf = build_csf(t, mode, block=block, row_tile=row_tile)
        ids = [csf.other_ids[:, i].numpy().astype(np.int64)
               for i in range(t.order - 1)]
        return (csf.row_ids.numpy().astype(np.int64), ids,
                csf.vals.double().numpy(), csf.num_rows, csf,
                lambda f: ref.mttkrp_ref(csf, f),
                lambda f: ref.ttmc_ref(csf, f))
    lin = build_linearized(t, block=block, row_tile=row_tile,
                           sort_mode=mode if sort_mode is None else sort_mode)
    word = _words(lin)
    row, _, fields = linearized_cuda.stream_fields(lin, mode)
    rows, *ids = [_kernel_decode(word, *f) for f in (row, *fields)]
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


# ---------------------------------------------------------------------------
# the linearized workspace's other modes: the unsorted stream, atomic flush
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sort_mode,target,where", [
    (0, 1, "lo"), (0, 2, "lo"), (1, 0, "straddles"), (1, 2, "lo"),
    (2, 0, "lo"), (2, 1, "lo"),
    # the sort modes' own rows
    (0, 0, "straddles"), (1, 1, "hi"), (2, 2, "straddles"),
])
def test_stream_fields_decode_every_target(sort_mode, target, where):
    """The fields the wrapper hands the kernel for any target mode (the
    row, then the other modes in ascending order, the sort mode among them
    off the sort mode), decoded as the kernel decodes them, give the
    workspace's decoder; at yelp's dims sort mode 1 puts mode 0 at bits
    17..32, across the words."""
    t = random_sparse(YELP, 20_000, 35, skew=1.5, device="cpu")
    lin = build_linearized(t, sort_mode=sort_mode)
    row, other, fields = linearized_cuda.stream_fields(lin, target)
    assert other == tuple(m for m in range(3) if m != target)
    word = _words(lin)
    np.testing.assert_array_equal(_kernel_decode(word, *row),
                                  lin.decode(target).numpy())
    for m, f in zip(other, fields):
        np.testing.assert_array_equal(_kernel_decode(word, *f),
                                      lin.decode(m).numpy())
    off, width = row
    assert where == ("hi" if off >= 32 else
                     "straddles" if off + width > 32 else "lo")


def _unsorted_schedule(rows, contrib, num_rows, segment):
    """The off-sort kernel's schedule in numpy: each warp range of
    ``segment`` entries sums its runs of equal rows in registers and adds
    every run to the output (the atomic flush), in any order; returns the
    output and the number of runs."""
    out = np.zeros((num_rows, contrib.shape[1]))
    runs = 0
    for s in range(0, rows.shape[0], segment):
        r = rows[s:s + segment]
        starts = np.flatnonzero(np.r_[True, r[1:] != r[:-1]])
        np.add.at(out, r[starts],
                  np.add.reduceat(contrib[s:s + segment], starts))
        runs += starts.shape[0]
    return out, runs


def _contrib(vals, ids, others, mapping):
    """Each stored entry's row of the product: Hadamard (MTTKRP) or
    Kronecker in ascending mode order (TTMc), float64."""
    contrib = vals[:, None]
    for i, a in zip(ids, others):
        if mapping == "kronecker":
            contrib = (contrib[:, :, None] * a[i][:, None, :]).reshape(
                contrib.shape[0], -1)
        else:
            contrib = contrib * a[i]
    return contrib


@pytest.mark.parametrize("mapping", ["khatri_rao", "kronecker"])
@pytest.mark.parametrize("kind", ["hot", "hot-empty", "skew"])
@pytest.mark.parametrize("sort_mode,target", [(0, 1), (0, 2), (1, 0),
                                              (1, 2)])
def test_unsorted_schedule_on_the_off_sort_modes(sort_mode, target, kind,
                                                 mapping):
    """Every off-sort mode of sort modes 0 and 1: hot rows, all-padding
    blocks, and yelp's dims at skew 2.0, where a hot coordinate recurs in
    many warp ranges.  The target's rows are not sorted, so a sorted flush
    would be wrong; adding every run gives the plain MTTKRP and TTMc (the
    Kronecker columns over the other modes, the sort mode among them)."""
    t = (random_sparse(YELP, 30_000, 36, skew=2.0, device="cpu")
         if kind == "skew" else
         hot_yelp_tensor(empty_tiles=kind == "hot-empty"))
    rows, ids, vals, num_rows, lin, plain_mttkrp, plain_ttmc = _stream(
        t, target, "lin", sort_mode=sort_mode)
    assert lin.sort_mode == sort_mode and num_rows == YELP[target]
    assert (np.diff(rows) < 0).any()
    segment = mttkrp_cuda.SEGMENT
    if kind == "skew":  # a hot coordinate over several warp ranges
        hot = np.bincount(rows[vals != 0]).argmax()
        assert np.unique(np.flatnonzero(rows == hot) // segment).size > 2
    if kind == "hot-empty":  # row tile 1 of the sort mode: one padding block
        pad = lin.block_tile.numpy() == 1
        assert pad.sum() == 1
        assert (vals.reshape(-1, lin.block)[pad] == 0).all()
    ranks = (5, 3, 4) if mapping == "kronecker" else (6, 6, 6)
    f = _factors(t.dims, ranks, 37)
    others = [f[m].double().numpy() for m in range(3) if m != target]
    got, runs = _unsorted_schedule(rows, _contrib(vals, ids, others, mapping),
                                   num_rows, segment)
    # runs of equal rows merge in registers; the padding is one run a tile
    assert runs <= rows.shape[0]
    want = plain_ttmc(f) if mapping == "kronecker" else plain_mttkrp(f)
    assert got.shape == tuple(want.shape)
    np.testing.assert_allclose(got, want.double().numpy(), rtol=1e-5,
                               atol=1e-5)


def test_unsorted_runs_merge_fibers_and_padding():
    """Sort mode 0 orders mode 1 inside each mode-0 fiber, so a fiber's
    entries of one mode-1 row are adjacent and merge into one run; the
    padding decodes to row 0 of every other mode and is one run a stretch.
    So the atomic flushes are at most the distinct (mode 0, mode 1) pairs,
    the padding stretches and one split a warp range, fewer than the stored
    entries."""
    t = hot_yelp_tensor(empty_tiles=True)
    rows, ids, vals, _, lin, _, _ = _stream(t, 1, "lin", sort_mode=0)
    fiber, real = ids[0], vals != 0  # mode 0, the sort mode; padding is 0
    inside = (fiber[1:] == fiber[:-1]) & real[1:] & real[:-1]
    assert (np.diff(rows)[inside] >= 0).all()
    assert all((i[~real] == 0).all() for i in (rows, *ids[1:]))
    segment = mttkrp_cuda.SEGMENT
    _, runs = _unsorted_schedule(rows, np.ones((rows.shape[0], 1)), YELP[1],
                                 segment)
    pairs = np.unique(np.stack([fiber[real], rows[real]]), axis=1).shape[1]
    stretches = np.count_nonzero(np.diff(np.r_[0, (~real).astype(int)]) == 1)
    assert pairs < real.sum()  # duplicate rows inside a fiber merged
    assert runs <= pairs + stretches + -(-rows.shape[0] // segment)
    assert runs < t.nnz


@pytest.mark.parametrize("wrapper", ["mttkrp_off_sort", "ttmc_off_sort"])
def test_off_sort_wrappers_refuse_cpu_tensors_and_the_sort_mode(wrapper):
    t = random_sparse((30, 20, 10), 300, 0, device="cpu")
    f = init_factors(t.dims, 4, 1, device="cpu")
    lin = build_linearized(t, sort_mode=1)
    fn = getattr(linearized_cuda, wrapper)
    before = fn.launches
    for mode in (0, 2):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(lin, f, mode)
    with pytest.raises(ValueError, match="is the workspace's sort mode"):
        fn(lin, f, 1)
    with pytest.raises(ValueError, match="outside 0..2"):
        fn(lin, f, 3)
    assert fn.launches == before
