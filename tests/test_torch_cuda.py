"""The hand-written CUDA kernels and their wrappers.

The tests marked ``cuda`` hold each kernel to its plain version on the card
and skip where there is none (the kernels have no CPU mode).  The others
check, without a card, what the wrappers and the build promise.  This file
imports no JAX, so the card tests run on a machine without it:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import (SparseTensor, build_csf, build_linearized,
                              dedupe, init_factors, random_sparse)
from repro_torch.core import csf as csf_mod
from repro_torch.core import linearized as lin_mod
from repro_torch.core.coo import make_generator
from repro_torch.core.linearized import field_offsets
from repro_torch.ingest import ingest, write_tnsb
from repro_torch.kernels import (_build, linearized_cuda, mttkrp_cuda, ops,
                                 ref, sass_diff, syrk_cuda)
from repro_torch.methods import fit, make_state

from torch_yelp_cases import YELP, hot_yelp_tensor


def _tol(skew, dtype):
    if dtype == torch.bfloat16:
        return 5e-2
    return 5e-4 if skew else 2e-4


# ---------------------------------------------------------------------------
# the CUDA wrappers' contract, checkable without a card
# ---------------------------------------------------------------------------

def test_cuda_wrappers_refuse_cpu_tensors():
    t = random_sparse((30, 20, 10), 300, 0, device="cpu")
    f = init_factors(t.dims, 4, 1, device="cpu")
    before = (mttkrp_cuda.mttkrp.launches, syrk_cuda.syrk.launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        mttkrp_cuda.mttkrp(build_csf(t, 0), f)
    with pytest.raises(ValueError, match="CUDA tensors"):
        syrk_cuda.syrk(f[0])
    assert (mttkrp_cuda.mttkrp.launches, syrk_cuda.syrk.launches) == before


def test_linearized_wrapper_refuses_cpu_tensors_and_other_modes():
    t = random_sparse((30, 20, 10), 300, 0, device="cpu")
    f = init_factors(t.dims, 4, 1, device="cpu")
    lin = build_linearized(t, sort_mode=1)
    before = linearized_cuda.mttkrp.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        linearized_cuda.mttkrp(lin, f, 1)
    for mode in (0, 2):
        with pytest.raises(ValueError, match="sort mode 1 only"):
            linearized_cuda.mttkrp(lin, f, mode)
    assert linearized_cuda.mttkrp.launches == before


def test_ttmc_wrappers_refuse_cpu_tensors_and_other_modes():
    t = random_sparse((30, 20, 10), 300, 0, device="cpu")
    f = _ttmc_factors(t.dims, (2, 3, 4), 1, "cpu")
    lin = build_linearized(t, sort_mode=0)
    before = (mttkrp_cuda.ttmc.launches, linearized_cuda.ttmc.launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        mttkrp_cuda.ttmc(build_csf(t, 1), f)
    with pytest.raises(ValueError, match="CUDA tensors"):
        linearized_cuda.ttmc(lin, f, 0)
    with pytest.raises(ValueError, match="sort mode 0 only"):
        linearized_cuda.ttmc(lin, f, 2)
    assert (mttkrp_cuda.ttmc.launches,
            linearized_cuda.ttmc.launches) == before


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(("mttkrp",))


def test_build_paths_follow_sources():
    paths = {name: _build.lib_path(name) for name in _build.SOURCES}
    for name, path in paths.items():
        assert (_build.CSRC / f"{name}.cu").exists()
        assert path.parent == _build.BUILD_DIR
        assert path.name.startswith(name + "-") and path.suffix == ".so"
        assert path == _build.lib_path(name)  # stable for unchanged sources
    assert _build.BUILD_DIR.parts[-2:] == ("build", "kernels")


_SASS = """
        Function : _Z16segmented_kernelI9CsfStreamIfELi2EEvT_
        /*0000*/   LDC R1, c[0x0][0x28] ;   /* 0x00000a00ff017b82 */
        /*0010*/   EXIT ;                   /* 0x000000000000794d */
        Function : _Z3fooILi1EEvv
        /*0000*/   NOP ;                    /* 0x0000000000007918 */
"""


def test_sass_diff_pairs_kernels_across_a_new_template_argument():
    """A kernel whose template gained a ``true`` argument (``Lb1E``) pairs
    with its earlier build once the token is dropped; addresses and
    encodings are left out of the comparison."""
    old = sass_diff.parse_sass(_SASS)
    new = sass_diff.parse_sass(
        _SASS.replace("Li2EEvT_", "Li2ELb1EEvT_").replace("0x0000", "0x1111")
        .replace("NOP", "EXIT"), drop=("Lb1E",))
    assert old["_Z16segmented_kernelI9CsfStreamIfELi2EEvT_"] == [
        "LDC R1, c[0x0][0x28] ;", "EXIT ;"]
    shared, differ = sass_diff.compare(old, new)
    assert shared == sorted(old) and differ == ["_Z3fooILi1EEvv"]


# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------

def _ttmc_factors(dims, ranks, seed, device, dtype=torch.float32):
    """Uniform [0, 1) factors, each mode at its own rank."""
    g = make_generator(seed, torch.device(device))
    return tuple(torch.rand((d, r), generator=g, device=device).to(dtype)
                 for d, r in zip(dims, ranks))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


CARD_MTTKRP_CASES = (
    [((40, 30, 20), 800, 0, r, 128, 64, 0.0, torch.float32)
     # 300 > the CTA's 256 threads: the kernel's flat (n, r) loop
     for r in (3, 8, 35, 64, 128, 150, 300)]
    + [((100, 50, 25), 3000, 0, 16, b, rt, 0.0, torch.float32)
       for b, rt in ((64, 32), (512, 128))]
    + [((500, 11, 9), 900, m, 8, 128, 64, 0.0, torch.float32)
       for m in range(3)]
    + [((30, 20, 10), 4000, m, 8, 128, 64, 2.0, torch.float32)
       for m in range(3)]
    + [((20, 15, 12, 10), 900, m, 8, 128, 64, 0.0, torch.float32)
       for m in range(4)]
    + [((40, 30, 20), 700, 0, 8, 128, 64, 0.0, torch.bfloat16)]
)


@pytest.mark.cuda
@pytest.mark.parametrize("dims,nnz,mode,rank,block,row_tile,skew,dtype",
                         CARD_MTTKRP_CASES)
def test_mttkrp_kernel_matches_plain_on_card(cuda, dims, nnz, mode, rank,
                                             block, row_tile, skew, dtype):
    t = random_sparse(dims, nnz, 3, skew=skew, device=cuda)
    f = tuple(a.to(dtype) for a in init_factors(dims, rank, 4, device=cuda))
    csf = build_csf(t, mode, block=block, row_tile=row_tile)
    before = mttkrp_cuda.mttkrp.launches
    got = ops.mttkrp(csf, f)
    torch.cuda.synchronize()
    assert mttkrp_cuda.mttkrp.launches == before + 1
    assert got.dtype == dtype and got.shape == (dims[mode], rank)
    want = ref.mttkrp_ref(csf, f).to(dtype)
    tol = _tol(skew, dtype)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,rank,dtype",
                         [(r, k, torch.float32) for r, k in
                          ((100, 8), (512, 35), (1000, 64), (4096, 128),
                           (333, 150), (1000, 200),
                           # fewer rows than CTAs or than one tile; rank 1
                           (5, 35), (7, 1), (0, 3), (41_000, 1),
                           # the CP factor shapes; tiles that end ragged
                           (41_000, 35), (11_000, 35), (75_001, 150))]
                         + [(75_000, 35, torch.float32),
                            (300, 40, torch.bfloat16),
                            (41_000, 35, torch.bfloat16),
                            (1001, 150, torch.bfloat16)])
def test_syrk_kernel_matches_plain_on_card(cuda, rows, rank, dtype):
    g = torch.Generator(device=cuda).manual_seed(rows)
    a = (torch.randn((rows, rank), generator=g, device=cuda) * 0.1).to(dtype)
    before = syrk_cuda.syrk.launches
    got = ops.syrk(a)
    torch.cuda.synchronize()
    assert syrk_cuda.syrk.launches == before + 1
    tol = 5e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), ref.syrk_ref(a), rtol=tol,
                               atol=max(tol, 1e-3))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,rank", [(41_000, 35), (75_000, 35),
                                       (333, 150)])
def test_syrk_kernel_is_bitwise_repeatable_on_card(cuda, rows, rank):
    """The partials are summed in a fixed order, so two runs agree bit for
    bit, and the tickets are back at 0 after each."""
    g = torch.Generator(device=cuda).manual_seed(rank)
    a = torch.randn((rows, rank), generator=g, device=cuda)
    first = syrk_cuda.syrk(a)
    second = syrk_cuda.syrk(a)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert torch.equal(first, first.T)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    index = a.device.index
    assert not syrk_cuda._scratch(index, stream).tickets.any()


@pytest.mark.cuda
def test_syrk_kernel_reads_a_matrix_off_16_bytes_on_card(cuda):
    """A row slice of a wider buffer starts off 16 bytes: the tiles are
    staged with scalar loads then."""
    g = torch.Generator(device=cuda).manual_seed(3)
    base = torch.randn((5001, 35), generator=g, device=cuda)
    a = base[1:]
    assert a.is_contiguous() and a.data_ptr() % 16
    got = syrk_cuda.syrk(a)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref.syrk_ref(a), rtol=1e-4, atol=1e-3)


# (dims, nnz, sort_mode, rank, block, row_tile, skew, dtype)
CARD_LIN_CASES = (
    [((40, 30, 20), 800, 0, r, 128, 64, 0.0, torch.float32)
     for r in (3, 8, 35, 64, 128, 150)]
    + [((100, 50, 25), 3000, 0, 16, b, rt, 0.0, torch.float32)
       for b, rt in ((64, 32), (128, 64), (512, 128))]
    + [((30, 20, 10), 4000, m, 8, 128, 64, 2.0, torch.float32)
       for m in range(3)]
    + [((20, 15, 12, 10), 900, m, 8, 128, 64, 0.0, torch.float32)
       for m in range(4)]
    + [((40, 30, 20), 700, 0, 8, 128, 64, 0.0, torch.bfloat16)]
    # the sort field lies in lo only in every case above (at most 32 bits
    # in all); at yelp's dims it straddles the words for sort modes 0 and 2
    # (offsets (31, 17, 0) and (14, 0, 30)) and lies in hi only for sort
    # mode 1 ((17, 33, 0))
    + [((41_000, 11_000, 75_000), 20_000, m, 35, 512, 128, 1.5,
        torch.float32) for m in range(3)]
)


@pytest.mark.cuda
@pytest.mark.parametrize("dims,nnz,mode,rank,block,row_tile,skew,dtype",
                         CARD_LIN_CASES)
def test_linearized_kernel_matches_plain_on_card(cuda, dims, nnz, mode,
                                                 rank, block, row_tile, skew,
                                                 dtype):
    t = random_sparse(dims, nnz, 5, skew=skew, device=cuda)
    f = tuple(a.to(dtype) for a in init_factors(dims, rank, 6, device=cuda))
    lin = build_linearized(t, block=block, row_tile=row_tile, sort_mode=mode)
    before = linearized_cuda.mttkrp.launches
    got = ops.mttkrp_lin(lin, f, mode)
    torch.cuda.synchronize()
    assert linearized_cuda.mttkrp.launches == before + 1
    assert got.dtype == dtype and got.shape == (dims[mode], rank)
    want = ref.mttkrp_lin_ref(lin, f, mode).to(dtype)
    tol = _tol(skew, dtype)
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_linearized_kernel_with_empty_tiles_on_card(cuda):
    g = torch.Generator(device="cpu").manual_seed(7)
    rows = torch.cat([torch.randint(0, 40, (300,), generator=g),
                      torch.randint(160, 200, (300,), generator=g)])
    inds = torch.stack([rows, torch.randint(0, 7, (600,), generator=g),
                        torch.randint(0, 5, (600,), generator=g)], 1)
    t = dedupe(SparseTensor(inds, torch.rand(600, generator=g) + 0.1,
                            (200, 7, 5), 600, device=cuda))
    lin = build_linearized(t, block=32, row_tile=16)
    assert lin.num_blocks > lin.num_row_tiles  # the empty tiles' padding
    f = init_factors(t.dims, 12, 8, device=cuda)
    got = ops.mttkrp_lin(lin, f, 0)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref.mttkrp_lin_ref(lin, f, 0),
                               rtol=2e-4, atol=2e-4)
    assert field_offsets(t.dims, 0)[0] == 6  # the row field: bits [6, 14)


@pytest.mark.cuda
@pytest.mark.parametrize("rank,block,row_tile", [(35, 512, 128),
                                                 (500, 512, 128),
                                                 (1000, 64, 128)])
def test_mttkrp_kernel_slices_wide_ranks_on_card(cuda, rank, block,
                                                row_tile):
    """K1's MTTKRP at yelp's geometry, and at ranks past one slice of 256
    columns (32 lanes x 8), so the launch splits the rank over
    blockIdx.y."""
    t = random_sparse((300, 200, 100), 6000, 9, skew=1.5, device=cuda)
    f = init_factors(t.dims, rank, 10, device=cuda)
    csf = build_csf(t, 0, block=block, row_tile=row_tile)
    got = ops.mttkrp(csf, f)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref.mttkrp_ref(csf, f), rtol=5e-4,
                               atol=5e-4)


# (dims, nnz, mode, ranks, block, row_tile, skew, dtype)
CARD_TTMC_CASES = (
    [((40, 30, 20), 800, m, r, 512, 128, 0.0, torch.float32)
     for r in ((2, 3, 4), (8, 8, 8), (16, 16, 16), (24, 24, 24))
     for m in (0, 2)]
    + [((100, 50, 25), 3000, 1, (16, 16, 16), b, rt, 0.0, torch.float32)
       for b, rt in ((64, 32), (512, 128))]
    + [((30, 20, 10), 4000, m, (2, 3, 4), 128, 64, 2.0, torch.float32)
       for m in range(3)]
    + [((20, 15, 12, 10), 900, m, (2, 3, 2, 3), 128, 64, 0.0, torch.float32)
       for m in range(4)]
    + [((20, 15, 12, 10), 900, 0, (8, 8, 8, 8), 512, 128, 0.0,
        torch.float32)]
    + [((40, 30, 20), 700, 1, (16, 16, 16), 512, 128, 0.0, torch.bfloat16)]
)


def _check_ttmc(got, want, dims, mode, ranks, dtype, skew):
    width = math.prod(r for m, r in enumerate(ranks) if m != mode)
    assert got.dtype == dtype and got.shape == (dims[mode], width)
    tol = _tol(skew, dtype)
    torch.testing.assert_close(got.float(), want.to(dtype).float(),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dims,nnz,mode,ranks,block,row_tile,skew,dtype",
                         CARD_TTMC_CASES)
def test_ttmc_kernel_matches_plain_on_card(cuda, dims, nnz, mode, ranks,
                                           block, row_tile, skew, dtype):
    t = random_sparse(dims, nnz, 11, skew=skew, device=cuda)
    f = _ttmc_factors(dims, ranks, 12, cuda, dtype)
    csf = build_csf(t, mode, block=block, row_tile=row_tile)
    before = (mttkrp_cuda.ttmc.launches, mttkrp_cuda.mttkrp.launches)
    got = ops.ttmc(csf, f)
    torch.cuda.synchronize()
    assert (mttkrp_cuda.ttmc.launches,
            mttkrp_cuda.mttkrp.launches) == (before[0] + 1, before[1])
    _check_ttmc(got, ref.ttmc_ref(csf, f), dims, mode, ranks, dtype, skew)


# the K1 cases, and yelp's dims, where the sort field straddles the words
# (sort modes 0 and 2) or lies in the high word (sort mode 1)
CARD_TTMC_LIN_CASES = CARD_TTMC_CASES + [
    ((41_000, 11_000, 75_000), 20_000, m, (16, 16, 16), 512, 128, 1.5,
     torch.float32) for m in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize("dims,nnz,mode,ranks,block,row_tile,skew,dtype",
                         CARD_TTMC_LIN_CASES)
def test_ttmc_linearized_kernel_matches_plain_on_card(
        cuda, dims, nnz, mode, ranks, block, row_tile, skew, dtype):
    t = random_sparse(dims, nnz, 13, skew=skew, device=cuda)
    f = _ttmc_factors(dims, ranks, 14, cuda, dtype)
    lin = build_linearized(t, block=block, row_tile=row_tile, sort_mode=mode)
    before = (linearized_cuda.ttmc.launches, linearized_cuda.mttkrp.launches)
    got = ops.ttmc_lin(lin, f, mode)
    torch.cuda.synchronize()
    assert (linearized_cuda.ttmc.launches,
            linearized_cuda.mttkrp.launches) == (before[0] + 1, before[1])
    _check_ttmc(got, ref.ttmc_lin_ref(lin, f, mode), dims, mode, ranks,
                dtype, skew)


@pytest.mark.cuda
def test_ttmc_kernels_with_empty_tiles_on_card(cuda):
    g = torch.Generator(device="cpu").manual_seed(15)
    rows = torch.cat([torch.randint(0, 40, (300,), generator=g),
                      torch.randint(160, 200, (300,), generator=g)])
    inds = torch.stack([rows, torch.randint(0, 7, (600,), generator=g),
                        torch.randint(0, 5, (600,), generator=g)], 1)
    t = dedupe(SparseTensor(inds, torch.rand(600, generator=g) + 0.1,
                            (200, 7, 5), 600, device=cuda))
    csf = build_csf(t, 0, block=32, row_tile=16)
    lin = build_linearized(t, block=32, row_tile=16)
    assert lin.num_blocks > lin.num_row_tiles  # the empty tiles' padding
    f = _ttmc_factors(t.dims, (3, 5, 4), 16, cuda)
    got = ops.ttmc(csf, f)
    got_lin = ops.ttmc_lin(lin, f, 0)
    torch.cuda.synchronize()
    want = ref.ttmc_ref(csf, f)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(got_lin, ref.ttmc_lin_ref(lin, f, 0),
                               rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(got_lin, got, rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# the launch geometry of the redesigned K2 and K1-TTMc, checkable without a
# card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows", [0, 5, 100, 333, 4096, 11_000, 41_000,
                                  75_000, 75_001])
@pytest.mark.parametrize("rank", [1, 35, 150, 200])
def test_syrk_geometry_fits_and_covers(rows, rank):
    sms = 132
    geo = syrk_cuda.syrk_geometry(rows, rank, sms)
    nb = -(-rank // syrk_cuda.BLOCK)
    rp = nb * syrk_cuda.BLOCK
    assert geo.pairs == nb * (nb + 1) // 2
    # the tile fits the 48 KB the kernel may use without an opt-in
    assert 1 <= geo.tile_rows and geo.tile_rows * rp * 4 <= syrk_cuda.SMEM_BYTES
    assert geo.tile_rows % 8 == 0  # every tile starts on 16 bytes
    # at most one CTA a SM along the rows, none without a tile
    assert 1 <= geo.nparts <= max(1, min(sms, -(-rows // geo.tile_rows)))
    # every block pair in some slice, no slice empty
    t = syrk_cuda.THREADS
    assert geo.slices * t >= geo.pairs > (geo.slices - 1) * t
    # two levels of about sqrt(CTAs) partials each
    assert geo.group * geo.group >= geo.nparts > (geo.group - 1) ** 2
    assert geo.groups == -(-geo.nparts // geo.group)
    assert geo.groups * geo.group >= geo.nparts > (geo.groups - 1) * geo.group
    assert geo.partial_floats == (geo.nparts + geo.groups) * geo.pairs * 16
    assert geo.tickets == geo.groups + 1


@pytest.mark.parametrize("rows,tile_rows,nparts", [(41_000, 312, 132),
                                                   (11_000, 88, 125),
                                                   (75_000, 288, 132)])
def test_syrk_geometry_at_the_cp_factor_shapes(rows, tile_rows, nparts):
    """yelp's factors at R = 35: one CTA a SM, one or two tiles each, and
    45 block pairs (630 entries of G's triangle in 720 sums) in one slice;
    the partials summed in 11-12 groups of 12."""
    geo = syrk_cuda.syrk_geometry(rows, 35, 132)
    assert (geo.tile_rows, geo.nparts, geo.slices, geo.pairs, geo.group) == (
        tile_rows, nparts, 1, 45, 12)


def test_syrk_geometry_refuses_a_rank_past_the_tile():
    with pytest.raises(ValueError, match="too wide"):
        syrk_cuda.syrk_geometry(100, 12_289, 132)


# (other ranks, columns a lane, slices along the width)
TTMC_GEOMETRY_CASES = [
    ((16, 16), 8, 1),       # the Tucker cell: W = 256, 8 columns a lane
    ((3, 5), 1, 1),         # W = 15: lanes 15..31 idle
    ((5, 7, 3), 1, 4),      # W = 105: an odd last rank, one column a lane
    ((24, 24), 8, 3),       # W = 576 past 32 x 16 columns
    ((8, 8, 8), 8, 2),      # W = 512 at a last rank of 8
    ((16, 32), 16, 1),      # W = 512 at the cap
    ((10, 10, 12), 4, 10),  # W = 1200: 4 divides 12, 8 does not
    ((2, 3, 4), 1, 1),
    ((35,), 1, 2),
    ((64,), 2, 1),
]


@pytest.mark.parametrize("ranks,cpl,slices", TTMC_GEOMETRY_CASES)
def test_ttmc_geometry_columns_and_slices(ranks, cpl, slices):
    geo = mttkrp_cuda.ttmc_geometry(7_998_976, ranks)
    width = math.prod(ranks)
    assert (geo.cols_per_lane, geo.slices) == (cpl, slices)
    assert cpl <= mttkrp_cuda.MAX_COLS_PER_LANE and cpl & (cpl - 1) == 0
    assert ranks[-1] % cpl == 0  # a lane's run stays inside one digit
    lanes = mttkrp_cuda.LANES
    assert slices * lanes * cpl >= width > (slices - 1) * lanes * cpl


@pytest.mark.parametrize("pnnz", [0, 1, 31, 511, 512, 513, 4095, 4096,
                                  4097, 40_960, 8_017_920, 8_078_848,
                                  8_153_088, 2**31 - 512])
def test_ttmc_geometry_covers_every_entry(pnnz):
    """Every stored entry in some warp's range, and no CTA without one
    (yelp's padded entry counts among them)."""
    geo = mttkrp_cuda.ttmc_geometry(pnnz, (16, 16))
    seg = geo.segment
    assert seg == mttkrp_cuda.SEGMENT and seg % mttkrp_cuda.LANES == 0
    assert geo.ctas >= 1 and geo.warps * seg >= pnnz
    assert (geo.warps - mttkrp_cuda.WARPS) * seg < max(pnnz, 1)


def _kron_rows(csf, factors):
    """Each stored entry's Kronecker row, val * F_1[id_1] x F_2[id_2] x ...,
    the last factor fastest: (pnnz, W) float64."""
    prod = csf.vals.double()[:, None]
    for i, m in enumerate(csf.other_modes):
        f = factors[m].double()[csf.other_ids[:, i].long()]
        prod = (prod[:, :, None] * f[:, None, :]).reshape(prod.shape[0], -1)
    return prod.numpy()


def _row_segmented_model(csf, factors, segment):
    """The K1-TTMc kernel's schedule in numpy: each warp range sums its
    runs of equal rows, stores a row that starts and ends inside it, and
    adds its first and last rows.  Asserts that a stored row is touched by
    no other range; returns the output."""
    rows = csf.row_ids.numpy()
    contrib = _kron_rows(csf, factors)
    out = np.zeros((csf.num_rows, contrib.shape[1]))
    touched = np.zeros(csf.num_rows, dtype=np.int64)
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
    assert (touched[stored] == 1).all()
    return out


def _hot_row_tensor(device, *, hot=3000, dims=(300, 70, 70),
                    empty_tiles=False, seed=17):
    """Row 1 of mode 0 holds ``hot`` entries: more than two warp ranges and
    blocks of 512.  The other rows hold a thin spread; with ``empty_tiles``
    rows 128..255 hold nothing, so row tile 1 (at 128 rows) is one block of
    padding."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    cells = torch.randperm(dims[1] * dims[2], generator=g)[:hot]
    hot_inds = torch.stack([torch.ones(hot, dtype=torch.int64),
                            cells // dims[2], cells % dims[2]], 1)
    n = 2000
    rows = torch.randint(0, dims[0], (n,), generator=g)
    if empty_tiles:
        rows = torch.where((rows >= 128) & (rows < 256), rows % 128, rows)
    thin = torch.stack([rows, torch.randint(0, dims[1], (n,), generator=g),
                        torch.randint(0, dims[2], (n,), generator=g)], 1)
    inds = torch.cat([hot_inds, thin])
    vals = torch.rand(inds.shape[0], generator=g) + 0.1
    return dedupe(SparseTensor(inds, vals, dims, inds.shape[0],
                               device=device))


@pytest.mark.parametrize("segment", [32, 64, 512])
@pytest.mark.parametrize("empty_tiles", [False, True])
def test_row_segmented_schedule_owns_every_stored_row(segment, empty_tiles):
    """What the kernel relies on, on the CPU: over the padded CSF stream
    (padding included) a row that starts and ends inside a warp range lies
    in no other range, so its plain store races with nothing, and the
    stores and adds together give the plain TTMc."""
    t = _hot_row_tensor("cpu", empty_tiles=empty_tiles)
    csf = build_csf(t, 0, block=64, row_tile=128)
    if empty_tiles:
        tiles = csf.block_tile.numpy()
        assert (np.bincount(tiles) >= 1).all() and csf.num_row_tiles == 3
    f = _ttmc_factors(t.dims, (2, 3, 4), 18, "cpu")
    got = _row_segmented_model(csf, f, segment)
    np.testing.assert_allclose(got, ref.ttmc_ref(csf, f).double().numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_row_segmented_schedule_on_skewed_tensors(mode):
    t = random_sparse((30, 20, 10), 4000, 19, skew=2.0, device="cpu")
    csf = build_csf(t, mode, block=128, row_tile=64)
    f = _ttmc_factors(t.dims, (3, 4, 5), 20, "cpu")
    got = _row_segmented_model(csf, f, 32)
    np.testing.assert_allclose(got, ref.ttmc_ref(csf, f).double().numpy(),
                               rtol=1e-5, atol=1e-5)


# (ranks, mode, block, row_tile, empty tiles, dtype) on the hot-row tensor
CARD_TTMC_SEGMENT_CASES = [
    ((16, 16, 16), 0, 512, 128, False, torch.float32),
    ((16, 16, 16), 0, 64, 32, False, torch.float32),
    ((16, 16, 16), 0, 512, 128, True, torch.float32),
    ((16, 16, 16), 1, 512, 128, False, torch.float32),
    ((16, 16, 16), 2, 512, 128, True, torch.float32),
    ((4, 3, 5), 0, 512, 128, True, torch.float32),     # W = 15
    ((4, 24, 24), 0, 512, 128, False, torch.float32),  # W = 576, 3 slices
    ((4, 16, 32), 0, 512, 128, False, torch.float32),  # 16 columns a lane
    ((4, 16, 32), 0, 512, 128, True, torch.bfloat16),
    ((16, 16, 16), 0, 512, 128, True, torch.bfloat16),
    ((4, 4, 12), 0, 512, 128, False, torch.bfloat16),  # 2 columns a lane
]


@pytest.mark.cuda
@pytest.mark.parametrize("ranks,mode,block,row_tile,empty_tiles,dtype",
                         CARD_TTMC_SEGMENT_CASES)
def test_ttmc_kernel_row_segments_on_card(cuda, ranks, mode, block, row_tile,
                                          empty_tiles, dtype):
    """A hot row over more than two warp ranges and blocks, all-padding
    blocks, widths off 32 and past one slice, bfloat16."""
    t = _hot_row_tensor(cuda, empty_tiles=empty_tiles)
    f = _ttmc_factors(t.dims, ranks, 21, cuda, dtype)
    csf = build_csf(t, mode, block=block, row_tile=row_tile)
    before = mttkrp_cuda.ttmc.launches
    got = ops.ttmc(csf, f)
    torch.cuda.synchronize()
    assert mttkrp_cuda.ttmc.launches == before + 1
    _check_ttmc(got, ref.ttmc_ref(csf, f), t.dims, mode, ranks, dtype, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("ranks,mode", [((2, 5, 7, 3), 0),      # W = 105
                                        ((4, 10, 10, 12), 0),   # W = 1200
                                        ((8, 8, 8, 8), 1),      # W = 512
                                        ((5, 7, 3, 2), 3)])
def test_ttmc_kernel_order_four_widths_on_card(cuda, ranks, mode):
    t = random_sparse((20, 15, 12, 10), 2000, 22, skew=1.0, device=cuda)
    f = _ttmc_factors(t.dims, ranks, 23, cuda)
    csf = build_csf(t, mode, block=128, row_tile=64)
    got = ops.ttmc(csf, f)
    torch.cuda.synchronize()
    _check_ttmc(got, ref.ttmc_ref(csf, f), t.dims, mode, ranks,
                torch.float32, 1.0)


@pytest.mark.cuda
def test_ttmc_kernel_refuses_a_factor_off_16_bytes_on_card(cuda):
    t = random_sparse((30, 20, 10), 300, 24, device=cuda)
    f = list(_ttmc_factors(t.dims, (4, 4, 4), 25, cuda))
    f[2] = torch.rand(10 * 4 + 1, device=cuda)[1:].view(10, 4)
    before = mttkrp_cuda.ttmc.launches
    with pytest.raises(ValueError, match="16 bytes"):
        mttkrp_cuda.ttmc(build_csf(t, 0), f)
    assert mttkrp_cuda.ttmc.launches == before


# ---------------------------------------------------------------------------
# K3-TTMc and K1-MTTKRP on the row-segmented body (csrc/segmented.cuh)
# ---------------------------------------------------------------------------

def _segment_tensor(kind, device):
    """``hot``: yelp's dims, a hot row in modes 0 and 1 over several warp
    ranges; ``hot-empty``: the same with row tile 1 of modes 0 and 1 empty
    (one padding block); ``skew``: yelp's dims at skew 2.0."""
    if kind == "skew":
        return random_sparse(YELP, 30_000, 37, skew=2.0, device=device)
    return hot_yelp_tensor(device, empty_tiles=kind == "hot-empty")


# (tensor, sort mode, ranks, dtype): sort mode 0's row field straddles the
# two words at yelp's dims, sort mode 1's lies in the high word
CARD_TTMC_LIN_SEGMENT_CASES = [
    (kind, mode, (16, 16, 16), torch.float32)
    for kind in ("hot", "hot-empty", "skew") for mode in (0, 1)
] + [
    ("hot-empty", 0, (4, 3, 5), torch.float32),    # W = 15
    ("hot", 0, (4, 24, 24), torch.float32),        # W = 576, 3 slices
    ("hot", 1, (16, 4, 32), torch.float32),        # 16 columns a lane
    ("skew", 1, (5, 7, 3), torch.float32),         # W = 15, odd last rank
    ("hot-empty", 0, (16, 16, 16), torch.bfloat16),
    ("hot", 1, (4, 16, 32), torch.bfloat16),
    ("skew", 0, (4, 4, 12), torch.bfloat16),       # 2 columns a lane
]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,mode,ranks,dtype", CARD_TTMC_LIN_SEGMENT_CASES)
def test_ttmc_linearized_kernel_row_segments_on_card(cuda, kind, mode, ranks,
                                                     dtype):
    """K3-TTMc against its plain version and against K1-TTMc on the same
    mode's CSF: hot rows over several warp ranges, all-padding blocks,
    widths off 32 and past one slice, bfloat16."""
    t = _segment_tensor(kind, cuda)
    f = _ttmc_factors(t.dims, ranks, 38, cuda, dtype)
    lin = build_linearized(t, sort_mode=mode)
    before = linearized_cuda.ttmc.launches
    got = ops.ttmc_lin(lin, f, mode)
    k1 = ops.ttmc(build_csf(t, mode), f)
    torch.cuda.synchronize()
    assert linearized_cuda.ttmc.launches == before + 1
    _check_ttmc(got, ref.ttmc_lin_ref(lin, f, mode), t.dims, mode, ranks,
                dtype, 0.0)
    _check_ttmc(got, k1, t.dims, mode, ranks, dtype, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("ranks,mode", [((2, 5, 7, 3), 0),      # W = 105
                                        ((4, 10, 10, 12), 0),   # W = 1200
                                        ((8, 8, 8, 8), 1),      # W = 512
                                        ((5, 7, 3, 2), 3)])
def test_ttmc_linearized_kernel_order_four_widths_on_card(cuda, ranks, mode):
    t = random_sparse((20, 15, 12, 10), 2000, 39, skew=1.0, device=cuda)
    f = _ttmc_factors(t.dims, ranks, 40, cuda)
    lin = build_linearized(t, block=128, row_tile=64, sort_mode=mode)
    got = ops.ttmc_lin(lin, f, mode)
    k1 = ops.ttmc(build_csf(t, mode, block=128, row_tile=64), f)
    torch.cuda.synchronize()
    _check_ttmc(got, ref.ttmc_lin_ref(lin, f, mode), t.dims, mode, ranks,
                torch.float32, 1.0)
    _check_ttmc(got, k1, t.dims, mode, ranks, torch.float32, 1.0)


@pytest.mark.cuda
def test_ttmc_linearized_kernel_refuses_a_factor_off_16_bytes_on_card(cuda):
    t = random_sparse((30, 20, 10), 300, 41, device=cuda)
    f = list(_ttmc_factors(t.dims, (4, 4, 4), 42, cuda))
    f[2] = torch.rand(10 * 4 + 1, device=cuda)[1:].view(10, 4)
    before = linearized_cuda.ttmc.launches
    with pytest.raises(ValueError, match="16 bytes"):
        linearized_cuda.ttmc(build_linearized(t, sort_mode=0), f, 0)
    assert linearized_cuda.ttmc.launches == before


# (tensor, mode, rank, dtype)
CARD_MTTKRP_SEGMENT_CASES = (
    [("skew", 0, r, torch.float32) for r in (3, 8, 35, 64, 128, 150)]
    + [(kind, mode, 35, torch.float32)
       for kind in ("hot", "hot-empty") for mode in (0, 1, 2)]
    + [("skew", 1, 35, torch.float32), ("hot", 1, 300, torch.float32),
       ("hot-empty", 0, 35, torch.bfloat16),
       ("skew", 1, 150, torch.bfloat16)]
)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,mode,rank,dtype", CARD_MTTKRP_SEGMENT_CASES)
def test_mttkrp_kernel_row_segments_on_card(cuda, kind, mode, rank, dtype):
    """K1-MTTKRP's Khatri-Rao map (lane l owns columns l + 32 k): ranks off
    and past 32, hot rows over several warp ranges, all-padding blocks,
    two slices at 300, bfloat16."""
    t = _segment_tensor(kind, cuda)
    f = tuple(a.to(dtype) for a in init_factors(t.dims, rank, 43,
                                                device=cuda))
    csf = build_csf(t, mode)
    before = mttkrp_cuda.mttkrp.launches
    got = ops.mttkrp(csf, f)
    torch.cuda.synchronize()
    assert mttkrp_cuda.mttkrp.launches == before + 1
    assert got.dtype == dtype and got.shape == (t.dims[mode], rank)
    tol = _tol(0.0, dtype)
    torch.testing.assert_close(got.float(),
                               ref.mttkrp_ref(csf, f).to(dtype).float(),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("rank", [35, 150])
@pytest.mark.parametrize("mode", [0, 3])
def test_mttkrp_kernel_order_four_on_card(cuda, rank, mode):
    """Order 4 runs the kernel compiled for a run-time number of modes."""
    t = random_sparse((20, 15, 12, 10), 2000, 44, skew=1.0, device=cuda)
    f = init_factors(t.dims, rank, 45, device=cuda)
    csf = build_csf(t, mode, block=128, row_tile=64)
    got = ops.mttkrp(csf, f)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref.mttkrp_ref(csf, f), rtol=5e-4,
                               atol=5e-4)


# ---------------------------------------------------------------------------
# K3-MTTKRP on the row-segmented body, and the off-sort kernels of the
# linearized workspace (every run added with atomics)
# ---------------------------------------------------------------------------

def _check_mttkrp(got, want, dims, mode, rank, dtype):
    assert got.dtype == dtype and got.shape == (dims[mode], rank)
    tol = _tol(0.0, dtype)
    torch.testing.assert_close(got.float(), want.to(dtype).float(), rtol=tol,
                               atol=tol)


# (tensor, sort mode, rank, dtype)
CARD_MTTKRP_LIN_SEGMENT_CASES = (
    [(kind, mode, 35, torch.float32)
     for kind in ("hot", "hot-empty", "skew") for mode in (0, 1)]
    + [("skew", 0, r, torch.float32) for r in (3, 64, 150)]
    + [("hot", 1, 300, torch.float32),             # two slices of 256
       ("hot-empty", 0, 35, torch.bfloat16), ("skew", 1, 35, torch.bfloat16)]
)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,mode,rank,dtype", CARD_MTTKRP_LIN_SEGMENT_CASES)
def test_mttkrp_linearized_kernel_row_segments_on_card(cuda, kind, mode, rank,
                                                       dtype):
    """K3-MTTKRP (``LinStream`` x the Khatri-Rao map) on sort modes 0 (its
    row field straddles the words) and 1 (the high word), against its plain
    version and against K1-MTTKRP on the same mode's CSF."""
    t = _segment_tensor(kind, cuda)
    f = tuple(a.to(dtype) for a in init_factors(t.dims, rank, 46,
                                                device=cuda))
    lin = build_linearized(t, sort_mode=mode)
    before = (linearized_cuda.mttkrp.launches,
              linearized_cuda.mttkrp_off_sort.launches)
    got = ops.mttkrp_lin(lin, f, mode)
    k1 = ops.mttkrp(build_csf(t, mode), f)
    torch.cuda.synchronize()
    assert (linearized_cuda.mttkrp.launches,
            linearized_cuda.mttkrp_off_sort.launches) == (before[0] + 1,
                                                          before[1])
    _check_mttkrp(got, ref.mttkrp_lin_ref(lin, f, mode), t.dims, mode, rank,
                  dtype)
    _check_mttkrp(got, k1, t.dims, mode, rank, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("rank", [35, 150])
@pytest.mark.parametrize("mode", [0, 3])
def test_mttkrp_linearized_kernel_order_four_on_card(cuda, rank, mode):
    t = random_sparse((20, 15, 12, 10), 2000, 47, skew=1.0, device=cuda)
    f = init_factors(t.dims, rank, 48, device=cuda)
    lin = build_linearized(t, block=128, row_tile=64, sort_mode=mode)
    got = ops.mttkrp_lin(lin, f, mode)
    k1 = ops.mttkrp(build_csf(t, mode, block=128, row_tile=64), f)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref.mttkrp_lin_ref(lin, f, mode),
                               rtol=5e-4, atol=5e-4)
    torch.testing.assert_close(got, k1, rtol=5e-4, atol=5e-4)


# (tensor, sort mode, target mode): every off-sort mode of sort modes 0 and
# 1 (sort mode 1 puts mode 0 at bits 17..32, across the words)
OFF_SORT_MODES = [(0, 1), (0, 2), (1, 0), (1, 2)]
CARD_OFF_SORT_CASES = (
    [(kind, sm, tm, torch.float32) for kind in ("hot", "hot-empty", "skew")
     for sm, tm in OFF_SORT_MODES]
    + [(kind, sm, tm, torch.bfloat16) for kind in ("hot-empty", "skew")
       for sm, tm in OFF_SORT_MODES]
)


def _off_sort_call(kernel, lin, f, mode):
    """The entry point on an off-sort mode, with the launches it made of the
    sort-mode and the off-sort wrappers."""
    if kernel == "mttkrp":
        counted = (linearized_cuda.mttkrp, linearized_cuda.mttkrp_off_sort)
        call, plain = ops.mttkrp_lin, ref.mttkrp_lin_ref
    else:
        counted = (linearized_cuda.ttmc, linearized_cuda.ttmc_off_sort)
        call, plain = ops.ttmc_lin, ref.ttmc_lin_ref
    before = [fn.launches for fn in counted]
    got = call(lin, f, mode)
    torch.cuda.synchronize()
    made = tuple(fn.launches - b for fn, b in zip(counted, before))
    return got, made, plain(lin, f, mode)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["mttkrp", "ttmc"])
@pytest.mark.parametrize("kind,sort_mode,mode,dtype", CARD_OFF_SORT_CASES)
def test_off_sort_kernels_match_plain_on_card(cuda, kind, sort_mode, mode,
                                              dtype, kernel):
    """The off-sort MTTKRP (R = 35) and TTMc (W = 256) on every off-sort mode
    of sort modes 0 and 1, hot rows, all-padding blocks and skew 2.0,
    against the plain version and against K1 on that mode's CSF."""
    t = _segment_tensor(kind, cuda)
    if kernel == "mttkrp":
        f = tuple(a.to(dtype) for a in init_factors(t.dims, 35, 49,
                                                    device=cuda))
    else:
        f = _ttmc_factors(t.dims, (16, 16, 16), 49, cuda, dtype)
    lin = build_linearized(t, sort_mode=sort_mode)
    got, made, want = _off_sort_call(kernel, lin, f, mode)
    assert made == (0, 1)
    csf = build_csf(t, mode)
    k1 = ops.mttkrp(csf, f) if kernel == "mttkrp" else ops.ttmc(csf, f)
    torch.cuda.synchronize()
    if kernel == "mttkrp":
        _check_mttkrp(got, want, t.dims, mode, 35, dtype)
        _check_mttkrp(got, k1, t.dims, mode, 35, dtype)
    else:
        _check_ttmc(got, want, t.dims, mode, (16, 16, 16), dtype, 0.0)
        _check_ttmc(got, k1, t.dims, mode, (16, 16, 16), dtype, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,ranks", [
    ("mttkrp", (300, 300, 300)),     # two slices of 256 columns
    ("mttkrp", (3, 3, 3)),
    ("ttmc", (24, 24, 24)),          # W = 576 past 32 x 16 columns
    ("ttmc", (5, 7, 3)),             # an odd last rank, one column a lane
    ("ttmc", (4, 4, 12)),            # 2 columns a lane
])
@pytest.mark.parametrize("sort_mode,mode", OFF_SORT_MODES)
def test_off_sort_kernels_wide_and_narrow_on_card(cuda, kernel, ranks,
                                                  sort_mode, mode):
    t = _segment_tensor("hot-empty", cuda)
    if kernel == "mttkrp":
        f = init_factors(t.dims, ranks[0], 50, device=cuda)
    else:
        f = _ttmc_factors(t.dims, ranks, 50, cuda)
    lin = build_linearized(t, sort_mode=sort_mode)
    got, made, want = _off_sort_call(kernel, lin, f, mode)
    assert made == (0, 1)
    if kernel == "mttkrp":
        _check_mttkrp(got, want, t.dims, mode, ranks[0], torch.float32)
    else:
        _check_ttmc(got, want, t.dims, mode, ranks, torch.float32, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,ranks", [("mttkrp", (35,) * 4),
                                          ("mttkrp", (150,) * 4),
                                          ("ttmc", (2, 5, 7, 3)),
                                          ("ttmc", (8, 8, 8, 8))])
@pytest.mark.parametrize("sort_mode,mode", [(0, 1), (0, 3), (2, 0), (3, 2)])
def test_off_sort_kernels_order_four_on_card(cuda, kernel, ranks, sort_mode,
                                             mode):
    """Order 4 runs the kernels compiled for a run-time number of modes."""
    t = random_sparse((20, 15, 12, 10), 2000, 51, skew=1.0, device=cuda)
    if kernel == "mttkrp":
        f = init_factors(t.dims, ranks[0], 52, device=cuda)
    else:
        f = _ttmc_factors(t.dims, ranks, 52, cuda)
    lin = build_linearized(t, block=128, row_tile=64, sort_mode=sort_mode)
    got, made, want = _off_sort_call(kernel, lin, f, mode)
    assert made == (0, 1)
    torch.testing.assert_close(got, want, rtol=5e-4, atol=5e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["mttkrp", "ttmc"])
@pytest.mark.parametrize("sort_mode,mode", OFF_SORT_MODES)
def test_off_sort_kernels_repeat_within_reassociation_on_card(
        cuda, kernel, sort_mode, mode):
    """The atomics land in another order each call, on hot rows that many
    warps share: two calls agree within float reassociation (1e-5
    relative)."""
    t = _segment_tensor("skew", cuda)
    if kernel == "mttkrp":
        f = init_factors(t.dims, 35, 53, device=cuda)
        call = linearized_cuda.mttkrp_off_sort
    else:
        f = _ttmc_factors(t.dims, (16, 16, 16), 53, cuda)
        call = linearized_cuda.ttmc_off_sort
    lin = build_linearized(t, sort_mode=sort_mode)
    first = call(lin, f, mode)
    second = call(lin, f, mode)
    torch.cuda.synchronize()
    torch.testing.assert_close(first, second, rtol=1e-5, atol=0.0)


# ---------------------------------------------------------------------------
# the ingested path on the card: ingest, HALS on the cached workspaces,
# checkpoints of card tensors, streaming from a .tnsb
# ---------------------------------------------------------------------------

def _ingest_source(tmp_path):
    """A skewed tensor written as a .tnsb, and the tensor (on the CPU)."""
    t = random_sparse((300, 200, 400), 20_000, 60, skew=1.5, device="cpu")
    path = tmp_path / "x.tnsb"
    write_tnsb(path, t)
    return path, t


def _rel_diff(a, b) -> float:
    return float(torch.linalg.norm(a - b) / torch.linalg.norm(b))


@pytest.mark.cuda
def test_ingest_onto_card_cold_and_warm(cuda, tmp_path, monkeypatch):
    """A cold ingest of a .tnsb builds every workspace on the card; a warm
    one loads them all from the cache, builds nothing, and holds the same
    bits as the cold handle and as a CPU load of the same entry."""
    path, _ = _ingest_source(tmp_path)
    opts = dict(reorder="degree_sort", cache=tmp_path / "c")
    cold = ingest(path, device=cuda, **opts)
    assert not cold.cache_hit and cold.tensor.device.type == "cuda"
    calls = []
    for mod, name in ((csf_mod, "build_csf"), (lin_mod, "build_linearized")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, **k:
                            calls.append(a) or _r(*a, **k))
    warm = ingest(path, device=cuda, **opts)
    on_cpu = ingest(path, device="cpu", **opts)
    assert warm.cache_hit and on_cpu.cache_hit and calls == []
    held = [lambda h: h.tensor.inds, lambda h: h.tensor.vals,
            lambda h: h.relabeling.old_of_new[1],
            lambda h: h.relabeling.entry_perm, lambda h: h._lin.hi,
            lambda h: h._lin.lo] + [
        (lambda h, m=m: h._csf[m].other_ids) for m in range(3)]
    for get in held:
        assert get(warm).device.type == "cuda"
        assert torch.equal(get(warm), get(cold))
        assert torch.equal(get(warm).cpu(), get(on_cpu))
    assert warm.stats == cold.stats


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["cuda", "linearized_cuda"])
def test_hals_kernels_on_ingested_handle_match_segment(cuda, tmp_path, impl):
    """cp_nn_hals on a warm handle's cached workspaces: K1 on every mode, or
    K3 on the sort mode and the off-sort kernel on the others, held to
    ``segment`` from the same state at the CP limits."""
    path, _ = _ingest_source(tmp_path)
    ingest(path, reorder="degree_sort", cache=tmp_path / "c", device=cuda)
    ing = ingest(path, reorder="degree_sort", cache=tmp_path / "c",
                 device=cuda)
    assert ing.cache_hit
    init = init_factors(ing.dims, 35, 61, device=cuda)
    zero = torch.tensor(0.0, device=cuda)
    state = make_state(init, {}, zero, zero, 0)
    counted = (mttkrp_cuda.mttkrp, linearized_cuda.mttkrp,
               linearized_cuda.mttkrp_off_sort)
    before = [fn.launches for fn in counted]
    got = fit(ing, 35, method="cp_nn_hals", impl=impl, niters=5,
              state=state)
    torch.cuda.synchronize()
    made = tuple(fn.launches - b for fn, b in zip(counted, before))
    assert made == ((15, 0, 0) if impl == "cuda" else (0, 5, 10))
    want = fit(ing, 35, method="cp_nn_hals", impl="segment", niters=5,
               state=state)
    assert abs(float(got.fit) - float(want.fit)) <= 1e-5
    assert _rel_diff(got.lmbda, want.lmbda) <= 3e-2
    for a, b, d in zip(got.factors, want.factors, ing.original_dims):
        assert a.shape[0] == d and float(a.min()) >= 0.0
        assert _rel_diff(a, b) <= 3e-2


@pytest.mark.cuda
def test_checkpoint_manager_round_trip_of_card_tensors(cuda, tmp_path):
    """A card state goes to the host before the save thread starts, comes
    back onto the card, and a K1 fit resumed from it stays within the CP
    limits of the uninterrupted one (the kernel's atomics reorder sums)."""
    t = random_sparse((300, 200, 400), 20_000, 62, skew=1.5, device=cuda)
    states = []
    full = fit(t, 16, impl="cuda", niters=6, generator=63,
               checkpoint_cb=states.append)
    mid = states[2]
    mgr = CheckpointManager(tmp_path, async_save=True)
    mgr.save(int(mid.iteration), mid)
    restored, extra = mgr.restore(mid)
    assert extra["step"] == 3
    for a, b in zip(restored.factors + (restored.aux["lmbda"],),
                    mid.factors + (mid.aux["lmbda"],)):
        assert a.device.type == "cuda" and torch.equal(a, b)
    resumed = fit(t, 16, impl="cuda", niters=6, state=restored)
    assert abs(float(resumed.fit) - float(full.fit)) <= 1e-5
    for a, b in zip(resumed.factors, full.factors):
        assert _rel_diff(a, b) <= 3e-2


@pytest.mark.cuda
def test_streaming_from_tnsb_on_card_matches_batch(cuda, tmp_path):
    """cp_als_streaming from a .tnsb, one chunk on the card at a time,
    against batch cp_als from the same state: fits within 1e-3."""
    path, t = _ingest_source(tmp_path)
    init = init_factors(t.dims, 8, 64, device=cuda)
    zero = torch.tensor(0.0, device=cuda)
    state = make_state(init, {"lmbda": torch.ones(8, device=cuda)}, zero,
                       zero, 0)
    streamed = fit(path, 8, method="cp_als_streaming", niters=5,
                   chunk_nnz=4096, state=state, device=cuda)
    batch = fit(ingest(path, device=cuda), 8, impl="segment", niters=5,
                state=state)
    assert streamed.factors[0].device.type == "cuda"
    assert abs(float(streamed.fit) - float(batch.fit)) < 1e-3
