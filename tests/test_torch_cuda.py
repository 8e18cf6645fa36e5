"""The hand-written CUDA kernels and their wrappers.

The tests marked ``cuda`` hold each kernel to its plain version on the card
and skip where there is none (the kernels have no CPU mode).  The others
check, without a card, what the wrappers and the build promise.  This file
imports no JAX, so the card tests run on a machine without it:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import math

import pytest
import torch

from repro_torch.core import (SparseTensor, build_csf, build_linearized,
                              dedupe, init_factors, random_sparse)
from repro_torch.core.coo import make_generator
from repro_torch.core.linearized import field_offsets
from repro_torch.kernels import (_build, linearized_cuda, mttkrp_cuda, ops,
                                 ref, syrk_cuda)


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
                           (333, 150), (1000, 200))]
                         + [(75_000, 35, torch.float32),
                            (300, 40, torch.bfloat16)])
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
def test_mttkrp_kernel_unchanged_by_the_ttmc_tile(cuda, rank, block,
                                                  row_tile):
    """K1's MTTKRP after tile.cuh took the column policies and the width
    split: yelp's geometry, and ranks whose row_tile x rank tile passes a
    CTA's shared memory, so the launch splits the width."""
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
