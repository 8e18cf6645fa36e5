"""The hand-written CUDA kernels and their wrappers.

The tests marked ``cuda`` hold each kernel to its plain version on the card
and skip where there is none (the kernels have no CPU mode).  The others
check, without a card, what the wrappers and the build promise.  This file
imports no JAX, so the card tests run on a machine without it:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.core import build_csf, init_factors, random_sparse
from repro_torch.kernels import _build, mttkrp_cuda, ops, ref, syrk_cuda


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
