"""The port's kernel modules against the JAX package's.

On the CPU, ``repro_torch.kernels.ops`` runs the plain versions; they are
held to the JAX package's Pallas kernels (interpret mode, as its own tests
run them) and to its pure-jnp oracles, over the sweeps of
``tests/test_kernels.py`` with its tolerances.  The kernels themselves
are in ``test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_csf as jax_build_csf
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.core import build_csf, random_sparse, init_factors
from repro_torch.kernels import ops, ref

from test_torch_helpers import both_tensors, np_coo, np_factors

# (dims, nnz, mode, rank, block, row_tile, skew, dtype, against Pallas);
# the Pallas interpreter is slow, so it runs for one case of each kind and
# the jnp oracle for all
MTTKRP_CASES = (
    [((50, 40, 30), 600, m, 8, 128, 64, 0.0, "float32", m == 0)
     for m in range(3)]
    + [((200, 13, 77), 2000, m, 8, 128, 64, 0.0, "float32", False)
       for m in range(3)]
    + [((64, 64, 64), 4000, m, 8, 128, 64, 0.0, "float32", False)
       for m in range(3)]
    + [((500, 11, 9), 900, m, 8, 128, 64, 0.0, "float32", m == 0)
       for m in range(3)]
    + [((40, 30, 20), 800, 0, r, 128, 64, 0.0, "float32", r == 150)
       for r in (3, 8, 35, 64, 128, 150)]
    + [((100, 50, 25), 3000, 0, 16, b, rt, 0.0, "float32", b == 64)
       for b, rt in ((64, 32), (128, 64), (256, 128), (512, 128))]
    + [((30, 20, 10), 4000, m, 8, 128, 64, 2.0, "float32", m == 1)
       for m in range(3)]
    + [((20, 15, 12, 10), 900, 2, 8, 128, 64, 0.0, "float32", True)]
    + [((40, 30, 20), 700, 0, 8, 128, 64, 0.0, "bfloat16", True)]
)


def _tol(skew, dtype):
    if dtype == "bfloat16":
        return 5e-2
    return 5e-4 if skew else 2e-4


@pytest.mark.parametrize(
    "dims,nnz,mode,rank,block,row_tile,skew,dtype,pallas", MTTKRP_CASES)
def test_mttkrp_matches_jax(dims, nnz, mode, rank, block, row_tile, skew,
                            dtype, pallas):
    inds, vals = np_coo(dims, nnz, seed=sum(dims) + rank, skew=skew)
    jt, pt = both_tensors(inds, vals, dims)
    factors = np_factors(dims, rank, seed=rank)
    jf = tuple(jnp.asarray(a).astype(dtype) for a in factors)
    pf = tuple(torch.from_numpy(a).to(getattr(torch, dtype)) for a in factors)

    got = ops.mttkrp(build_csf(pt, mode, block=block, row_tile=row_tile), pf)
    assert got.dtype == pf[0].dtype and got.shape == (dims[mode], rank)
    got = got.float().numpy()
    jcsf = jax_build_csf(jt, mode, block=block, row_tile=row_tile)
    tol = _tol(skew, dtype)
    want = np.asarray(jax_ref.mttkrp_ref(jcsf, jf), dtype=np.float32)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    if pallas:
        kern = np.asarray(jax_ops.mttkrp(jcsf, jf), dtype=np.float32)
        np.testing.assert_allclose(got, kern, rtol=tol, atol=tol)


SYRK_CASES = ([(rows, rank, "float32") for rows, rank in
               ((100, 8), (512, 35), (1000, 64), (4096, 128), (333, 150))]
              + [(300, 40, "bfloat16")])


@pytest.mark.parametrize("rows,rank,dtype", SYRK_CASES)
def test_syrk_matches_jax(rows, rank, dtype):
    a = np.random.default_rng(rows).standard_normal((rows, rank)).astype(
        np.float32)
    if dtype == "bfloat16":
        a *= 0.1
    ja = jnp.asarray(a).astype(dtype)
    pa = torch.from_numpy(a).to(getattr(torch, dtype))
    got = ops.syrk(pa)
    assert got.dtype == pa.dtype and got.shape == (rank, rank)
    got = got.float().numpy()
    tol = 5e-2 if dtype == "bfloat16" else 1e-4
    atol = tol if dtype == "bfloat16" else 1e-3
    for want in (jax_ref.syrk_ref(ja), jax_ops.syrk(ja, blk=256)):
        np.testing.assert_allclose(got, np.asarray(want, dtype=np.float32),
                                   rtol=tol, atol=atol)


def test_plain_versions_accumulate_in_float32():
    t = random_sparse((30, 20, 10), 300, 0, device="cpu")
    f = tuple(a.bfloat16() for a in init_factors(t.dims, 4, 1, device="cpu"))
    csf = build_csf(t, 1, block=64, row_tile=32)
    assert ref.mttkrp_ref(csf, f).dtype == torch.float32
    assert ref.syrk_ref(f[0]).dtype == torch.float32
