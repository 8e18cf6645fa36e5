"""The benchmark's inputs: the same seed gives the same tensor and initial
factors, duplicates are summed, and the draws follow the port's generator
arithmetic."""
import numpy as np
import pytest
import torch

from cpdbench import generate

CFG = {"dims": [30, 20, 40], "nnz": 4000, "skew": 1.5, "dtype": "float32"}
CP_MIX = {"rank": 5, "init": "uniform"}
TUCKER_MIX = {"rank": [3, 4, 5], "init": "orthonormal"}


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 3 * 2**32 + 5])
def test_tensor_is_a_function_of_the_seed(seed):
    a = generate.sparse_tensor(CFG, seed, "cpu")
    b = generate.sparse_tensor(CFG, seed, "cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    c = generate.sparse_tensor(CFG, seed + 1, "cpu")
    assert c[0].shape != a[0].shape or not torch.equal(a[0], c[0])


def test_duplicates_summed():
    inds, vals = generate.sparse_tensor(CFG, 3, "cpu")
    keys = np.ravel_multi_index(inds.numpy().T, CFG["dims"])
    # unique, ascending coordinates (row-major), a skewed draw collides
    assert np.all(np.diff(keys) > 0)
    assert inds.shape[0] < CFG["nnz"]
    assert inds.dtype == torch.int32 and vals.dtype == torch.float32
    assert float(vals.min()) >= 0.1
    for m, d in enumerate(CFG["dims"]):
        assert 0 <= int(inds[:, m].min()) and int(inds[:, m].max()) < d


def test_dedupe_by_hand():
    inds = torch.tensor([[1, 0, 2], [0, 1, 1], [1, 0, 2], [0, 1, 1],
                         [1, 0, 2]], dtype=torch.int32)
    vals = torch.tensor([0.5, 0.25, 0.125, 1.0, 0.75])
    got_i, got_v = generate.dedupe(inds, vals, (2, 2, 3))
    assert got_i.tolist() == [[0, 1, 1], [1, 0, 2]]
    assert got_v.tolist() == [1.25, 1.375]


def test_same_arithmetic_as_the_port():
    # the port's random_sparse draws the same columns from the same
    # generator; its host dedupe returns the same entries in the same order
    from repro_torch.core.coo import random_sparse

    seed = 12345
    g = generate.generator(seed, generate.TENSOR_STREAM, "cpu")
    t = random_sparse(CFG["dims"], CFG["nnz"], g, skew=CFG["skew"],
                      device="cpu")
    inds, vals = generate.sparse_tensor(CFG, seed, "cpu")
    assert torch.equal(t.inds[:t.nnz], inds)
    assert torch.allclose(t.vals[:t.nnz], vals, rtol=1e-6, atol=0)


@pytest.mark.parametrize("mix", [CP_MIX, TUCKER_MIX],
                         ids=["uniform", "orthonormal"])
def test_initial_factors(mix):
    a = generate.initial_factors(CFG, mix, 9, generate.FIT_STREAM + 3, "cpu")
    b = generate.initial_factors(CFG, mix, 9, generate.FIT_STREAM + 3, "cpu")
    c = generate.initial_factors(CFG, mix, 9, generate.FIT_STREAM + 4, "cpu")
    ranks = generate.ranks_of(mix, 3)
    for x, y, z, d, r in zip(a, b, c, CFG["dims"], ranks):
        assert x.shape == (d, r) and x.is_contiguous()
        assert torch.equal(x, y) and not torch.equal(x, z)
    assert torch.equal(generate.fingerprint(a), generate.fingerprint(b))
    if mix["init"] == "orthonormal":
        for x in a:
            eye = torch.eye(x.shape[1])
            assert torch.allclose(x.T @ x, eye, atol=1e-5)


def test_stream_seeds_spread():
    seen = {generate.stream_seed(s, k) for s in range(50) for k in range(50)}
    assert len(seen) == 2500
    assert all(0 <= x < 2**63 for x in seen)
