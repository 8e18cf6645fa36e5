"""Shared inputs for the parity tests between ``repro`` (JAX) and
``repro_torch`` (PyTorch).

The two packages draw different random numbers from one seed, so every
input is made here with numpy and handed to both sides by value.
"""
import jax.numpy as jnp
import numpy as np

from repro.core import SparseTensor as JaxSparseTensor
from repro.core.cpals import CPALSState as JaxCPALSState
from repro_torch import convert


def np_coo(dims, nnz, seed, *, skew=0.0, unique=True):
    """The JAX package's ``random_sparse`` recipe in numpy: (inds, vals).
    ``unique`` keeps the first of each repeated coordinate."""
    rng = np.random.default_rng(seed)
    cols = []
    for d in dims:
        u = rng.uniform(1e-6, 1.0, nnz)
        x = u ** (1.0 + skew) if skew > 0.0 else u
        cols.append(np.minimum((x * d).astype(np.int32), d - 1))
    inds = np.stack(cols, axis=1).astype(np.int32)
    vals = rng.uniform(0.1, 1.0, nnz).astype(np.float32)
    if unique:
        lin = np.ravel_multi_index(tuple(inds.T), dims)
        _, first = np.unique(lin, return_index=True)
        first.sort()
        inds, vals = inds[first], vals[first]
    return inds, vals


def planted(dims, true_rank, seed):
    """Every cell of a rank-``true_rank`` tensor with positive factors:
    (inds, vals), multilinear rank <= true_rank per mode (the numpy form of
    the reference's fully observed ``exact_lowrank_tensor``)."""
    rng = np.random.default_rng(seed)
    true = [rng.uniform(0.0, 1.0, (d, true_rank)).astype(np.float32) + 0.1
            for d in dims]
    grids = np.meshgrid(*[np.arange(d) for d in dims], indexing="ij")
    inds = np.stack([g.reshape(-1) for g in grids], 1).astype(np.int32)
    prod = np.ones((inds.shape[0], true_rank), np.float32)
    for m, a in enumerate(true):
        prod = prod * a[inds[:, m]]
    return inds, prod.sum(axis=1).astype(np.float32)


def both_tensors(inds, vals, dims):
    """The same COO tensor on both sides (the port's on the CPU)."""
    nnz = int(vals.shape[0])
    jt = JaxSparseTensor(inds=jnp.asarray(inds), vals=jnp.asarray(vals),
                         dims=tuple(dims), nnz=nnz)
    pt = convert.sparse_tensor_from_numpy(inds, vals, dims, nnz, "cpu")
    return jt, pt


def np_factors(dims, rank, seed):
    rng = np.random.default_rng(seed)
    return [rng.uniform(0.0, 1.0, (d, rank)).astype(np.float32)
            for d in dims]


def both_states(factors):
    """Initial factors as an iteration-0 state on both sides."""
    rank = factors[0].shape[1]
    lmbda = np.ones(rank, np.float32)
    zero = np.float32(0.0)
    jstate = JaxCPALSState(tuple(jnp.asarray(a) for a in factors),
                           jnp.asarray(lmbda), jnp.asarray(zero),
                           jnp.asarray(zero), jnp.asarray(0, jnp.int32))
    pstate = convert.cpals_state_from_numpy(factors, lmbda, zero, zero, 0,
                                            "cpu")
    return jstate, pstate


def test_np_coo_unique_and_in_range():
    inds, vals = np_coo((7, 5, 3), 400, 0, skew=2.0)
    lin = np.ravel_multi_index(tuple(inds.T), (7, 5, 3))
    assert np.unique(lin).size == lin.size
    assert (inds >= 0).all() and (inds < np.array([7, 5, 3])).all()
    assert ((vals >= 0.1) & (vals <= 1.0)).all()
