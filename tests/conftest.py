"""Shared test helpers."""
import jax
import jax.numpy as jnp

from repro.core import SparseTensor


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one "
        "(run on the card with `-m cuda`)")


def exact_lowrank_tensor(dims, true_rank, key):
    """Fully-observed nonneg low-rank tensor in COO form (every cell a
    'non-zero').

    CP-ALS treats absent coordinates as structural zeros, so only a fully
    observed low-rank tensor is itself low-rank — a sparse *sample* of one
    is not (that would be tensor completion, a different SPLATT mode).  The
    ground-truth factors are positive, so the nonnegative methods can reach
    it too, and its multilinear rank is <= true_rank per mode for Tucker.
    """
    ks = jax.random.split(key, len(dims))
    true = [jax.random.uniform(k, (d, true_rank)) + 0.1
            for k, d in zip(ks, dims)]
    grids = jnp.meshgrid(*[jnp.arange(d) for d in dims], indexing="ij")
    inds = jnp.stack([g.reshape(-1) for g in grids], axis=1).astype(jnp.int32)
    prod = jnp.ones((inds.shape[0], true_rank))
    for m, a in enumerate(true):
        prod = prod * a[inds[:, m]]
    vals = jnp.sum(prod, axis=1)
    return SparseTensor(inds=inds, vals=vals, dims=tuple(dims),
                        nnz=inds.shape[0])
