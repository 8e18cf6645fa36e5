"""The cell's inputs, made on the device from the run's seed.

The sparse tensor is a frozen copy of the arithmetic of the port's
``core.coo.random_sparse`` (uniform, or power-law skewed on every mode, the
shape of a data set of the paper's Table I), with the duplicates summed on
the device instead of the host.  The initial factors of each fit come from
a stream of their own, so that the reference can draw the same factors
again after the window.  Nothing here imports the program.
"""
from __future__ import annotations

import torch

MASK64 = (1 << 64) - 1

# stream ids: the tensor, the warm-up fit, then fit i at FIT_STREAM + i
TENSOR_STREAM = 0
WARMUP_STREAM = 1
FIT_STREAM = 2


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for ``stream`` of a run, from splitmix64, so that
    nearby seeds and streams give unrelated draws."""
    x = (int(seed) * 0x9E3779B97F4A7C15 + int(stream) * 0xBF58476D1CE4E5B9
         + 0x94D049BB133111EB) & MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & MASK64
    return (x ^ (x >> 31)) >> 1


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        stream_seed(seed, stream))


def dtype_of(cfg: dict) -> torch.dtype:
    return getattr(torch, cfg["dtype"])


def sparse_tensor(cfg: dict, seed: int, device):
    """``(inds, vals)`` of the configuration's tensor: ``cfg["nnz"]`` draws
    at ``cfg["dims"]`` with ``cfg["skew"]``, duplicates summed, in
    row-major coordinate order.  ``inds`` is (nnz, order) int32."""
    dims = tuple(int(d) for d in cfg["dims"])
    nnz = int(cfg["nnz"])
    skew = float(cfg["skew"])
    g = generator(seed, TENSOR_STREAM, device)
    cols = []
    for d in dims:
        u = torch.rand(nnz, generator=g, device=device) * (1.0 - 1e-6) + 1e-6
        # inverse CDF of a truncated power law: more mass at low indices
        x = u ** (1.0 + skew) if skew > 0.0 else u
        cols.append(torch.clamp((x * d).to(torch.int32), max=d - 1))
        del u, x
    vals = (torch.rand(nnz, generator=g, device=device) * 0.9 + 0.1).to(
        dtype_of(cfg))
    inds = torch.stack(cols, dim=1)
    del cols
    return dedupe(inds, vals, dims)


def dedupe(inds: torch.Tensor, vals: torch.Tensor, dims):
    """Sum the values of repeated coordinates.  The sums are taken in
    float64, where a few float32 values add exactly, so the result does not
    depend on the order of the device's atomic adds."""
    key = inds[:, 0].long()
    for m in range(1, len(dims)):
        key = key * int(dims[m]) + inds[:, m].long()
    uniq, inv = torch.unique(key, sorted=True, return_inverse=True)
    del key
    summed = torch.zeros(uniq.numel(), dtype=torch.float64,
                         device=vals.device)
    summed.index_add_(0, inv, vals.double())
    del inv
    out = torch.empty((uniq.numel(), len(dims)), dtype=torch.int32,
                      device=inds.device)
    rem = uniq
    for m in reversed(range(len(dims))):
        out[:, m] = rem % int(dims[m])
        rem = rem // int(dims[m])
    return out, summed.to(vals.dtype)


def ranks_of(mix: dict, order: int) -> tuple[int, ...]:
    """The mix's rank as one rank a mode."""
    r = mix["rank"]
    return tuple(int(x) for x in r) if isinstance(r, list) else (int(r),) * order


def _uniform(g, dims, ranks, dtype, device):
    return tuple(torch.rand((d, r), generator=g, dtype=dtype, device=device)
                 for d, r in zip(dims, ranks))


def _orthonormal(g, dims, ranks, dtype, device):
    return tuple(
        torch.linalg.qr(torch.randn((d, r), generator=g, dtype=dtype,
                                    device=device))[0].contiguous()
        for d, r in zip(dims, ranks))


INITS = {"uniform": _uniform, "orthonormal": _orthonormal}


def initial_factors(cfg: dict, mix: dict, seed: int, stream: int, device):
    """One (dim, rank) factor a mode for the fit drawn from ``stream``, in
    the configuration's dtype: uniform [0, 1) or the Q of a QR of standard
    normals, as the mix's ``init`` says."""
    dims = tuple(int(d) for d in cfg["dims"])
    g = generator(seed, stream, device)
    return INITS[mix["init"]](g, dims, ranks_of(mix, len(dims)),
                              dtype_of(cfg), device)


def fingerprint(factors) -> torch.Tensor:
    """A cheap device-side digest of a fit's initial factors: the sum and
    the sum of squares of each, in float64."""
    return torch.stack([s for a in factors for s in (
        a.double().sum(), a.double().square().sum())])
