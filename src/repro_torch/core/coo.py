"""COO sparse tensor container and synthetic generators.

Counterpart of ``repro.core.coo``.  The in-memory format is the same: an
``(nnz, order)`` int32 index matrix and a value vector, optionally padded
with zero-valued entries that index 0.  Tensors live on a device chosen by
the caller; ``device=None`` means the CUDA card, and raises when there is
none, so a CPU run is always asked for by name.

Random draws come from an explicit :class:`torch.Generator` (or an int seed)
on the target device.  They are not the JAX package's ``jax.random``
streams: tests that compare the two packages build their inputs with numpy
and hand the same arrays to both.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]
GeneratorLike = Union[int, torch.Generator]


def resolve_device(device: DeviceLike) -> torch.device:
    """``None`` means the CUDA card; raise when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        return torch.device("cuda")
    return torch.device(device)


def make_generator(gen: GeneratorLike, device: torch.device) -> torch.Generator:
    """An int seeds a fresh generator on ``device``; a generator passes
    through (it must live on ``device``'s type)."""
    if isinstance(gen, torch.Generator):
        if gen.device.type != device.type:
            raise ValueError(
                f"generator is on {gen.device.type}, draws are on "
                f"{device.type}")
        return gen
    return torch.Generator(device=device).manual_seed(int(gen))


@dataclasses.dataclass(frozen=True, init=False, eq=False)
class SparseTensor:
    """Order-N sparse tensor in coordinate format.

    inds: (nnz, order) int32 indices, one column per mode.
    vals: (nnz,) float values.  Padding entries have val == 0.
    dims: tuple of mode lengths.
    nnz:  logical (unpadded) non-zero count.
    """

    inds: torch.Tensor
    vals: torch.Tensor
    dims: tuple[int, ...]
    nnz: int

    def __init__(self, inds, vals, dims: Sequence[int], nnz: int, *,
                 device: DeviceLike = None):
        dev = resolve_device(device)
        object.__setattr__(
            self, "inds", torch.as_tensor(inds, device=dev).to(torch.int32))
        object.__setattr__(self, "vals", torch.as_tensor(vals, device=dev))
        object.__setattr__(self, "dims", tuple(int(d) for d in dims))
        object.__setattr__(self, "nnz", int(nnz))

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def order(self) -> int:
        return len(self.dims)

    @property
    def padded_nnz(self) -> int:
        return int(self.vals.shape[0])

    @property
    def density(self) -> float:
        return float(self.nnz) / float(np.prod([float(d) for d in self.dims]))

    def norm(self) -> torch.Tensor:
        """Frobenius norm of the tensor (padding vals are zero)."""
        return torch.sqrt(torch.sum(self.vals.double() ** 2)).to(
            self.vals.dtype)

    def to_dense(self) -> torch.Tensor:
        """Densify (tests only: small tensors)."""
        out = torch.zeros(self.dims, dtype=self.vals.dtype, device=self.device)
        idx = tuple(self.inds[:, m].long() for m in range(self.order))
        return out.index_put_(idx, self.vals, accumulate=True)

    def pad_to(self, multiple: int) -> "SparseTensor":
        """Pad nnz up to a multiple; padding rows index 0 with value 0."""
        n = self.padded_nnz
        target = ((n + multiple - 1) // multiple) * multiple
        if target == n:
            return self
        pad = target - n
        inds = torch.cat([self.inds, self.inds.new_zeros((pad, self.order))])
        vals = torch.cat([self.vals, self.vals.new_zeros((pad,))])
        return SparseTensor(inds, vals, self.dims, self.nnz,
                            device=self.device)


# ---------------------------------------------------------------------------
# Synthetic generators
# ---------------------------------------------------------------------------

def random_sparse(
    dims: Sequence[int],
    nnz: int,
    gen: GeneratorLike,
    *,
    dtype: torch.dtype = torch.float32,
    skew: float = 0.0,
    device: DeviceLike = None,
) -> SparseTensor:
    """Uniform (skew=0) or power-law-skewed random sparse tensor.

    ``skew`` > 0 concentrates non-zeros on low indices per mode, the
    collision-heavy regime of the paper's YELP data set; skew == 0 is the
    collision-light NELL-2-like regime.  Same recipe as the JAX package,
    drawn on ``device`` from ``gen``.
    """
    dev = resolve_device(device)
    g = make_generator(gen, dev)
    dims = tuple(int(d) for d in dims)
    cols = []
    for d in dims:
        u = torch.rand(nnz, generator=g, device=dev) * (1.0 - 1e-6) + 1e-6
        # inverse-CDF of a truncated power law: heavier mass at low idx
        x = u ** (1.0 + skew) if skew > 0.0 else u
        cols.append(torch.clamp((x * d).to(torch.int32), max=d - 1))
    inds = torch.stack(cols, dim=1)
    vals = (torch.rand(nnz, generator=g, device=dev) * 0.9 + 0.1).to(dtype)
    return dedupe(SparseTensor(inds, vals, dims, nnz, device=dev))


def dedupe(t: SparseTensor) -> SparseTensor:
    """Collapse duplicate coordinates (summing values): the fit formula
    (sum vals^2 == ||X||_F^2) assumes unique coordinates.  Host-side numpy,
    build-time only; the result lives on ``t``'s device."""
    inds = t.inds[: t.nnz].cpu().numpy()
    vals = t.vals[: t.nnz].cpu().numpy()
    lin = np.ravel_multi_index(tuple(inds[:, m] for m in range(t.order)),
                               t.dims)
    uniq, inv = np.unique(lin, return_inverse=True)
    if uniq.shape[0] == inds.shape[0]:
        return t
    summed = np.zeros(uniq.shape[0], dtype=vals.dtype)
    np.add.at(summed, inv.reshape(-1), vals)
    new_inds = np.stack(np.unravel_index(uniq, t.dims), axis=1).astype(
        np.int32)
    return SparseTensor(new_inds, summed, t.dims, int(uniq.shape[0]),
                        device=t.device)


def from_factors(
    factors: Sequence[torch.Tensor],
    nnz: int,
    gen: GeneratorLike,
    *,
    noise: float = 0.0,
) -> SparseTensor:
    """Sample ``nnz`` entries of a known low-rank CP tensor (ground truth
    for convergence tests): val = sum_r prod_m A_m[i_m, r] (+ gaussian
    noise).  Draws on the factors' device."""
    dev = factors[0].device
    g = make_generator(gen, dev)
    dims = tuple(int(a.shape[0]) for a in factors)
    inds = torch.stack(
        [torch.randint(0, d, (nnz,), generator=g, device=dev,
                       dtype=torch.int32) for d in dims], dim=1)
    prod = torch.ones((nnz, factors[0].shape[1]), dtype=factors[0].dtype,
                      device=dev)
    for m, a in enumerate(factors):
        prod = prod * a[inds[:, m]]
    vals = torch.sum(prod, dim=1)
    if noise > 0.0:
        vals = vals + noise * torch.randn(nnz, generator=g, device=dev,
                                          dtype=vals.dtype)
    return dedupe(SparseTensor(inds, vals, dims, nnz, device=dev))


# Paper Table I shapes (dims, nnz, skew), as in the JAX package: the
# generator reproduces shape and density, not the actual review data.
PAPER_DATASETS: dict[str, tuple[tuple[int, ...], int, float]] = {
    "yelp": ((41_000, 11_000, 75_000), 8_000_000, 1.5),
    "rate-beer": ((27_000, 105_000, 262_000), 62_000_000, 1.0),
    "beer-advocate": ((31_000, 61_000, 182_000), 63_000_000, 1.0),
    "nell-2": ((12_000, 9_000, 29_000), 77_000_000, 0.0),
    "netflix": ((480_000, 18_000, 2_000), 100_000_000, 0.5),
}


def paper_dataset(name: str, gen: GeneratorLike, *, scale: float = 1.0,
                  device: DeviceLike = None) -> SparseTensor:
    """Synthetic tensor with the published shape/density of a paper data set.

    ``scale`` < 1 shrinks nnz (and dims proportionally to keep density);
    scale == 1.0 is the full published shape.
    """
    dims, nnz, skew = PAPER_DATASETS[name]
    if scale != 1.0:
        dims = tuple(max(8, int(d * scale ** (1 / 3))) for d in dims)
        nnz = max(64, int(nnz * scale))
    return random_sparse(dims, nnz, gen, skew=skew, device=device)


# ---------------------------------------------------------------------------
# FROSTT .tns IO: thin wrappers over the streaming reader and writer in
# repro_torch.ingest.reader, imported lazily to keep the coo -> ingest
# dependency one-way at import time.
# ---------------------------------------------------------------------------

_warned_legacy_io = False


def _warn_legacy_io() -> None:
    global _warned_legacy_io
    if not _warned_legacy_io:
        import warnings

        warnings.warn(
            "repro_torch.core.read_tns/write_tns are legacy re-exports; new "
            "code should use repro_torch.ingest (reader / ingest())",
            DeprecationWarning, stacklevel=3)
        _warned_legacy_io = True


def read_tns(path: str, *, dtype=np.float32, dims=None,
             duplicates: str = "sum",
             device: DeviceLike = None) -> SparseTensor:
    """Read FROSTT text (1-indexed ``i j k val`` lines) onto ``device``.
    See :func:`repro_torch.ingest.reader.read_tns`: pass ``dims=`` to keep
    trailing empty slices.

    .. deprecated:: use ``repro_torch.ingest``; warns once per process."""
    from repro_torch.ingest import reader

    _warn_legacy_io()
    return reader.read_tns(path, dtype=dtype, dims=dims,
                           duplicates=duplicates, device=device)


def write_tns(path: str, t: SparseTensor) -> None:
    """Write FROSTT text with round-trip-exact formatting
    (:func:`repro_torch.ingest.reader.write_tns`).

    .. deprecated:: use ``repro_torch.ingest``; warns once per process."""
    from repro_torch.ingest import reader

    _warn_legacy_io()
    reader.write_tns(path, t)


__all__ = ["SparseTensor", "random_sparse", "dedupe", "from_factors",
           "PAPER_DATASETS", "paper_dataset", "resolve_device",
           "make_generator", "read_tns", "write_tns"]
