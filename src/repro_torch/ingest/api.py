"""``ingest()``: the one path from bytes on disk to planner-ready workspaces.

    ing = ingest("data.tnsb", reorder="degree_sort", cache=".cache/ingest")
    plan = ing.plan("auto", rank=35)
    dec = fit(ing, 35, plan=plan)     # factors in the ORIGINAL labels

Counterpart of ``repro.ingest.api``.  :func:`ingest` takes a FROSTT
``.tns`` path, a binary ``.tnsb`` path or an in-memory
:class:`~repro_torch.core.coo.SparseTensor` and returns an
:class:`Ingested` handle, which every driver accepts in place of a tensor.
The handle owns:

* the (possibly relabeled) tensor and its invertible
  :class:`~repro_torch.ingest.relabel.Relabeling`;
* per-mode :class:`~repro_torch.plan.stats.ModeStats`, measured once at
  ingest and reused by the planner;
* the per-mode CSF workspaces and the linearized workspace, built lazily,
  or loaded from / stored to an
  :class:`~repro_torch.ingest.cache.IngestCache`, so that a warm run skips
  the sort and the stats.

Workspace builds go through the ``core.csf`` and ``core.linearized``
*module* attributes, so a caller can count them (a warm hit makes none).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence, Union

import torch

from repro_torch.core import csf as csf_mod
from repro_torch.core import linearized as lin_mod
from repro_torch.core.coo import DeviceLike, SparseTensor, resolve_device
from repro_torch.core.csf import DEFAULT_BLOCK, DEFAULT_ROW_TILE
from repro_torch.obs import trace as obs_trace
from repro_torch.plan.stats import ModeStats, tensor_stats

from . import reader
from .cache import IngestCache, content_key
from .relabel import (REORDERINGS, Relabeling, compact as compact_fn,
                      make_reorder)


@dataclasses.dataclass
class Ingested:
    """Planner-ready handle over an ingested tensor.

    ``tensor`` lives in the relabeled index space; ``relabeling`` (when not
    None) maps back to the original labels: ``restore_factors`` /
    ``restore`` do that for factors and decompositions, and the drivers
    call them.
    """

    tensor: SparseTensor
    relabeling: Optional[Relabeling]
    stats: tuple[ModeStats, ...]
    stats_before: Optional[tuple[ModeStats, ...]]
    block: int
    row_tile: int
    source: str
    key: Optional[str] = None
    cache: Optional[IngestCache] = None
    cache_hit: bool = False
    _csf: dict = dataclasses.field(default_factory=dict)
    _lin: Optional[object] = None

    # -- basics ------------------------------------------------------------
    @property
    def order(self) -> int:
        return self.tensor.order

    @property
    def dims(self) -> tuple[int, ...]:
        """Dims of the relabeled (working) tensor."""
        return self.tensor.dims

    @property
    def original_dims(self) -> tuple[int, ...]:
        """Dims in the original label space."""
        if self.relabeling is not None:
            return self.relabeling.dims_old
        return self.tensor.dims

    # -- planning ----------------------------------------------------------
    def plan(self, policy: str = "auto", *, rank=16,
             backend: Optional[str] = None,
             allow: Optional[Sequence[str]] = None,
             calibrate: bool = False, kernel: str = "mttkrp",
             factor_ranks: Optional[Sequence[int]] = None,
             autotune=None, recalibrate: bool = False):
        """Plan the decomposition with the stats measured at ingest.

        ``kernel``: "mttkrp" (the CP methods) or "ttmc" (Tucker), with
        ``factor_ranks`` the Tucker ranks a TTMc calibration needs.
        ``calibrate=True`` with a cache attached looks in the cache's
        autotune store first (keyed by this handle's content key), so a
        warm plan makes no timing run; ``recalibrate=True`` times anew.
        ``autotune`` overrides the store."""
        from repro_torch.plan import plan_decomposition

        if autotune is None and self.cache is not None:
            autotune = self.cache.autotune
        return plan_decomposition(
            self.tensor, policy, rank=rank, backend=backend,
            block=self.block, row_tile=self.row_tile, allow=allow,
            calibrate=calibrate, stats=self.stats, kernel=kernel,
            factor_ranks=factor_ranks, autotune=autotune,
            tensor_key=self.key, recalibrate=recalibrate)

    # -- workspaces --------------------------------------------------------
    def csf_for(self, mode: int):
        """The mode's CSF workspace: cached, else built once and kept."""
        if mode not in self._csf:
            with obs_trace.span("sort.build", mode=mode, layout="csf"):
                self._csf[mode] = csf_mod.build_csf(
                    self.tensor, mode, block=self.block,
                    row_tile=self.row_tile)
        return self._csf[mode]

    def lin(self):
        """The tensor's one linearized workspace, shared by every mode:
        cached, else built once and kept."""
        if self._lin is None:
            with obs_trace.span("sort.build", layout="lin"):
                self._lin = lin_mod.build_linearized(
                    self.tensor, block=self.block, row_tile=self.row_tile)
        return self._lin

    def workspace(self, plan) -> list:
        """Per-mode workspaces for ``plan`` (a CSF, the shared linearized
        workspace, or the COO tensor per the planned layout): the
        cache-aware counterpart of ``core.cpals.build_workspace``."""
        out = []
        for p in plan.modes:
            if p.layout in ("csf", "lin"):
                if (p.block, p.row_tile) != (self.block, self.row_tile):
                    raise ValueError(
                        f"plan wants (block={p.block}, row_tile={p.row_tile})"
                        f" but this tensor was ingested with tile="
                        f"({self.block}, {self.row_tile})")
            if p.layout == "csf":
                out.append(self.csf_for(p.mode))
            elif p.layout == "lin":
                out.append(self.lin())
            else:
                out.append(self.tensor)
        return out

    # -- label restoration -------------------------------------------------
    def restore_factors(self, factors) -> tuple[torch.Tensor, ...]:
        if self.relabeling is None:
            return tuple(factors)
        return self.relabeling.restore_factors(factors)

    def restore(self, decomp):
        """Map a decomposition computed in the relabeled space back to the
        original labels (lambda, the core and the fit do not depend on
        them)."""
        if self.relabeling is None:
            return decomp
        return dataclasses.replace(
            decomp, factors=self.restore_factors(decomp.factors))

    # -- reporting ---------------------------------------------------------
    def reorder_deltas(self) -> Optional[list[dict]]:
        """Per-mode (after - before) deltas of the reorder-sensitive stats;
        None when no reordering was applied."""
        if self.stats_before is None:
            return None
        return [{
            "collision": a.block_collision_rate - b.block_collision_rate,
            "padding": a.padding_overhead - b.padding_overhead,
            "skew": a.skew - b.skew,
        } for b, a in zip(self.stats_before, self.stats)]


def ingest(
    x: Union[SparseTensor, str, os.PathLike],
    *,
    reorder: str = "identity",
    compact: bool = False,
    cache: Union[IngestCache, str, os.PathLike, None] = None,
    tile: tuple[int, int] = (DEFAULT_BLOCK, DEFAULT_ROW_TILE),
    dims: Optional[Sequence[int]] = None,
    duplicates: str = "sum",
    seed: int = 0,
    device: DeviceLike = None,
) -> Ingested:
    """Bytes on disk (or an in-memory tensor) -> planner-ready workspaces.

    ``reorder``: one of ``REORDERINGS`` (``identity`` / ``degree_sort`` /
    ``random_block``, the last seeded by ``seed``).  ``compact``: drop
    empty slices first (composes with ``reorder``).  ``cache``: an
    :class:`IngestCache` or its root; a warm hit skips parse, relabel,
    stats and the workspace builds.  ``tile``: the ``(block, row_tile)``
    geometry.  ``dims``/``duplicates``: the reader's options.
    ``device``: where the tensor and workspaces live; None means the
    tensor's own device for an in-memory tensor and the card for a path.
    """
    if reorder not in REORDERINGS:
        raise ValueError(
            f"unknown reorder {reorder!r}; one of {tuple(REORDERINGS)}")
    block, row_tile = int(tile[0]), int(tile[1])
    if isinstance(cache, (str, os.PathLike)):
        cache = IngestCache(cache)
    in_memory = isinstance(x, SparseTensor)
    if in_memory and device is None:
        dev = x.device
    else:
        dev = resolve_device(device)

    source = "memory" if in_memory else str(x)
    key = None
    if cache is not None:
        key = content_key(x, block=block, row_tile=row_tile,
                          reorder=reorder, compact=compact,
                          dims=dims, duplicates=duplicates,
                          extra=f"seed={seed}" if reorder == "random_block"
                          else "")
        with obs_trace.span("ingest.cache.load", warm=True):
            hit = cache.load(key, device=dev)
        if hit is not None:
            t, relabeling, csfs, lin, stats, stats_before = hit
            return Ingested(
                tensor=t, relabeling=relabeling, stats=tuple(stats),
                stats_before=(None if stats_before is None
                              else tuple(stats_before)),
                block=block, row_tile=row_tile, source=source, key=key,
                cache=cache, cache_hit=True, _csf=csfs, _lin=lin)

    # -- cold path ---------------------------------------------------------
    if in_memory:
        t = x if x.device == dev else SparseTensor(
            x.inds[: x.nnz], x.vals[: x.nnz], x.dims, x.nnz, device=dev)
    else:
        with obs_trace.span("ingest.parse", source=source):
            t = reader.read_any(x, dims=dims, duplicates=duplicates,
                                device=dev)

    relabeling: Optional[Relabeling] = None
    stats_before = None
    if compact or reorder != "identity":
        with obs_trace.span("ingest.relabel", reorder=reorder,
                            compact=compact):
            stats_before = tuple(tensor_stats(t, block=block,
                                              row_tile=row_tile))
            rel = None
            if compact:
                rel = compact_fn(t)
                t = rel.apply(t)
            if reorder != "identity":
                r2 = make_reorder(t, reorder, block=block, seed=seed)
                t = r2.apply(t)
                rel = r2 if rel is None else rel.then(r2)
            relabeling = rel

    with obs_trace.span("ingest.stats"):
        stats = tuple(tensor_stats(t, block=block, row_tile=row_tile))

    csfs: dict[int, object] = {}
    lin = None
    if cache is not None:
        # ALLMODE build: every mode is kept, so any later plan is a pure
        # cache read; the linearized workspace rides along unless the dims
        # exceed its 64-bit packed-index budget
        with obs_trace.span("ingest.build", modes=t.order):
            for m in range(t.order):
                csfs[m] = csf_mod.build_csf(t, m, block=block,
                                            row_tile=row_tile)
            try:
                lin = lin_mod.build_linearized(t, block=block,
                                               row_tile=row_tile)
            except ValueError:
                lin = None
        with obs_trace.span("ingest.cache.store"):
            cache.store(key, t, relabeling, list(csfs.values()), list(stats),
                        None if stats_before is None else list(stats_before),
                        lin=lin)

    return Ingested(tensor=t, relabeling=relabeling, stats=stats,
                    stats_before=stats_before, block=block, row_tile=row_tile,
                    source=source, key=key, cache=cache, cache_hit=False,
                    _csf=csfs, _lin=lin)
