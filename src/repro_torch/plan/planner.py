"""The decomposition planner: per-mode (layout, impl, tile sizes) selection.

Counterpart of ``repro.plan.planner``, for both kernel families: MTTKRP
(the CP family) and TTMc (Tucker, ``kernel="ttmc"``), each scored on its own
registry.

* ``"auto"``: for each mode, every registered, capability-compatible impl
  (``available_impls`` of the family's registry, narrowed by ``allow=``) is
  scored and the argmin wins.  Scores are the declared cost models'
  predictions, or with ``calibrate=True`` the impls' measured kernel times
  on the actual tensor, looked up first in a persistent autotune store
  (``autotune=``, :mod:`repro_torch.plan.autotune`).
* any registered impl name pins every mode to that impl.

``rank`` is the width the cost models score: an int for every mode, or a
per-mode sequence (the Tucker driver passes each mode's Kronecker width
``prod_{m != n} R_m``).

The backend defaults to the tensor's device type (``"cuda"`` or ``"cpu"``),
so the ``cuda`` and ``linearized_cuda`` kernels are ``auto`` candidates
only for a tensor on the card.  The linearized impls never win on
predicted costs (``core/mttkrp.py::_DECODE_DISCOUNT``); they reach
``auto`` through calibration.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Optional, Sequence

import torch

from repro_torch.core.coo import SparseTensor, make_generator
from repro_torch.core.cpals import init_factors
from repro_torch.core.csf import DEFAULT_BLOCK, DEFAULT_ROW_TILE, build_csf
from repro_torch.core.linearized import build_linearized, check_bit_budget
from repro_torch.core.mttkrp import REGISTRY, available_impls, get_impl, mttkrp
from repro_torch.core.ttmc import TTMC_REGISTRY, ttmc

from .autotune import as_store, calibration_key, canonical_candidates
from .stats import ModeStats, mode_stats, stats_digest, tensor_stats


def _kernel_registry(kernel: str) -> dict:
    """Impl table of a kernel family: "mttkrp" (the CP family) or "ttmc"
    (Tucker's chain-of-modes contraction, the same ImplSpec shape)."""
    if kernel == "mttkrp":
        return REGISTRY
    if kernel == "ttmc":
        return TTMC_REGISTRY
    raise ValueError(f"unknown kernel {kernel!r}; one of ('mttkrp', 'ttmc')")


def _rank_for_mode(rank, mode: int) -> int:
    """The width a mode is scored at: an int applies to every mode, a
    sequence gives each mode its own."""
    if isinstance(rank, (int, float)):
        return int(rank)
    return int(rank[mode])


def _fits_lin_budget(t: SparseTensor, names, *,
                     registry: Optional[dict] = None) -> tuple[str, ...]:
    """Drop linearized-layout candidates when the tensor's dims exceed the
    64-bit packed-index budget (``core/linearized.check_bit_budget``);
    CSF/COO candidates remain."""
    def is_lin(n):
        return get_impl(n, registry=registry).layout == "lin"

    if any(is_lin(n) for n in names):
        try:
            check_bit_budget(t.dims)
        except ValueError:
            names = tuple(n for n in names if not is_lin(n))
    return tuple(names)


@dataclasses.dataclass(frozen=True)
class ModePlan:
    """The planner's decision for one mode (``stats`` is None when a fixed
    policy skipped the measurement)."""

    mode: int
    impl: str
    layout: str            # "csf" (unified workspace), "lin" or "coo"
    block: int
    row_tile: int
    stats: Optional[ModeStats]
    costs: dict[str, float]  # candidate impl -> predicted cost or ms
    reason: str
    kernel: str = "mttkrp"   # the kernel family the impl belongs to
    # where the costs came from: "predicted" (declared cost models),
    # "measured-fresh" (timed in this call) or "measured-cached" (loaded
    # from the autotune store)
    source: str = "predicted"


@dataclasses.dataclass(frozen=True)
class DecompPlan:
    """Per-mode execution plan for one decomposition."""

    modes: tuple[ModePlan, ...]
    policy: str
    backend: str
    rank: int | tuple[int, ...]  # the scored width(s)

    @property
    def order(self) -> int:
        return len(self.modes)

    @property
    def impls(self) -> tuple[str, ...]:
        return tuple(p.impl for p in self.modes)

    @property
    def layouts(self) -> tuple[str, ...]:
        return tuple(p.layout for p in self.modes)

    def summary(self) -> str:
        return " ".join(f"m{p.mode}:{p.impl}" for p in self.modes)


def _layout_for(impl: str, *, registry: Optional[dict] = None) -> str:
    # "any"-layout impls (gather_scatter) run straight off COO when they are
    # the only consumer of a mode, skipping that mode's sort
    layout = get_impl(impl, registry=registry).layout
    return layout if layout in ("csf", "lin") else "coo"


def _measure_ms(fn, *args, iters: int = 3, sync: bool = False) -> float:
    """Median host-clock ms of ``iters`` calls after one warm-up call;
    ``sync`` synchronises the card around each call, so the time is the
    device's work and not its enqueue."""
    fn(*args)
    times = []
    for _ in range(iters):
        if sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(*args)
        if sync:
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2] * 1e3


def _calibrate_mode(t: SparseTensor, mode: int, names, *, rank: int,
                    block: int, row_tile: int, kernel: str = "mttkrp",
                    factor_ranks: Optional[Sequence[int]] = None
                    ) -> dict[str, float]:
    """Measured kernel ms of each candidate for one mode on the actual
    tensor: one workspace build shared by the candidates of each layout,
    then a median of 3 per candidate.  ``kernel`` selects what is timed,
    the MTTKRP or the TTMc; the TTMc needs ``factor_ranks`` (the per-mode
    Tucker ranks) for its timing factors, since its scored ``rank`` is the
    Kronecker output width, not a factor's."""
    registry = _kernel_registry(kernel)
    if kernel == "ttmc":
        if factor_ranks is None:
            raise ValueError(
                "calibrate=True for kernel='ttmc' needs factor_ranks= (the "
                "per-mode Tucker ranks) to build timing factors; the Tucker "
                "drivers and repro.api.Session pass them automatically")
        kernel_fn = ttmc
        g = make_generator(0, t.device)
        factors = tuple(
            torch.randn((int(d), int(r)), generator=g, dtype=t.vals.dtype,
                        device=t.device)
            for d, r in zip(t.dims, factor_ranks))
    else:
        kernel_fn = mttkrp
        factors = init_factors(t.dims, rank, 0, dtype=t.vals.dtype,
                               device=t.device)
    sync = t.device.type == "cuda"
    csf = lin = None
    measured = {}
    for name in names:
        layout = get_impl(name, registry=registry).layout
        if layout == "csf":
            if csf is None:
                csf = build_csf(t, mode, block=block, row_tile=row_tile)
            ws = csf
        elif layout == "lin":
            if lin is None:
                lin = build_linearized(t, block=block, row_tile=row_tile)
            ws = lin
        else:
            ws = t
        fn = functools.partial(kernel_fn, mode=mode, impl=name)
        measured[name] = _measure_ms(fn, ws, factors, sync=sync)
    return measured


def _measured_costs(t: SparseTensor, mode: int, names, *, rank: int,
                    block: int, row_tile: int, backend: str, kernel: str,
                    factor_ranks: Optional[Sequence[int]],
                    stats: Optional[ModeStats], autotune, tensor_key,
                    recalibrate: bool) -> tuple[dict[str, float], str]:
    """Calibration with the autotune store in front: ``(costs, source)``,
    ``source`` being ``"measured-cached"`` on a store hit (no timing run)
    or ``"measured-fresh"`` (timed now and, with a store, kept)."""
    key = None
    if autotune is not None and tensor_key is not None:
        key = calibration_key(
            tensor_key, mode=mode, names=names, backend=backend, rank=rank,
            kernel=kernel, block=block, row_tile=row_tile,
            stats_digest=stats_digest(() if stats is None else (stats,)))
        if not recalibrate:
            hit = autotune.load(key)
            if hit is not None and set(hit["costs"]) == set(names):
                return dict(hit["costs"]), "measured-cached"
    costs = _calibrate_mode(t, mode, names, rank=rank, block=block,
                            row_tile=row_tile, kernel=kernel,
                            factor_ranks=factor_ranks)
    if key is not None:
        autotune.store(key, costs, meta={
            "mode": mode, "backend": backend, "rank": int(rank),
            "kernel": kernel, "block": block, "row_tile": row_tile})
    return costs, "measured-fresh"


def plan_mode(t: SparseTensor, mode: int, *, rank, backend: str,
              block: int, row_tile: int,
              allow: Optional[Sequence[str]] = None,
              calibrate: bool = False,
              stats: Optional[ModeStats] = None,
              kernel: str = "mttkrp",
              factor_ranks: Optional[Sequence[int]] = None,
              autotune=None, tensor_key: Optional[str] = None,
              recalibrate: bool = False) -> ModePlan:
    """Score every capability-compatible impl for one mode, pick the argmin.

    ``kernel`` names the family whose registry is scored, ``rank`` the
    width (an int, or one per mode); ``factor_ranks`` the Tucker ranks a
    TTMc calibration builds its timing factors from.
    ``calibrate=True`` scores measured kernel times (ms) on the actual
    tensor instead of the cost models.  ``stats``: precomputed
    :class:`ModeStats` for this (block, row_tile), which skips the stats
    pass.  ``autotune``/``tensor_key``: the store and the tensor's content
    key; on a hit nothing is timed, and ``recalibrate=True`` times anew and
    overwrites the entry."""
    registry = _kernel_registry(kernel)
    mode_rank = _rank_for_mode(rank, mode)
    if stats is None:
        stats = mode_stats(t, mode, block=block, row_tile=row_tile)
    elif (stats.block, stats.row_tile) != (block, row_tile):
        raise ValueError(
            f"precomputed stats were measured for (block={stats.block}, "
            f"row_tile={stats.row_tile}), planner asked (block={block}, "
            f"row_tile={row_tile})")
    names = canonical_candidates(_fits_lin_budget(
        t, available_impls(order=t.order, backend=backend, allow=allow,
                           registry=registry), registry=registry))
    if not names:
        raise ValueError(f"no registered {kernel} impl covers "
                         f"order={t.order} on backend={backend!r} "
                         f"(allow={allow})")
    if calibrate:
        costs, source = _measured_costs(
            t, mode, names, rank=mode_rank, block=block, row_tile=row_tile,
            backend=backend, kernel=kernel, factor_ranks=factor_ranks,
            stats=stats, autotune=autotune, tensor_key=tensor_key,
            recalibrate=recalibrate)
        unit = "ms"
    else:
        costs = {}
        for name in names:
            spec = get_impl(name, registry=registry)
            costs[name] = (spec.cost_model(stats, mode_rank)
                           if spec.cost_model is not None else float("inf"))
        unit, source = "", "predicted"
    winner = min(costs, key=costs.get)
    runner_up = sorted(costs.values())[1] if len(costs) > 1 else float("inf")
    reason = (
        f"{stats.regime} regime (collision={stats.collision_rate:.2f}, "
        f"padding={stats.padding_overhead:.2f}); {source} cost "
        f"{costs[winner]:.3g}{unit} vs next {runner_up:.3g}{unit}")
    return ModePlan(mode=mode, impl=winner,
                    layout=_layout_for(winner, registry=registry),
                    block=block, row_tile=row_tile, stats=stats, costs=costs,
                    reason=reason, kernel=kernel, source=source)


def plan_decomposition(
    t: SparseTensor,
    policy: str = "auto",
    *,
    rank=16,
    backend: Optional[str] = None,
    block: int = DEFAULT_BLOCK,
    row_tile: int = DEFAULT_ROW_TILE,
    allow: Optional[Sequence[str]] = None,
    calibrate: bool = False,
    with_stats: bool = True,
    stats: Optional[Sequence[ModeStats]] = None,
    kernel: str = "mttkrp",
    factor_ranks: Optional[Sequence[int]] = None,
    autotune=None,
    tensor_key: Optional[str] = None,
    recalibrate: bool = False,
) -> DecompPlan:
    """Emit a :class:`DecompPlan` for ``t`` under ``policy``.

    ``policy="auto"`` selects per mode by capability and cost; any
    registered impl name pins every mode.  ``backend`` defaults to the
    tensor's device type; ``allow`` restricts the candidate set (a fixed
    policy outside it is refused).  ``calibrate=True`` spends planning time
    on a short timed kernel call per candidate per mode, on the actual
    tensor, and scores those milliseconds.  ``with_stats=False`` skips the
    stats pass for a fixed policy (auto and calibration always measure);
    ``stats`` hands in precomputed per-mode statistics.  ``kernel``: the
    family whose registry is scored, ``"mttkrp"`` or ``"ttmc"``; ``rank``
    is an int or a per-mode sequence of widths (the Tucker driver passes
    the Kronecker widths), and ``factor_ranks`` the Tucker ranks that a
    TTMc calibration needs.  ``autotune``: an
    :class:`~repro_torch.plan.autotune.AutotuneStore` or its root path,
    consulted before any timing run; ``tensor_key`` is the tensor's content
    key (``repro_torch.ingest.content_key`` when omitted);
    ``recalibrate=True`` skips the lookup, times every candidate again and
    overwrites the stored entries.
    """
    registry = _kernel_registry(kernel)
    if backend is None:
        backend = t.device.type
    if stats is not None and len(stats) != t.order:
        raise ValueError(f"precomputed stats cover {len(stats)} modes, "
                         f"tensor has {t.order}")
    if calibrate and autotune is not None:
        autotune = as_store(autotune)
        if tensor_key is None:
            from repro_torch.ingest.cache import content_key

            tensor_key = content_key(t, block=block, row_tile=row_tile)
    if policy == "auto":
        modes = tuple(
            plan_mode(t, m, rank=rank, backend=backend, block=block,
                      row_tile=row_tile, allow=allow, calibrate=calibrate,
                      stats=None if stats is None else stats[m],
                      kernel=kernel, factor_ranks=factor_ranks,
                      autotune=autotune, tensor_key=tensor_key,
                      recalibrate=recalibrate)
            for m in range(t.order))
        return DecompPlan(modes=modes, policy=policy, backend=backend,
                          rank=rank)

    # raises with the registry listing if unknown
    spec = get_impl(policy, registry=registry)
    if allow is not None and policy not in allow:
        raise ValueError(f"impl {policy!r} is not in the allowed set {allow}")
    if t.order > 3 and not spec.supports_order_gt3:
        raise ValueError(
            f"impl {policy!r} does not support order-{t.order} tensors "
            "(capability supports_order_gt3=False)")
    if stats is not None:
        for s in stats:
            if (s.block, s.row_tile) != (block, row_tile):
                raise ValueError(
                    f"precomputed stats were measured for (block={s.block}, "
                    f"row_tile={s.row_tile}), planner asked (block={block}, "
                    f"row_tile={row_tile})")
        stats_per_mode = list(stats)
    elif with_stats or calibrate:
        stats_per_mode = tensor_stats(t, block=block, row_tile=row_tile)
    else:
        stats_per_mode = [None] * t.order
    modes = []
    for m, s in enumerate(stats_per_mode):
        source = "predicted"
        if calibrate:
            costs, source = _measured_costs(
                t, m, (policy,), rank=_rank_for_mode(rank, m), block=block,
                row_tile=row_tile, backend=backend, kernel=kernel,
                factor_ranks=factor_ranks, stats=s, autotune=autotune,
                tensor_key=tensor_key, recalibrate=recalibrate)
            reason = (f"fixed policy {policy!r}; {source} "
                      f"{costs[policy]:.3g}ms")
        elif s is not None:
            cost = (spec.cost_model(s, _rank_for_mode(rank, m))
                    if spec.cost_model is not None else float("inf"))
            costs = {policy: cost}
            reason = f"fixed policy {policy!r}"
        else:
            costs = {}
            reason = f"fixed policy {policy!r} (stats skipped)"
        modes.append(ModePlan(
            mode=m, impl=policy, layout=_layout_for(policy, registry=registry),
            block=block, row_tile=row_tile, stats=s, costs=costs,
            reason=reason, kernel=kernel, source=source))
    return DecompPlan(modes=tuple(modes), policy=policy, backend=backend,
                      rank=rank)
