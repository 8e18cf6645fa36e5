"""The decomposition planner: per-mode (layout, impl, tile sizes) selection.

Counterpart of ``repro.plan.planner``, on predicted costs:

* ``"auto"``: for each mode, every registered, capability-compatible impl
  (``repro_torch.core.mttkrp.available_impls``) is scored with its declared
  cost model against the measured stats, and the argmin wins.
* any registered impl name pins every mode to that impl.

The backend defaults to the tensor's device type (``"cuda"`` or ``"cpu"``),
so the ``cuda`` kernel is an ``auto`` candidate only for a tensor on the
card.  Measured costs (``calibrate=``, ``autotune=``) are not ported yet and
are refused.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.coo import SparseTensor
from repro_torch.core.csf import DEFAULT_BLOCK, DEFAULT_ROW_TILE
from repro_torch.core.mttkrp import available_impls, get_impl

from .stats import ModeStats, mode_stats, tensor_stats


@dataclasses.dataclass(frozen=True)
class ModePlan:
    """The planner's decision for one mode (``stats`` is None when a fixed
    policy skipped the measurement)."""

    mode: int
    impl: str
    layout: str            # "csf" (unified workspace) or "coo"
    block: int
    row_tile: int
    stats: Optional[ModeStats]
    costs: dict[str, float]  # candidate impl -> predicted cost
    reason: str


@dataclasses.dataclass(frozen=True)
class DecompPlan:
    """Per-mode execution plan for one decomposition."""

    modes: tuple[ModePlan, ...]
    policy: str
    backend: str
    rank: int

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


def _layout_for(impl: str) -> str:
    # "any"-layout impls (gather_scatter) run straight off COO when they are
    # the only consumer of a mode, skipping that mode's sort
    layout = get_impl(impl).layout
    return "csf" if layout == "csf" else "coo"


def _refuse_measured(calibrate: bool, autotune) -> None:
    if calibrate or autotune is not None:
        raise NotImplementedError(
            "measured planning (calibrate=/autotune=) is not ported to "
            "repro_torch yet; plan on predicted costs (calibrate=False, "
            "autotune=None)")


def plan_mode(t: SparseTensor, mode: int, *, rank: int, backend: str,
              block: int, row_tile: int, calibrate: bool = False,
              autotune=None) -> ModePlan:
    """Score every capability-compatible impl for one mode, pick the
    argmin of the predicted costs."""
    _refuse_measured(calibrate, autotune)
    stats = mode_stats(t, mode, block=block, row_tile=row_tile)
    names = tuple(sorted(available_impls(order=t.order, backend=backend)))
    if not names:
        raise ValueError(f"no registered mttkrp impl covers order={t.order} "
                         f"on backend={backend!r}")
    costs = {}
    for name in names:
        spec = get_impl(name)
        costs[name] = (spec.cost_model(stats, int(rank))
                       if spec.cost_model is not None else float("inf"))
    winner = min(costs, key=costs.get)
    runner_up = sorted(costs.values())[1] if len(costs) > 1 else float("inf")
    reason = (
        f"{stats.regime} regime (collision={stats.collision_rate:.2f}, "
        f"padding={stats.padding_overhead:.2f}); predicted cost "
        f"{costs[winner]:.3g} vs next {runner_up:.3g}")
    return ModePlan(mode=mode, impl=winner, layout=_layout_for(winner),
                    block=block, row_tile=row_tile, stats=stats, costs=costs,
                    reason=reason)


def plan_decomposition(
    t: SparseTensor,
    policy: str = "auto",
    *,
    rank: int = 16,
    backend: Optional[str] = None,
    block: int = DEFAULT_BLOCK,
    row_tile: int = DEFAULT_ROW_TILE,
    calibrate: bool = False,
    with_stats: bool = True,
    autotune=None,
) -> DecompPlan:
    """Emit a :class:`DecompPlan` for ``t`` under ``policy``.

    ``policy="auto"`` selects per mode by capability and predicted cost; any
    registered impl name pins every mode.  ``backend`` defaults to the
    tensor's device type.  ``with_stats=False`` skips the stats pass for a
    fixed policy (auto always measures).
    """
    _refuse_measured(calibrate, autotune)
    if backend is None:
        backend = t.device.type
    if policy == "auto":
        modes = tuple(
            plan_mode(t, m, rank=rank, backend=backend, block=block,
                      row_tile=row_tile)
            for m in range(t.order))
        return DecompPlan(modes=modes, policy=policy, backend=backend,
                          rank=rank)

    spec = get_impl(policy)  # raises with the registry listing if unknown
    if t.order > 3 and not spec.supports_order_gt3:
        raise ValueError(
            f"impl {policy!r} does not support order-{t.order} tensors "
            "(capability supports_order_gt3=False)")
    if with_stats:
        stats_per_mode = tensor_stats(t, block=block, row_tile=row_tile)
    else:
        stats_per_mode = [None] * t.order
    modes = []
    for m, s in enumerate(stats_per_mode):
        if s is not None:
            cost = (spec.cost_model(s, int(rank))
                    if spec.cost_model is not None else float("inf"))
            costs = {policy: cost}
            reason = f"fixed policy {policy!r}"
        else:
            costs = {}
            reason = f"fixed policy {policy!r} (stats skipped)"
        modes.append(ModePlan(
            mode=m, impl=policy, layout=_layout_for(policy), block=block,
            row_tile=row_tile, stats=s, costs=costs, reason=reason))
    return DecompPlan(modes=tuple(modes), policy=policy, backend=backend,
                      rank=rank)
