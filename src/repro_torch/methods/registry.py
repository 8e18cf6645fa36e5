"""The decomposition-method registry and the shared checkpointable state.

Counterpart of ``repro.methods.registry``.  Each method is a
:class:`MethodSpec` that declares its family, the sparse kernel it plans
against and the execution contexts it supports, so drivers check
capability instead of hardcoding names.  The four methods (``cp_als``,
``cp_nn_hals``, ``tucker_hooi``, ``cp_als_streaming``) are registered; the
distributed capability (``supports_dist``) is not ported, so no method
declares it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True, eq=False)
class DecompState:
    """Checkpointable mid-run state shared by every registered method.

    factors:   per-mode factor matrices.
    aux:       method-specific tensors, ``{"lmbda": ...}`` for the CP family.
    fit/fit_prev: the convergence trajectory (NaN when never computed).
    iteration: int32 scalar; ``fit(..., state=s)`` resumes from here.
    """

    factors: tuple[Tensor, ...]
    aux: dict[str, Tensor]
    fit: Tensor
    fit_prev: Tensor
    iteration: Tensor  # int32 scalar


def make_state(factors, aux, fit, fit_prev, iteration: int) -> DecompState:
    return DecompState(tuple(factors), dict(aux), fit, fit_prev,
                       torch.tensor(iteration, dtype=torch.int32))


@dataclasses.dataclass(frozen=True)
class MethodSpec:
    """One decomposition method and its declared capabilities (the fields
    of ``repro.methods.MethodSpec``)."""

    name: str
    fn: Callable[..., object]
    family: str
    kernel: str = "mttkrp"
    supports_dist: bool = False
    supports_streaming: bool = False
    nonnegative: bool = False
    supports_order_gt3: bool = True
    monotone_fit: bool = True
    state_aux: tuple[str, ...] = ()
    description: str = ""


METHODS: dict[str, MethodSpec] = {}


def register_method(spec: MethodSpec) -> MethodSpec:
    """Add (or replace) a method in the registry."""
    if spec.family not in ("cp", "tucker"):
        raise ValueError(
            f"bad family {spec.family!r} for method {spec.name!r}")
    if spec.kernel not in ("mttkrp", "ttmc"):
        raise ValueError(
            f"bad kernel {spec.kernel!r} for method {spec.name!r}")
    METHODS[spec.name] = spec
    return spec


def get_method(name: str) -> MethodSpec:
    try:
        return METHODS[name]
    except KeyError:
        raise ValueError(
            f"unknown method {name!r}; one of {tuple(METHODS)}") from None


def available_methods(*, family: Optional[str] = None,
                      dist: Optional[bool] = None,
                      streaming: Optional[bool] = None,
                      nonnegative: Optional[bool] = None,
                      order: int = 3) -> tuple[str, ...]:
    """Names of methods whose declared capabilities cover the ask (each
    keyword is a filter; None means don't care)."""
    out = []
    for name, spec in METHODS.items():
        if family is not None and spec.family != family:
            continue
        if dist is not None and spec.supports_dist != dist:
            continue
        if streaming is not None and spec.supports_streaming != streaming:
            continue
        if nonnegative is not None and spec.nonnegative != nonnegative:
            continue
        if order > 3 and not spec.supports_order_gt3:
            continue
        out.append(name)
    return tuple(out)
