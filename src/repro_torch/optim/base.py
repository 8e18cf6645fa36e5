"""Optimizer interface and shared utilities (counterpart of
``repro.optim.base``).

The parameters, gradients and state are nested dicts of tensors, visited in
sorted key order (the order ``jax.tree.flatten`` visits a dict).  An
optimizer's ``update(grads, state, params, step)`` writes the new
parameters and the new state into the tensors it was given, under
``torch.no_grad()``, and returns the state: an ``nn.Parameter`` stays the
same object, and no second copy of the moments is ever held.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.models.params import tree_walk


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """Functional optimizer over a parameter tree: ``state = init(params)``;
    ``state = update(grads, state, params, step)``, the parameters and the
    state updated in place."""

    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, Any], Any]
    # state_axes(param_axes) -> the state's logical axes tree for the same
    # parameter leaves (for sharding the state on a mesh)
    state_axes: Callable[[Any], Any]


def zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def step_f32(step, device) -> torch.Tensor:
    """The reference's ``(step + 1).astype(float32)``, on ``device``."""
    return torch.tensor(float(int(step) + 1), dtype=torch.float32,
                        device=device)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scale every gradient leaf IN PLACE by ``min(1, max_norm / (norm +
    1e-9))``, the norm taken over the whole tree in float32; a leaf is
    scaled in float32 and cast back to its dtype.  Returns ``(grads,
    norm)``; ``max_norm <= 0`` clips nothing (norm 0)."""
    leaves = [g for (g,) in tree_walk(grads)]
    if max_norm <= 0:
        return grads, torch.zeros(())
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                           for g in leaves))
    scale = torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)
    for g in leaves:
        if g.dtype == torch.float32:
            g.mul_(scale)
        else:
            g.copy_(g.float() * scale)
    return grads, gnorm


def cast_like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    return x.to(ref.dtype)


# registry filled by the concrete modules (import order via __init__)
OPTIMIZERS: dict[str, Callable[..., Optimizer]] = {}
