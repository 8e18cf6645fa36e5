"""AdamW with float32 moments and decoupled weight decay (counterpart of
``repro.optim.adamw``)."""
from __future__ import annotations

import torch

from repro_torch.models.params import tree_map, tree_walk

from .base import (OPTIMIZERS, Optimizer, clip_by_global_norm, step_f32,
                   zeros_f32)


def adamw(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.0,
          clip_norm: float = 1.0) -> Optimizer:
    def init(params):
        return {"m": tree_map(zeros_f32, params),
                "v": tree_map(zeros_f32, params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        grads, _ = clip_by_global_norm(grads, clip_norm)
        leaves = list(tree_walk(params, grads, state["m"], state["v"]))
        stepf = step_f32(step, leaves[0][0].device)
        bc1 = 1.0 - b1 ** stepf
        bc2 = 1.0 - b2 ** stepf
        for p, g, m, v in leaves:
            gf = g.float()
            m.mul_(b1).add_((1.0 - b1) * gf)
            v.mul_(b2).add_((1.0 - b2) * gf * gf)
            u = (m / bc1).div_((v / bc2).sqrt_().add_(eps))
            if weight_decay:
                u.add_(weight_decay * p.float())
            p.copy_(p.float() - lr * u)
        return state

    def state_axes(param_axes):
        return {"m": param_axes, "v": param_axes}

    return Optimizer(init=init, update=update, state_axes=state_axes)


OPTIMIZERS["adamw"] = adamw
