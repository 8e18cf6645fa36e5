"""Adafactor (factored second moments), for the trillion-parameter configs
(counterpart of ``repro.optim.adafactor``).

A leaf with ndim >= 2 keeps a row statistic (shape[:-1]) and a column
statistic (shape[:-2] + last dim) instead of its full second moment; there
is no first moment (beta1 = 0).  The update's RMS clip runs over the whole
leaf, so a stacked leaf is clipped over all its layers at once, as in the
reference.
"""
from __future__ import annotations

import torch

from repro_torch.models.params import tree_map, tree_walk

from .base import OPTIMIZERS, Optimizer, clip_by_global_norm, step_f32


def _factored(p) -> bool:
    # purely ndim-based so it agrees with state_axes (which only sees the
    # axes tuple); size-1 dims factor fine (mean over 1 element)
    return p.ndim >= 2


def adafactor(lr: float = 1e-3, decay: float = 0.8, eps: float = 1e-30,
              clip_norm: float = 1.0) -> Optimizer:
    def init(params):
        def per(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if _factored(p):
                return {"vr": torch.zeros(p.shape[:-1], **f32),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
            return {"v": torch.zeros(p.shape, **f32)}
        return {"stats": tree_map(per, params)}

    @torch.no_grad()
    def update(grads, state, params, step):
        grads, _ = clip_by_global_norm(grads, clip_norm)
        leaves = list(tree_walk(params, grads, state["stats"]))
        stepf = step_f32(step, leaves[0][0].device)
        beta2 = 1.0 - stepf ** (-decay)
        for p, g, st in leaves:
            gf = g.float()
            g2 = gf * gf + eps
            if "vr" in st:
                vr = beta2 * st["vr"] + (1 - beta2) * g2.mean(dim=-1)
                vc = beta2 * st["vc"] + (1 - beta2) * g2.mean(dim=-2)
                del g2
                denom = (vr[..., None] * vc[..., None, :]
                         / torch.clamp(vr.mean(dim=-1, keepdim=True)[..., None],
                                       min=eps))
                u = gf * torch.rsqrt(denom.add_(eps))
                del denom
                st["vr"].copy_(vr)
                st["vc"].copy_(vc)
            else:
                v = beta2 * st["v"] + (1 - beta2) * g2
                u = gf * torch.rsqrt(v + eps)
                st["v"].copy_(v)
            # update clipping (Adafactor's d = 1.0 RMS rule)
            rms = torch.sqrt(torch.mean(u * u) + eps)
            u.div_(torch.clamp(rms, min=1.0))
            p.copy_(p.float() - lr * u)
        return state

    def state_axes(param_axes):
        def per(axes):
            if len(axes) >= 2:
                return {"vr": axes[:-1], "vc": axes[:-2] + axes[-1:]}
            return {"v": axes}
        return {"stats": tree_map(per, param_axes)}

    return Optimizer(init=init, update=update, state_axes=state_axes)


OPTIMIZERS["adafactor"] = adafactor
