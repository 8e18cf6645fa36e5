"""Step builders: train_step / prefill_step / serve_step for an LM config,
and the CP-ALS iteration step for decomposition workloads.

Counterpart of ``repro.launch.steps``.  The parameters live in the
:class:`~repro_torch.models.Model` (the PyTorch idiom), so the LM steps
take no ``params`` argument: the train step takes its gradients with
``torch.autograd`` and its optimizer writes the parameters in place; the
prefill and serve steps run without autograd and update the cache in place.
Gradient compression (``grad_compress``) is ``repro_torch.dist.compress``:
int8 quantisation with error-feedback residuals.
"""
from __future__ import annotations

import torch

from repro_torch.dist.compress import (compress_grads_int8,
                                       decompress_grads_int8)
from repro_torch.models import Model
from repro_torch.models.params import tree_map, tree_walk
from repro_torch.optim import Optimizer


def _split_micro(batch: dict, m: int) -> dict:
    """Reshape every batch leaf to a leading micro-batch axis of length m."""
    out = {}
    for k, v in batch.items():
        if k == "positions":  # (3, B, S) -> (m, 3, B/m, S)
            b = v.shape[1]
            out[k] = v.reshape(v.shape[0], m, b // m,
                               *v.shape[2:]).movedim(1, 0)
        else:                 # (B, ...) -> (m, B/m, ...)
            out[k] = v.reshape(m, v.shape[0] // m, *v.shape[1:])
    return out


def _take_grad(p: torch.Tensor) -> torch.Tensor:
    """``p``'s gradient, detached from ``p`` (zeros where the loss does not
    reach ``p``, as JAX gives)."""
    g, p.grad = p.grad, None
    return torch.zeros_like(p) if g is None else g


def make_train_step(model: Model, optimizer: Optimizer, *,
                    grad_compress: bool = False, micro_batches: int = 1):
    """``(opt_state, batch, step) -> (opt_state, metrics)``; the parameters
    are the model's, updated in place, and the metrics (the loss, the MoE
    blocks', ``step`` + 1) are detached tensors.

    ``micro_batches`` > 1 splits the batch and accumulates ``g / m`` in a
    float32 tree (the reference's order of rounding), at about 1/m of the
    activation memory; the metrics are averaged over the micro-batches.
    ``grad_compress`` runs the int8 quantise -> dequantise loop with
    error feedback, the residual kept in ``opt_state["ef"]``."""
    params = model.params()

    def grads_of(batch):
        loss, metrics = model.loss(batch)
        loss.backward()
        return ({k: v.detach() for k, v in metrics.items()},
                tree_map(_take_grad, params))

    def train_step(opt_state, batch, step):
        model.zero_grad(set_to_none=True)
        if micro_batches > 1:
            micro = _split_micro(batch, micro_batches)
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            per = []
            for i in range(micro_batches):
                metrics, g = grads_of({k: v[i] for k, v in micro.items()})
                for acc, gi in tree_walk(grads, g):
                    acc.add_(gi.float() / micro_batches)
                del g
                per.append(metrics)
            metrics = {k: torch.stack([m[k] for m in per]).mean()
                       for k in per[0]}
        else:
            metrics, grads = grads_of(batch)
        if grad_compress:
            q, scales, ef = compress_grads_int8(grads, opt_state.get("ef"))
            del grads  # the float32 tree goes before its dequantised copy
            grads = decompress_grads_int8(q, scales)
            del q
        new_opt = optimizer.update(
            grads, {k: v for k, v in opt_state.items() if k != "ef"},
            params, step)
        if grad_compress:
            new_opt = dict(new_opt, ef=ef)
        return new_opt, dict(metrics, step=step + 1)

    return train_step


def make_cpals_step(plan):
    """One CP-ALS iteration executing a :class:`repro_torch.plan.DecompPlan`.

    Returns ``(ws, factors, grams, norm_x_sq, norm_kind) -> (factors, grams,
    lmbda, fit)`` where ``ws`` is ``repro_torch.core.build_workspace(t,
    plan)``, so the per-mode impl selection is decided once at plan time,
    not per step."""
    from repro_torch.core.cpals import _iteration

    impls = plan.impls

    def cpals_step(ws, factors, grams, norm_x_sq, *, norm_kind="2"):
        return _iteration(ws, tuple(factors), tuple(grams), norm_x_sq,
                          impls=impls, norm_kind=norm_kind)

    return cpals_step


def make_prefill_step(model: Model):
    """(batch, cache) -> (logits (B,1,V), cache, metrics): the reference's
    prefill step, with the forward's metrics (the MoE blocks') beside it."""
    def prefill_step(batch, cache):
        with torch.no_grad():
            return model(batch, mode="prefill", cache=cache)
    return prefill_step


def make_serve_step(model: Model):
    """One decode step: (tokens (B,1), cache, pos) -> (logits, cache)."""
    def serve_step(tokens, cache, pos, positions=None):
        return model.decode_step(tokens, cache, pos, positions=positions)
    return serve_step
